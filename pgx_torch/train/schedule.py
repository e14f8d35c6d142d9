"""Progressive-growth schedulers as pure functions of the global iteration.

A copy of ``pgx/train/schedule.py`` (pure Python), kept here so that the
port imports nothing of ``pgx``.

The reference mutates (step, alpha, iteration) inline in its training loops;
here each scheduler is a pure map ``global_iter -> ScheduleState`` so resume
is trivially arithmetic and logging/FID sweeps can re-derive state
(SURVEY.md section 2.3 "Growth schedulers", section 5.4 resume).

Two schemes:

* ``LegacySchedule`` — iteration-split (train.py:100-111,
  mnist_train.py:141-153): stage length ``L+1`` iterations with
  ``L = total_iter // max_step``; ``alpha = min(1, 2*j/L)`` within a stage
  (fade-in occupies the first half); after the last stage, alpha pins to 1.
  NOTE: the reference's own resume arithmetic (mnist_train.py:66-80) divides
  by ``L`` not ``L+1`` and therefore drifts from its loop by one iteration
  per completed stage; ours is exact w.r.t. the loop semantics.

* ``ProperSchedule`` — images-seen (proper_cifar_train.py:162-189):
  ``ips = images_seen_per_mini_step // batch_size``; stage 1 lasts one
  mini-step, every later stage two (fade + stabilize);
  ``alpha = min(1, j / ips)``.

Resolutions: legacy trains at ``4 * 2**step`` (train.py:110), proper at
``4 * 2**(step-1)`` (proper_cifar_train.py:50).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ScheduleState:
    step: int
    alpha: float
    fading: bool          # statically selects the blend graph
    resolution: int
    final: bool           # past the last growth stage (alpha pinned at 1)


class LegacySchedule:
    def __init__(self, total_iter: int, max_step: int, init_step: int = 1):
        assert max_step >= 1 and init_step >= 1
        if total_iter < max_step:
            raise ValueError(
                f"total_iter={total_iter} must be >= max_step={max_step}: "
                f"the reference's split gives each stage total_iter//"
                f"max_step iterations, which must be at least 1")
        self.total_iter = total_iter
        self.max_step = max_step
        self.init_step = init_step
        self.stage_len = total_iter // max_step       # L
        self.span = self.stage_len + 1                # actual loop period

    def state_at(self, i: int) -> ScheduleState:
        step = self.init_step + i // self.span
        j = i % self.span
        if step > self.max_step:
            return ScheduleState(self.max_step, 1.0, False,
                                 4 * 2 ** self.max_step, True)
        alpha = min(1.0, 2.0 * j / self.stage_len)
        return ScheduleState(step, alpha, alpha < 1.0, 4 * 2 ** step, False)

    def total_iterations(self, tail: int = 0) -> int:
        """Iterations to traverse all stages from init_step, plus a tail at
        the final resolution (mnist_train.py:88-90 uses tail=100000)."""
        remaining = self.max_step - self.init_step + 1
        return remaining * self.span + tail


class ProperSchedule:
    """Images-seen scheduler, optionally with per-stage batch sizes.

    ``stage_batches`` maps step -> batch size for that growth stage (Karras
    et al. trained with large minibatches at low resolutions, shrinking as
    the resolution grows; the reference uses one fixed batch).  Because the
    schedule is images-seen, a bigger batch at a stage means *fewer
    iterations* over the same data budget — pure wall-clock win where the
    chip is dispatch-bound.  Unlisted stages use ``batch_size``.  The
    training math per iteration is unchanged (the reference's loop is
    batch-size-agnostic); only the data budget's division into iterations
    moves, exactly as if the reference had been launched with that batch.
    """

    def __init__(self, images_seen_per_mini_step: int, batch_size: int,
                 max_step: int, init_step: int = 1,
                 stage_batches: dict = None):
        assert max_step >= 1 and init_step >= 1
        self.images = images_seen_per_mini_step
        self.batch_size = batch_size
        self.stage_batches = (
            {int(k): int(v) for k, v in stage_batches.items()}
            if stage_batches else None)
        self.ips = images_seen_per_mini_step // batch_size
        assert self.ips >= 1, (
            f"images_seen_per_mini_step={images_seen_per_mini_step} must be "
            f">= batch_size={batch_size}")
        self.max_step = max_step
        self.init_step = init_step
        # per-stage iteration spans (stage 1 = one mini-step, later stages
        # two: fade + stabilize, proper_cifar_train.py:165-180) and their
        # cumulative start offsets
        self._stage_ips = {}
        self._starts = {}
        start = 0
        for s in range(init_step, max_step + 1):
            b = (self.stage_batches or {}).get(s, batch_size)
            ips_s = images_seen_per_mini_step // b
            assert ips_s >= 1, (
                f"stage {s}: images_seen_per_mini_step="
                f"{images_seen_per_mini_step} must be >= its batch size {b}")
            self._stage_ips[s] = ips_s
            self._starts[s] = start
            start += ips_s if s == 1 else 2 * ips_s
        self._end = start

    def batch_for_step(self, step: int):
        """The data batch size at ``step``, or None when this schedule does
        not prescribe batches (plain fixed-batch operation: the loop's own
        batch_size applies)."""
        if not self.stage_batches:
            return None
        s = min(max(step, self.init_step), self.max_step)
        return self.stage_batches.get(s, self.batch_size)

    def state_at(self, i: int) -> ScheduleState:
        if i >= self._end:
            return ScheduleState(self.max_step, 1.0, False,
                                 4 * 2 ** (self.max_step - 1), True)
        step = self.max_step
        for s in range(self.init_step, self.max_step + 1):
            span = self._stage_ips[s] * (1 if s == 1 else 2)
            if i < self._starts[s] + span:
                step = s
                break
        j = i - self._starts[step]
        alpha = min(1.0, j / self._stage_ips[step])
        # step 1 has no fade target (4x4 is the first head).
        fading = alpha < 1.0 and step > 1
        return ScheduleState(step, alpha, fading, 4 * 2 ** (step - 1), False)

    def total_iterations(self, tail: int = 0) -> int:
        return self._end + tail


def schedule_to_dict(schedule) -> dict:
    """JSON-serializable schedule description (stored in the trial config so
    FID sweeps / resume can re-derive (step, alpha) per iteration)."""
    if isinstance(schedule, LegacySchedule):
        return {"kind": "legacy", "total_iter": schedule.total_iter,
                "max_step": schedule.max_step,
                "init_step": schedule.init_step}
    if isinstance(schedule, ProperSchedule):
        if schedule.stage_batches:
            return {"kind": "proper",
                    "images_seen_per_mini_step": schedule.images,
                    "batch_size": schedule.batch_size,
                    "stage_batches": {str(k): v for k, v
                                      in schedule.stage_batches.items()},
                    "max_step": schedule.max_step,
                    "init_step": schedule.init_step}
        return {"kind": "proper",
                "images_seen_per_mini_step": schedule.ips,
                "batch_size": 1,  # ips already divided
                "max_step": schedule.max_step,
                "init_step": schedule.init_step}
    raise TypeError(type(schedule))


def schedule_from_dict(d: dict):
    if d["kind"] == "legacy":
        return LegacySchedule(d["total_iter"], d["max_step"], d["init_step"])
    if d["kind"] == "proper":
        return ProperSchedule(d["images_seen_per_mini_step"],
                              d.get("batch_size", 1), d["max_step"],
                              d["init_step"],
                              stage_batches=d.get("stage_batches"))
    raise ValueError(d["kind"])
