"""Training traffic: a closed loop of the train step's calls on the feed
(``inputs.Feed``), one iteration a call or a window of k.

Set-up builds the program's train state from the benchmark's weights and
drives it through its first calls on the window's own call and feed,
keeping what the check compares: the first gradient (Adam's first moment
after one iteration), the parameters and the generator's EMA after three
iterations and the losses the calls return.  Further calls warm up, then the window measures for
``--seconds``.  After the window the reference replays the compared
iterations from the same weights and inputs.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

from perfbench import flops
from perfbench.lib import checks, common, inputs, program, trace
from perfbench.reference import float32_exact, nets, quant
from perfbench.reference.step import Trainer

N_CHANGE = 3        # the parameters' change is compared after 3 iterations


def _host(leaves) -> Dict[str, object]:
    """Host copies: what the check keeps stays out of the device's memory,
    so the window's peak is the program's own."""
    return {k: v.detach().to("cpu", copy=True) for k, v in leaves.items()}


def _losses(metrics) -> Dict[str, float]:
    return {k: float(metrics[k]) for k in ("d_total", "g_loss")}


class _Program:
    """The program's train state and the window's call, with what the
    check keeps of its first iterations."""

    def __init__(self, torch, cfg, mix, feed, g_init, d_init, device,
                 fault: Optional[str] = None):
        self.torch, self.cfg, self.feed, self.fault = torch, cfg, feed, fault
        self.k = int(mix.get("multi_step", 1))
        self.alpha = float(mix.get("alpha", 1.0))
        self.augment = bool(cfg.get("augment"))
        self.state = program.train_state(torch, cfg, g_init, d_init, device,
                                         float(mix.get("ada_p0", 0.0)))
        if fault == "ema_unchanged":
            # an EMA that is never updated
            cfg = {**cfg, "train": {**cfg["train"], "ema_decay": 1.0}}
        if fault == "g_sign":
            # G's gradient negated where it is produced
            for p in self.state["g"].parameters():
                p.register_hook(torch.neg)
        self.call = program.train_call(cfg, self.k)
        self.beta1 = cfg["train"]["beta1"]
        g_host = _host(g_init)
        self.capture = {"losses": [], "g": {"init": g_host},
                        "d": {"init": _host(d_init)}, "ema": {"init": g_host}}

    def _snap(self, what: str) -> None:
        st = self.state
        if what == "grad":
            self.capture["ada_count"] = float(st["ada"]["count"])
        for net, opt in (("g", "opt_g"), ("d", "opt_d")):
            if what == "grad":
                self.capture[net]["grad"] = _host({
                    n: m / (1.0 - self.beta1)
                    for n, m in st[opt]["mu"].items()})
            else:
                self.capture[net]["after"] = _host(
                    dict(st[net].named_parameters()))
        if what == "after":
            self.capture["ema"]["after"] = _host(
                dict(st["g_ema"].named_parameters()))

    def _rows(self, real, labels, z, eps):
        if self.fault == "half_batch":
            # half of the batch left out, the mean taken over the rest
            h = real.shape[0] // 2
            return real[:h], labels[:h], z[:h], eps[:h]
        return real, labels, z, eps

    def run(self, call_index: int, checking: bool = False):
        """One call of the window: iterations ``call_index * k`` on."""
        torch, feed, k = self.torch, self.feed, self.k
        i0 = call_index * k
        if self.fault == "unchanged":
            # a step that returns its state unchanged
            zero = torch.zeros((), device=feed.reals.device)
            return {"d_total": zero, "g_loss": zero}
        if k == 1:
            real, labels, z, eps, aug = feed.batch_of(i0)
            real, labels, z, eps = self._rows(real, labels, z, eps)
            _, m = self.call(self.state, real, labels, self.alpha, z=z,
                             eps=eps, aug_draws=aug if self.augment else None)
            return m
        reals, labels = [], []
        for j in range(k):
            real, lab = feed.rows(i0 + j)
            if self.fault == "half_batch":
                real, lab = real[:real.shape[0] // 2], lab[:lab.shape[0] // 2]
            reals.append(real)
            labels.append(lab)

        def draws(j, real):
            if checking and j == 1:
                self._snap("grad")
            if checking and j == N_CHANGE:
                self._snap("after")
            z, eps, aug = feed.draws(i0 + j)
            if self.fault == "half_batch":
                z, eps = z[:real.shape[0]], eps[:real.shape[0]]
            return z, eps, aug if self.augment else None
        _, m = self.call(self.state, reals, labels, [self.alpha] * k,
                         draws=draws)
        return m

    def first_calls(self) -> int:
        """The compared iterations, through the window's call; returns the
        number of calls made."""
        if self.k > 1:
            m = self.run(0, checking=True)
            self.capture["losses"].append(_losses(m))
            # a call that never asked for its draws left its state as it is
            if "ada_count" not in self.capture:
                self._snap("grad")
            if "after" not in self.capture["g"]:
                self._snap("after")
            return 1
        for c in range(N_CHANGE):
            m = self.run(c)
            self.capture["losses"].append(_losses(m))
            if c == 0:
                self._snap("grad")
        self._snap("after")
        return N_CHANGE


def _replay(torch, cfg, mix, feed, g_init, d_init, prec) -> dict:
    """The reference (or, with a lower ``prec``, the control) over the
    compared iterations."""
    k = int(mix.get("multi_step", 1))
    every = cfg["train"]["gp_every"]
    beta1 = cfg["train"]["beta1"]
    dev = feed.reals.device
    tr = Trainer({n: v.to(dev) for n, v in g_init.items()},
                 {n: v.to(dev) for n, v in d_init.items()}, cfg, prec=prec,
                 ada_p=float(mix.get("ada_p0", 0.0)))
    g_host = _host(g_init)
    out = {"losses": [], "g": {"init": g_host}, "d": {"init": _host(d_init)},
           "ema": {"init": g_host}}
    sums = None
    with float32_exact():
        for i in range(max(k, N_CHANGE)):
            real, labels, z, eps, aug = feed.batch_of(i)
            m = tr.step(real, labels, z, eps,
                        aug if cfg.get("augment") else None,
                        apply_gp=i % every == 0)
            if k == 1:
                out["losses"].append(_losses(m))
            elif i < k:
                sums = m if sums is None else {n: sums[n] + m[n] for n in m}
            if i == 0:
                out["ada_count"] = m["ada_count"]
                for net, opt in (("g", tr.opt_g), ("d", tr.opt_d)):
                    out[net]["grad"] = _host({n: v / (1.0 - beta1)
                                              for n, v in opt["mu"].items()})
            if i == N_CHANGE - 1:
                out["g"]["after"] = _host(tr.g)
                out["d"]["after"] = _host(tr.d)
                out["ema"]["after"] = _host(tr.ema)
    if k > 1:
        out["losses"].append(_losses(sums))
    return out


def run(torch, cell, args, t_start: float, device="cuda") -> dict:
    """One run of a training cell.  Returns the pieces of the result: the
    compared numbers, the end-to-end numbers, what the per-layer readers
    read, and the device's readings."""
    cfg = program.effective(cell.config, cell.mix)
    mix = cell.mix
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    feed = inputs.Feed(torch, device, args.seed, cfg, mix)
    g_init, d_init = inputs.make_weights(torch, cfg, args.seed, device)
    if args.control:
        # the reference in the control's precision, in the program's place
        prec = nets.Prec(quant.fp8)
        got = _replay(torch, cfg, mix, feed, g_init, d_init, prec)
        want = _replay(torch, cfg, mix, feed, g_init, d_init, nets.Prec())
        return {"numbers": checks.train_numbers(got, want), "e2e": {},
                "peak": 0, "attempted": 0}

    prog = _Program(torch, cfg, mix, feed, g_init, d_init, device,
                    args.fault)
    # the weights wait on the host for the reference
    g_init, d_init = prog.capture["g"]["init"], prog.capture["d"]["init"]
    calls = prog.first_calls()
    for _ in range(int(mix.get("warmup_calls", 2))):
        prog.run(calls)
        calls += 1
    sync()
    setup_s = time.monotonic() - t_start

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        prog.run(calls + n)
        n += 1
    sync()
    window_s = time.perf_counter() - t0
    calls += n
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    images = n * prog.k * feed.batch

    summary = None
    if args.trace:
        t_calls = int(mix.get("trace_calls", 1))

        def segment():
            for c in range(t_calls):
                prog.run(calls + c)
            sync()
        summary = trace.run_traced(torch, segment)
        summary["units"] = t_calls * prog.k      # iterations a segment

    prog_capture, k = prog.capture, prog.k
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    want = _replay(torch, cfg, mix, feed, g_init, d_init, nets.Prec())
    numbers = checks.train_numbers(prog_capture, want)
    e2e = {"setup_s": setup_s, "peak_mem_gib": peak / common.GIB}
    for m in cell.end_to_end:
        # the throughput under the name (and so the bound) the cell reports
        if m["name"].split(".")[0] == "train_img_per_s":
            e2e[m["name"]] = images / window_s
    ctx = {"trace": summary, "window_s": window_s, "images": images,
           "units": n * k, "chips": cell.chips,
           "flops_per_image": flops.train_flops_per_image(cfg)}
    return {"numbers": numbers, "e2e": e2e, "ctx": ctx, "peak": peak,
            "attempted": n * k, "summary": summary}
