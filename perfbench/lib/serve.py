"""Serving traffic: a closed loop of client threads on
``GeneratorService.submit``.

Each client sends its next request when the last one resolves (from the
future's callback, so the clients add no threads to the process).  Request
``i`` of a run is fixed by the seed: its size (blocks of the mix's sizes in
their stated counts, shuffled per block, so every seed sends the same
sizes in another order), its labels and its z (rows of a pool of N(0, 1)
latents).  Every request is timed on the client's clock from ``submit`` to
its future resolving.  The images of a sample of the requests, drawn from
the seed and holding the largest, are kept and set against the reference
generator's after the window.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from perfbench import flops
from perfbench.lib import checks, common, inputs, program, trace
from perfbench.reference import float32_exact, nets, quant

WINDOW, WARMUP = 0, 1          # the request streams of a run


class Schedule:
    """The requests of one stream of a run, by index."""

    def __init__(self, seed: int, stream: int, mix: dict, cfg: dict):
        self.seed, self.stream = seed, stream
        block = [int(s) for s, count in mix["sizes"].items()
                 for _ in range(int(count))]
        self.block = np.asarray(block)
        self.classes = cfg["generator"]["num_classes"]
        rng = np.random.default_rng(common.sub_seed(seed, inputs.POOL))
        self.z = rng.standard_normal((int(mix["z_pool"]),
                                      cfg["generator"]["z_dim"]),
                                     dtype=np.float32)

    def size(self, i: int) -> int:
        nb = len(self.block)
        rng = np.random.default_rng(
            common.sub_seed(self.seed, 5, self.stream, i // nb))
        return int(self.block[rng.permutation(nb)[i % nb]])

    def request(self, i: int):
        """(z, labels) of request ``i``."""
        n = self.size(i)
        rng = np.random.default_rng(
            common.sub_seed(self.seed, 6, self.stream, i))
        at = int(rng.integers(0, self.z.shape[0] - n + 1))
        labels = rng.integers(0, self.classes, n).astype(np.int32)
        return self.z[at:at + n], labels

    def sample(self, count: int, first: int) -> List[int]:
        """``count`` of the first ``first`` requests, drawn from the seed,
        the first request of the largest size among them."""
        rng = np.random.default_rng(common.sub_seed(self.seed, 7))
        pick = set(int(i) for i in rng.choice(first, count - 1,
                                              replace=False))
        largest = int(self.block.max())
        pick.add(next(i for i in range(first) if self.size(i) == largest))
        return sorted(pick)


class _Loop:
    """Closed-loop clients on the service for one stream: each client
    keeps one request outstanding and sends its next from the callback of
    the last one's future, so the load takes no thread of its own."""

    def __init__(self, svc, schedule: Schedule, clients: int,
                 keep=frozenset()):
        self.svc, self.schedule, self.clients = svc, schedule, clients
        self.keep = keep
        self.lock = threading.Lock()
        self.next = 0
        self.active = 0
        self.idle = threading.Event()
        self.records: List[tuple] = []      # (i, n, t_submit, t_done)
        self.failed: List[int] = []
        self.kept: Dict[int, np.ndarray] = {}

    def _send(self, deadline: float) -> None:
        """The client's next request, or its end once the deadline has
        passed."""
        with self.lock:
            if time.perf_counter() >= deadline:
                self.active -= 1
                if not self.active:
                    self.idle.set()
                return
            i = self.next
            self.next += 1
        z, labels = self.schedule.request(i)
        t0 = time.perf_counter()
        try:
            fut = self.svc.submit(z, labels)
        except RuntimeError:          # refused (service closed): counted,
            self.failed.append(i)     # and this client ends
            with self.lock:
                self.active -= 1
                if not self.active:
                    self.idle.set()
            return
        fut.add_done_callback(
            lambda f: self._done(f, i, z.shape[0], t0, deadline))

    def _done(self, fut, i: int, n: int, t0: float, deadline: float):
        t1 = time.perf_counter()
        if fut.exception() is not None:
            self.failed.append(i)
        else:
            self.records.append((i, n, t0, t1))
            if i in self.keep:
                self.kept[i] = fut.result()
        self._send(deadline)

    def run(self, seconds: float) -> float:
        """Run the clients until ``seconds`` have passed and every request
        sent has resolved; returns the window's start."""
        t0 = time.perf_counter()
        self.active = self.clients
        self.idle.clear()
        for _ in range(self.clients):
            self._send(t0 + seconds)
        if not self.idle.wait(seconds + 120):
            raise RuntimeError("requests still outstanding 120 s after "
                               "the window")
        return t0


def _reference_images(torch, cfg, g_init, schedule, indices, prec,
                      device) -> Dict[int, object]:
    gcfg = cfg["generator"]
    out = {}
    with torch.no_grad(), float32_exact():
        for i in indices:
            z, labels = schedule.request(i)
            img = nets.generator(g_init, gcfg,
                                 torch.from_numpy(z).to(device),
                                 torch.from_numpy(labels).to(device),
                                 cfg["step"], prec)
            x = (torch.clamp(img, -1.0, 1.0) + 1.0) * 0.5
            out[i] = torch.floor(x * 255.0 + 0.5).to(torch.uint8).cpu()
    return out


def _alter_first_image(svc) -> None:
    """The fault of an answer altered where it is produced: the first
    image of every batch the service generates is inverted."""
    gen = svc._gen

    def altered(*a, **kw):
        out = gen(*a, **kw).clone()
        out[0] = 255 - out[0]
        return out
    svc._gen = altered


def run(torch, cell, args, t_start: float, device="cuda") -> dict:
    """One run of the serving cell (as ``train.run``)."""
    cfg = program.effective(cell.config, cell.mix)
    mix = cell.mix
    cuda = torch.device(device).type == "cuda"
    g_init = inputs.make_params(torch, nets.g_param_shapes(cfg["generator"]),
                                args.seed, 0, device)
    schedule = Schedule(args.seed, WINDOW, mix, cfg)
    sample = schedule.sample(int(mix["sample"]), int(mix["sample_from"]))
    if args.control:
        got = _reference_images(torch, cfg, g_init, schedule, sample,
                                nets.Prec(quant.fp8), device)
        want = _reference_images(torch, cfg, g_init, schedule, sample,
                                 nets.Prec(), device)
        return {"numbers": checks.image_numbers(torch, got, want, sample),
                "e2e": {}, "peak": 0, "attempted": 0}

    svc = program.service(torch, cfg, g_init, mix, device)
    try:
        if args.fault == "alter_image":
            _alter_first_image(svc)
        svc.warmup("all")
        clients = int(mix["clients"])
        _Loop(svc, Schedule(args.seed, WARMUP, mix, cfg), clients).run(
            float(mix.get("warmup_s", 1.0)))
        setup_s = time.monotonic() - t_start

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = svc.stats()
        loop = _Loop(svc, schedule, clients, frozenset(sample))
        t0 = loop.run(args.seconds)
        after = svc.stats()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        end = t0 + args.seconds
        done = [r for r in loop.records if r[3] <= end]
        lat = sorted((r[3] - r[2]) * 1e3 for r in done)
        images = sum(r[1] for r in done)
        summary = None
        if args.trace:
            traced = []

            def segment():
                seg = _Loop(svc, Schedule(args.seed, WARMUP, mix, cfg),
                            clients)
                seg.run(float(mix.get("trace_s", 2.0)))
                if cuda:
                    torch.cuda.synchronize()
                traced.append(sum(r[1] for r in seg.records))
            summary = trace.run_traced(torch, segment)
            # the device time per image: the timing segment's busy time
            # over the images it served
            summary["units"] = traced[0]
    finally:
        svc.close()
    del svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    due = [i for i in sample if i < loop.next]
    want = _reference_images(torch, cfg, g_init, schedule, due,
                             nets.Prec(), device)
    numbers = checks.image_numbers(torch, loop.kept, want, due)
    batches = after["batches"] - before["batches"]
    fill = ((after["batched_images"] - before["batched_images"]) / batches
            / int(mix["max_batch"]) if batches else None)
    e2e = {"setup_s": setup_s, "serve_img_per_s": images / args.seconds,
           "serve_p95_ms": float(np.percentile(lat, 95)) if lat else None,
           "peak_mem_gib": peak / common.GIB}
    ctx = {"trace": summary, "window_s": float(args.seconds),
           "images": images, "chips": cell.chips,
           "flops_per_image": flops.generate_flops_per_image(cfg),
           "batch_fill": fill, "requests": len(done), "units": images}
    return {"numbers": numbers, "e2e": e2e, "ctx": ctx, "peak": peak,
            "attempted": loop.next, "failed": len(loop.failed),
            "summary": summary}
