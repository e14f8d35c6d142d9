"""``pgx_torch.utils.trace`` on the CPU: spans off cost a shared object and
nothing else; on, they nest, share the profiler's clock and record under a
profiler session alone; the train step, the batcher and the loop mark
their phases; ``GeneratorService.stats()``' histograms give a window's
percentiles."""

import itertools
import json
import math
import statistics
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pgx_torch.augment import AdaConfig, bgc_config
from pgx_torch.models import zoo as tzoo
from pgx_torch.models.generator import init_generator
from pgx_torch.serve import (HIST_EDGES_MS, GeneratorService, _count,
                             percentile_ms)
from pgx_torch.train import wgan
from pgx_torch.utils import trace


@pytest.fixture(autouse=True)
def fresh_spans():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def test_spans_off_record_and_allocate_nothing():
    with trace.span("warm"):            # the name's shared object, once
        pass
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10_000):     # no int kept alive
            with trace.span("warm") as s:
                assert s is trace.span("warm") and s.id is None
            with trace.span("warm", which="real"):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before
    assert trace.span("warm") is trace.span("warm")
    assert trace.spans() == [] and not trace.active()


def test_span_off_costs_under_half_a_microsecond():
    """The median over 100 batches of 1000 spans (10^5) of the thread's own
    CPU time a span, less an empty loop's; the best of five rounds, since
    other processes can share a test machine's cores and caches."""
    span = trace.span

    def spans(n):
        for _ in range(n):
            with span("cost"):
                pass

    def empty(n):
        for _ in range(n):
            pass

    def median_ns(fn):
        out = []
        for _ in range(100):
            t = time.thread_time_ns()
            fn(1000)
            out.append((time.thread_time_ns() - t) / 1000)
        return statistics.median(out)

    best = math.inf
    for _ in range(5):
        best = min(best, median_ns(spans) - median_ns(empty))
        if best < 500:
            break
    assert best < 500, f"{best:.0f} ns a span"


def test_spans_record_under_a_profiler_and_stop_after_it():
    with trace.span("before"):
        pass
    with _profiled() as prof:
        assert trace.active()
        with trace.span("inside", k=3):
            pass
    with trace.span("after"):
        pass
    got = trace.spans()
    assert [s["name"] for s in got] == ["inside"]
    assert got[0]["attrs"] == {"k": 3} and got[0]["device_ms"] >= 0
    assert "inside" in {e.key for e in prof.key_averages()}


def test_spans_share_the_profilers_clock(tmp_path):
    """A span and a ``record_function`` opened back to back over a 10 ms
    sleep: on the exported traces' timeline (``ts`` x 1000 +
    ``baseTimeNanoseconds``) their ends agree within 1 ms."""
    with _profiled() as prof:
        with trace.span("pgx.clock"):
            with record_function("torch.clock"):
                time.sleep(0.01)
    prof.export_chrome_trace(str(tmp_path / "torch.json"))
    trace.export(str(tmp_path / "spans.json"))

    def ends(path, name):
        doc = json.loads((tmp_path / path).read_text())
        e = next(e for e in doc["traceEvents"] if e.get("name") == name
                 and e.get("ph") == "X")
        base = doc["baseTimeNanoseconds"]
        return base + e["ts"] * 1e3, base + (e["ts"] + e["dur"]) * 1e3

    ours, theirs = ends("spans.json", "pgx.clock"), ends("torch.json",
                                                         "torch.clock")
    assert abs(ours[0] - theirs[0]) < 1e6 and abs(ours[1] - theirs[1]) < 1e6
    assert ours[1] - ours[0] >= 10e6


def test_parent_ids_nest_on_one_thread():
    trace.enable()
    with trace.span("a") as a:
        with trace.span("b") as b:
            with trace.span("c"):
                pass
        with trace.span("d"):
            pass
    seen = {}

    def other():
        with trace.span("e", parent=b):
            pass
        seen["tid"] = threading.get_native_id()
    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    got = {s["name"]: s for s in trace.spans()}
    assert got["a"]["parent"] is None
    assert got["b"]["parent"] == got["d"]["parent"] == a.id
    assert got["c"]["parent"] == b.id and got["e"]["parent"] == b.id
    assert got["e"]["thread"] == seen["tid"] != got["a"]["thread"]
    assert got["a"]["start_ns"] <= got["b"]["start_ns"] <= got["c"][
        "end_ns"] <= got["b"]["end_ns"] <= got["a"]["end_ns"]


def test_ring_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    from collections import deque
    monkeypatch.setattr(trace, "CAPACITY", 4)
    monkeypatch.setattr(trace._REC, "ring", deque(maxlen=4))
    trace.enable()
    for i in range(7):
        with trace.span(f"s{i}"):
            pass
    assert [s["name"] for s in trace.spans()] == ["s3", "s4", "s5", "s6"]
    assert trace.dropped() == 3


# ---------------------------------------------------------------------------
# The train step's phases
# ---------------------------------------------------------------------------

KW = dict(z_dim=8, num_classes=3, max_step=3)
G = tzoo.conditional_correct_generator(channel=8, **KW)
D = tzoo.conditional_correct_discriminator_wgangp(
    feat_dim=8, **{k: v for k, v in KW.items() if k != "z_dim"})
B, STEP = 2, 3


def _iteration_spans(tc, k=1, **kw):
    """The spans of one call of the step (or a window of k), by name."""
    torch.manual_seed(0)
    state = wgan.init_train_state(G, D, tc, device="cpu")
    res = G.resolution(STEP)
    real = torch.rand(B, res, res, G.img_channels) * 2 - 1
    labels = torch.arange(B) % 3
    rng = torch.Generator().manual_seed(0)
    aug = kw.get("augment_cfg") is not None

    def draws(j, r):
        z, eps = wgan.draw_z_eps(G, B, rng)
        return z, eps, wgan.draw_augment_sources(rng) if aug else None
    trace.enable()
    if k == 1:
        z, eps, src = draws(0, real)
        wgan.make_train_step(G, D, tc, step=STEP, fading=False, **kw)(
            state, real, labels, 1.0, z=z, eps=eps, aug_draws=src)
    else:
        wgan.make_train_multi_step(G, D, tc, step=STEP, fading=False, k=k,
                                   **kw)(state, [real] * k, [labels] * k,
                                         [1.0] * k, draws=draws)
    trace.disable()
    return trace.spans()


@pytest.mark.parametrize("tc_kw", [{}, {"gp_mode": "jvp", "fused_g": True},
                                   {"remat": True}])
def test_train_step_marks_its_phases(tc_kw):
    got = _iteration_spans(wgan.TrainConfig(**tc_kw),
                           augment_cfg=bgc_config(), ada_cfg=AdaConfig())
    by_id = {s["id"]: s for s in got}
    it = [s for s in got if s["name"] == "train.iteration"]
    assert len(it) == 1 and it[0]["attrs"] == {"iteration": 0,
                                              "penalty": True}
    parent = lambda s: by_id[s["parent"]]["name"]
    names = [s["name"] for s in got]
    fused = tc_kw.get("fused_g", False)
    pipes = {s["attrs"]["which"]: parent(s) for s in got
             if s["name"] == "train.ada_pipe"}
    assert pipes == ({"real": "train.iteration", "d_fake": "train.d_step"}
                     if fused else
                     {"real": "train.iteration", "d_fake": "train.d_step",
                      "g_fake": "train.g_step"})
    # recomputation in the backward (remat) records nothing twice
    assert names.count("train.penalty") == 1
    assert parent(next(s for s in got if s["name"] == "train.penalty")) \
        == "train.d_step"
    for name in ("train.d_step", "train.g_step"):
        assert names.count(name) == 1
        assert parent(next(s for s in got if s["name"] == name)) \
            == "train.iteration"
    assert sorted(s["attrs"]["net"] for s in got
                  if s["name"] == "train.optimizer") == ["d", "g"]
    assert next(s for s in got if s["name"] == "train.g_step")[
        "attrs"] == {"fused": fused}
    assert not any(s["name"].startswith(("aten::", "pgx_torch::"))
                   for s in got)


def test_a_window_marks_its_draws_and_lazy_penalty():
    got = _iteration_spans(wgan.TrainConfig(gp_every=2), k=4)
    names = [s["name"] for s in got]
    assert names.count("train.iteration") == names.count("train.draws") == 4
    assert names.count("train.penalty") == 2
    assert [s["attrs"]["penalty"] for s in got
            if s["name"] == "train.iteration"] == [True, False, True, False]


# ---------------------------------------------------------------------------
# The batcher
# ---------------------------------------------------------------------------

SG = tzoo.mnist_conditional_generator(z_dim=8, num_classes=3, channel=8)


@pytest.fixture()
def service():
    svc = GeneratorService.from_params(SG, init_generator(SG, 0), step=2,
                                       max_batch=8, max_wait_ms=20.0,
                                       fetch_threads=2, device="cpu")
    try:
        yield svc
    finally:
        svc.close()


def test_a_served_requests_spans_share_its_id(service):
    service.warmup((1,))
    trace.enable()
    rng = np.random.RandomState(0)
    futs = [service.submit(rng.randn(2, 8).astype(np.float32),
                           np.arange(2) % 3) for _ in range(3)]
    for f in futs:
        f.result(timeout=60)
    trace.disable()
    got = trace.spans()
    by_id = {s["id"]: s for s in got}
    main = threading.get_native_id()
    for req in {s["attrs"]["request"] for s in got
                if s["name"] == "serve.request"}:
        queue, = [s for s in got if s["name"] == "serve.queue"
                  and s["attrs"]["request"] == req]
        done, = [s for s in got if s["name"] == "serve.request"
                 and s["attrs"]["request"] == req]
        batch, = [s for s in got if s["name"] == "serve.batch"
                  and req in s["attrs"]["requests"]]
        fetch, = [s for s in got if s["name"] == "serve.fetch"
                  and s["attrs"]["batch"] == batch["attrs"]["batch"]]
        assert queue["attrs"]["batch"] == done["attrs"]["batch"] \
            == batch["attrs"]["batch"]
        assert by_id[fetch["parent"]] is batch
        assert batch["thread"] != main and fetch["thread"] != batch["thread"]
        assert queue["end_ns"] <= batch["start_ns"]
        assert done["start_ns"] == queue["start_ns"]
        assert done["end_ns"] >= fetch["end_ns"] >= batch["start_ns"]
    assert len({s["attrs"]["request"] for s in got
                if s["name"] == "serve.queue"}) == 3


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_window_percentiles_from_two_histogram_snapshots(q):
    rng = np.random.RandomState(int(q * 100))
    counts = [0] * (len(HIST_EDGES_MS) + 1)
    for ns in rng.lognormal(math.log(5e6), 1.0, 2000).astype(np.int64):
        _count(counts, int(ns))
    before = list(counts)
    window = rng.lognormal(math.log(40e6), 0.7, 3000).astype(np.int64)
    for ns in window:
        _count(counts, int(ns))
    got = percentile_ms([a - b for a, b in zip(counts, before)], q)
    exact = np.sort(window)[math.ceil(q * len(window)) - 1] / 1e6
    k = int(np.searchsorted(HIST_EDGES_MS, got))
    assert HIST_EDGES_MS[k - 1] <= exact <= HIST_EDGES_MS[k]


def test_stats_count_latency_from_submit(service):
    """Five single images under a batch of 8 wait out the batcher's 20 ms
    window: the queue wait, and the latency counted from submit, hold
    it."""
    service.warmup((1,))
    base = service.stats()
    rng = np.random.RandomState(1)
    futs = [service.submit(rng.randn(1, 8).astype(np.float32),
                           np.array([i % 3])) for i in range(5)]
    for f in futs:
        f.result(timeout=60)
    s = service.stats()

    def window(key):
        return [a - b for a, b in zip(s["latency_hist"][key],
                                      base["latency_hist"][key])]
    latency, wait = window("request"), window("queue_wait")
    assert sum(latency) == sum(wait) == 5
    assert percentile_ms(wait, 1.0) >= 18.0
    assert percentile_ms(latency, 1.0) >= percentile_ms(wait, 1.0)
    assert s["latency_p95_ms"] >= s["queue_wait_p95_ms"] >= 18.0
    json.dumps(s)                       # what /stats serves


def test_device_markers_resolve_with_one_synchronize_and_are_reused(
        monkeypatch):
    """The CUDA path with a stand-in device: each span records a pair of
    markers; ``spans()`` synchronizes once and reads each pair into
    ``device_ms``; a read pair serves the next span."""
    clock, made, syncs = [0.0], [], []

    class Marker:
        def __init__(self, enable_timing):
            assert enable_timing
            made.append(self)

        def record(self):
            clock[0] += 1.5
            self.at = clock[0]

        def query(self):
            return True

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", Marker)
    monkeypatch.setattr(torch.cuda, "synchronize", syncs.append)
    monkeypatch.setitem(trace._REC.free, 0, [])
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            pass
    got = {s["name"]: s["device_ms"] for s in trace.spans()}
    assert got == {"inner": 1.5, "outer": 4.5} and syncs == [0]
    assert trace.spans() and syncs == [0]       # nothing left to read
    with trace.span("again"):
        pass
    assert len(made) == 4 and trace.spans()[-1]["device_ms"] == 1.5


def test_a_training_cli_writes_its_spans(tmp_path):
    """``--spans PATH``: the loop's spans (data waits, the step's phases,
    grids, checkpoints) recorded over the run and written at its end as a
    Chrome trace on the profiler's time base."""
    from pgx_torch.cli import mnist_train
    path = tmp_path / "spans.json"
    mnist_train.main(["--device", "cpu", "--synthetic", "--channels", "8",
                      "--z-dim", "8", "--total-iter", "4", "--max-step", "2",
                      "--sample-every", "2", "--checkpoint-every", "2",
                      "--log-every", "2", "--output", str(tmp_path),
                      "--spans", str(path)])
    doc = json.loads(path.read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("data.wait") >= names.count("train.iteration") >= 4
    assert {"loop.grid", "loop.checkpoint", "train.d_step",
            "train.optimizer"} <= set(names)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])
    assert doc["baseTimeNanoseconds"] % 1_000_000_000 == 0
    assert not trace.active()
