"""The benchmark's per-layer metrics that read the program's spans
(``perfbench/lib/spans.py``), at a size a CPU test holds
(``perfbench/tests/tiny.py``), run with ``--trace 1 --device cpu``.

Where there is no card the harness's profiled segments are recorded with
the host's activity (``_cpu_profile``): the program's spans record under
any profiler session, so the new metrics read numbers.  The readers of the
device trace read what they read before: the spans' names are none of the
prefixes their attribution looks for, and a checkout without the span
facility reads nothing from the new readers and raises nothing."""

import json
import sys
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402
from perfbench.lib import common  # noqa: E402
from perfbench.lib import trace as bench_trace  # noqa: E402
from perfbench.tests import tiny  # noqa: E402
from pgx_torch.utils import trace  # noqa: E402

SEED = "3000000029"
NEW = {"pgan128.train": {"penalty_ms.train"},
       "pgan512.train_ada": {"ada_pipe_ms.train.512px",
                             "penalty_ms.train.512px"},
       "pgan128.serve": {"serve_queue_wait_ms"}}


def _cpu_profile(torch, fn, host):
    """A profiled segment without a card: the host's operators, and one
    runtime call spanning the segment, which the timing reduction needs."""
    import os
    import tempfile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=host) as prof:
        with record_function(bench_trace.WINDOW):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    window = next(e for e in events if e.get("name") == bench_trace.WINDOW)
    events.append({**window, "cat": "cuda_runtime",
                   "name": "cudaDeviceSynchronize"})
    return events


def _traced(capsys, monkeypatch, manifest, cell):
    trace.clear()
    # this test process has JAX loaded (tests/conftest.py); the run's own
    # import check is perfbench/tests' to hold
    monkeypatch.setattr(common, "forbidden_modules", lambda names=None: [])
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.3",
                   "--device", "cpu", "--manifest", str(manifest),
                   "--trace", "1"], require_chip=False)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    trace.clear()
    return rc, line


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(NEW))
def test_traced_tiny_cells_read_the_span_metrics(capsys, monkeypatch, tree,
                                                 cell):
    monkeypatch.setattr(bench_trace, "_profile", _cpu_profile)
    rc, line = _traced(capsys, monkeypatch, tree, cell)
    # (the card's limits do not hold the tiny configurations: ``correct``
    # is not this test's)
    assert rc == 0
    metrics = line["metrics"]
    for name in NEW[cell]:
        assert metrics[name]["unit"] == "ms"
        assert metrics[name]["value"] > 0, name
    # the host-clock readers still read, the kernels' readers find no
    # kernel here, as before
    assert {"train_mfu", "train_mfu.512px", "serve_mfu"} & set(metrics)
    assert not {m for m in metrics if m.startswith(("cudnn_conv_ms",
                                                    "kernel_roofline"))}


def test_a_checkout_without_spans_reads_none(capsys, monkeypatch, tree):
    """The new readers over a program that has no span facility (the
    parent commit's): no number, no error, every other metric as with
    it."""
    monkeypatch.setattr(bench_trace, "_profile", _cpu_profile)
    rc, line = _traced(capsys, monkeypatch, tree, "pgan128.serve")
    assert rc == 0
    with_spans = set(line["metrics"])
    monkeypatch.setitem(sys.modules, "pgx_torch.utils.trace", None)
    from perfbench.lib import spans
    assert spans.recorded({"trace": {"units": 1}}) == []
    monkeypatch.delitem(sys.modules, "pgx_torch.utils.trace")
    monkeypatch.setattr(trace, "spans", lambda: [])
    rc, line = _traced(capsys, monkeypatch, tree, "pgan128.serve")
    assert rc == 0
    assert set(line["metrics"]) == with_spans - NEW["pgan128.serve"]


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def test_span_annotations_leave_the_attribution_as_it_was():
    """The attribution segment ties each kernel to the operators around its
    launch; the program's spans around them (``user_annotation`` events in
    torch's trace) change neither the convolution time nor the port's
    kernel calls."""
    dims = [[2, 4, 4, 16], [16]]
    events = [
        _x("cpu_op", "aten::convolution", 10.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 12.0, 1.0, correlation=1),
        _x("cpu_op", "pgx_torch::bias_pixelnorm_lrelu", 30.0, 10.0,
           **{"Input Dims": dims, "Input type": ["c10::BFloat16"] * 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 32.0, 1.0, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 45.0, 1.0, correlation=3),
        _x("kernel", "sm90_conv", 15.0, 8.0, tid=7, correlation=1),
        _x("kernel", "rownorm_kernel", 34.0, 3.0, tid=7, correlation=2),
        _x("kernel", "copy", 47.0, 1.0, tid=7, correlation=3),
    ]
    spans = [_x("user_annotation", "train.iteration", 0.0, 60.0),
             _x("user_annotation", "train.d_step", 5.0, 30.0),
             _x("user_annotation", "train.penalty", 8.0, 26.0),
             _x("user_annotation", "train.optimizer", 44.0, 5.0)]
    assert bench_trace.attribution(events + spans) == \
        bench_trace.attribution(events)
    assert bench_trace.timing(events + spans) == bench_trace.timing(events)


def test_the_readers_take_the_timing_segment(monkeypatch):
    """Two traced segments' spans: the readers keep those that start within
    the first (timing) segment's window, where the profiler's host cost
    stretches no device interval the host paces."""
    from perfbench.lib import spans

    def seg(t0, penalty_ms, wait_ms):
        out = []
        for i in range(2):
            a = t0 + i * 100_000_000
            out += [{"name": "train.iteration", "start_ns": a,
                     "end_ns": a + 90_000_000, "device_ms": 90.0},
                    {"name": "train.penalty", "start_ns": a + 1,
                     "end_ns": a + 2, "device_ms": penalty_ms},
                    {"name": "serve.queue", "start_ns": a,
                     "end_ns": a + int(wait_ms * 1e6), "device_ms": None}]
        return out
    recorded = seg(10**18, 10.0, 4.0) + seg(10**18 + 5 * 10**9, 30.0, 9.0)
    monkeypatch.setattr(trace, "spans", lambda: list(recorded))
    ctx = {"trace": {"window_s": 0.2, "units": 2}}
    assert spans.per_iteration_ms(ctx, "train.penalty") == 10.0
    assert spans.median_ms(ctx, "serve.queue") == 4.0
    assert spans.per_iteration_ms({}, "train.penalty") is None
