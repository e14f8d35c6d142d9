"""The trace reduction on a hand-made Chrome trace: the timing segment's
window, busy time and gaps, and the attribution segment's convolution
time and port kernel calls with their least time."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.lib import roofline, trace  # noqa: E402


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def test_timing_window_busy_and_gaps():
    events = [
        _x("cuda_runtime", "cudaLaunchKernel", 0.0, 5.0, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0, correlation=2),
        _x("kernel", "k1", 5.0, 20.0, tid=7, correlation=1),
        _x("kernel", "k2", 20.0, 10.0, tid=7, correlation=2),   # overlaps
        _x("cuda_runtime", "cudaDeviceSynchronize", 40.0, 60.0),
        _x("kernel", "k1", 70.0, 30.0, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 101.0, 1.0),
        _x("kernel", "k3", 110.0, 10.0, tid=7),
    ]
    out = trace.timing(events)
    assert out["window_s"] == pytest.approx(120e-6)
    assert out["busy_s"] == pytest.approx((25 + 30 + 10) * 1e-6)
    assert dict(out["device_ops"])["k1"] == pytest.approx(50e-6)
    gaps = out["idle_gaps"]
    assert gaps[0] == ["cudaDeviceSynchronize", pytest.approx(40e-6)]
    assert gaps[1] == ["host, outside any CUDA call", pytest.approx(10e-6)]
    assert gaps[2] == ["cudaLaunchKernel", pytest.approx(5e-6)]


def test_attribution_ties_kernels_to_their_operators():
    dims = [[2, 4, 4, 16], [16]]
    events = [
        _x("cpu_op", "aten::convolution", 0.0, 10.0),
        _x("cuda_runtime", "cudaLaunchKernel", 2.0, 1.0, correlation=1),
        _x("cpu_op", "pgx_torch::bias_pixelnorm_lrelu", 20.0, 10.0,
           **{"Input Dims": dims, "Input type": ["c10::BFloat16"] * 2}),
        _x("cuda_runtime", "cudaLaunchKernel", 22.0, 1.0, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 25.0, 1.0, correlation=3),
        _x("kernel", "sm90_conv", 5.0, 8.0, tid=7, correlation=1),
        _x("kernel", "rownorm_kernel", 24.0, 3.0, tid=7, correlation=2),
        _x("kernel", "copy", 27.0, 1.0, tid=7, correlation=3),
    ]
    out = trace.attribution(events)
    assert out["conv_s"] == pytest.approx(8e-6)
    assert out["port_calls"] == 1
    assert out["port_device_s"] == pytest.approx(4e-6)
    least = roofline.call_seconds("bias_pixelnorm_lrelu", dims,
                                  ["c10::BFloat16"] * 2)
    assert out["port_bound_s"] == pytest.approx(least)
