"""A traced segment under ``torch.profiler`` and its reduction to what the
per-layer metrics read.

The segment ends with a device synchronize, so every device operation it
launched lies inside it.  The profiler's Chrome trace gives the runtime's
calls and the device's kernels, copies and sets, and in the attribution
run the host's operator spans with their input shapes; a kernel is tied to
its launch by the correlation id and to the operators around the launch on
the launching thread by time.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

from perfbench.lib import roofline

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CONV_PREFIXES = ("aten::conv", "aten::_conv", "aten::cudnn_conv")


def _all_threads():
    """The profiler's setting that records host operators on every thread
    (the serving batcher's, the autograd engine's), where this torch has
    it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def _profile(torch, fn: Callable[[], None], host: bool) -> List[dict]:
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA]
    kw = {}
    if host:
        acts.append(ProfilerActivity.CPU)
        kw = {"record_shapes": True, "experimental_config": _all_threads()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=acts, **kw) as prof:
            with record_function(WINDOW):
                fn()
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def run_traced(torch, fn: Callable[[], None]) -> dict:
    """Run ``fn`` (which synchronizes the device before it returns) twice
    under the profiler: once tracing the device and the runtime's calls
    alone, which costs the host little, for the busy time, the window and
    the idle gaps (``timing``); once with the host's operators and their
    input shapes as well, for what each kernel belongs to
    (``attribution``), whose device times the host's extra cost does not
    change."""
    out = timing(_profile(torch, fn, host=False))
    out.update(attribution(_profile(torch, fn, host=True)))
    return out


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Stacks:
    """The operator spans of each host thread, for the spans around a
    point in time."""

    def __init__(self, ops: List[dict]):
        self.by_tid: Dict[tuple, List[dict]] = collections.defaultdict(list)
        for e in ops:
            self.by_tid[(e["pid"], e["tid"])].append(e)
        for lst in self.by_tid.values():
            lst.sort(key=lambda e: (e["ts"], -e.get("dur", 0)))

    def around_all(self, points: List[dict]) -> Dict[int, List[dict]]:
        """The spans around each of ``points`` (runtime calls) on its own
        thread, outermost first, keyed by ``id`` of the point: one sweep
        per thread."""
        out: Dict[int, List[dict]] = {}
        by_tid = collections.defaultdict(list)
        for p in points:
            by_tid[(p["pid"], p["tid"])].append(p)
        for key, pts in by_tid.items():
            lst, i, stack = self.by_tid.get(key, []), 0, []
            for p in sorted(pts, key=lambda e: e["ts"]):
                t = p["ts"]
                while i < len(lst) and lst[i]["ts"] <= t:
                    while stack and _end(stack[-1]) < lst[i]["ts"]:
                        stack.pop()
                    stack.append(lst[i])
                    i += 1
                while stack and _end(stack[-1]) < t:
                    stack.pop()
                out[id(p)] = list(stack)
        return out


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


def _spans(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X"]


def timing(events: List[dict]) -> dict:
    """A device-and-runtime trace's window (from the first runtime call to
    the end of the last runtime call or device operation, in seconds), the
    device's busy time in it (the union of kernels, copies and sets), each
    device operation's time by name, and the longest idle gaps, each named
    by the runtime call the host was in at its middle."""
    spans = _spans(events)
    calls = [e for e in spans if e.get("cat") in ("cuda_runtime",
                                                  "cuda_driver")]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not calls:
        raise ValueError("the trace holds no runtime call")
    w0 = min(e["ts"] for e in calls)
    w1 = max(_end(e) for e in calls + device)
    by_name: Dict[str, float] = collections.defaultdict(float)
    intervals = []
    for k in device:
        a, b = max(k["ts"], w0), min(_end(k), w1)
        if b > a:
            intervals.append((a, b))
            by_name[k["name"]] += (b - a) * 1e-6
    merged = _merge(intervals)
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for i in range(0, len(edges) - 1, 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i + 1] - edges[i], edges[i]))
    gaps.sort(reverse=True)
    idle = []
    for length, a in gaps[:10]:
        mid = a + length / 2
        inside = [c["name"] for c in calls if c["ts"] <= mid <= _end(c)]
        idle.append([inside[0] if inside else "host, outside any CUDA call",
                     length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in merged) * 1e-6,
            "device_ops": [[n, s] for n, s in top], "idle_gaps": idle}


def attribution(events: List[dict]) -> dict:
    """A trace with host operators and shapes: the device time of the
    kernels launched under aten's convolution ops, and of each port kernel
    call beside that call's least time (``roofline``)."""
    spans = _spans(events)
    ops = [e for e in spans if e.get("cat") in ("cpu_op", "user_annotation")]
    launches = {e["args"]["correlation"]: e for e in spans
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    tied = {}
    for k in kernels:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is not None:
            tied[id(k)] = launch
    ancestry = _Stacks(ops).around_all(
        list({id(v): v for v in tied.values()}.values()))
    port: Dict[int, dict] = {}
    conv_s = 0.0
    for k in kernels:
        sec = k["dur"] * 1e-6
        launch = tied.get(id(k))
        if launch is None:
            continue
        around = ancestry[id(launch)]
        if any(o["name"].startswith(CONV_PREFIXES) for o in around):
            conv_s += sec
        mine = [o for o in around if o["name"].startswith("pgx_torch::")]
        if mine:
            rec = port.setdefault(id(mine[-1]), {
                "op": mine[-1]["name"][len("pgx_torch::"):],
                "device_s": 0.0, "args": mine[-1].get("args", {})})
            rec["device_s"] += sec
    bound_s = port_s = 0.0
    for rec in port.values():
        args = rec["args"]
        least = roofline.call_seconds(rec["op"], args.get("Input Dims"),
                                      args.get("Input type"),
                                      args.get("Concrete Inputs"))
        if least is not None:
            bound_s += least
            port_s += rec["device_s"]
    return {"conv_s": conv_s, "port_device_s": port_s,
            "port_bound_s": bound_s, "port_calls": len(port)}
