"""Readings of the program's own spans (``pgx_torch.utils.trace``), for the
layers the device trace cannot time from outside: the ADA pipe, the
penalty, the batcher's queue.

The program records its spans whenever a torch profiler session is active,
so the profiled segments of a ``--trace 1`` run record them with no switch
of the harness's own; a run without ``--trace`` reads nothing.  A program
without the facility (an older checkout) gives None, never an error.  Each
span carries ``device_ms``, the device's time between the two markers the
span put on the current stream (the host time on the CPU), and its start
and end in ns on the host.

Only the timing segment's spans are read: those that start within its
window (``trace.window_s``) of the first span recorded.  The attribution
segment after it records every host operator with its shapes; that cost
slows the host, and with it every span whose work the host paces (the
512px step's device intervals read about 1.6 times the timing segment's
there, the batcher's queue wait 2.2 times)."""

from __future__ import annotations

import statistics
from typing import List, Optional

ITERATION = "train.iteration"


def recorded(ctx) -> List[dict]:
    """The spans of the run's timing segment; none without ``--trace`` or
    without the program's span facility."""
    if not ctx.get("trace"):
        return []
    try:
        from pgx_torch.utils import trace
    except ImportError:
        return []
    spans = trace.spans()
    if not spans:
        return []
    end = min(s["start_ns"] for s in spans) + ctx["trace"]["window_s"] * 1e9
    return [s for s in spans if s["start_ns"] <= end]


def per_iteration_ms(ctx, name: str) -> Optional[float]:
    """The device ms of the ``name`` spans summed, over the number of
    training iterations (``train.iteration`` spans) recorded with them."""
    spans = recorded(ctx)
    iterations = sum(1 for s in spans if s["name"] == ITERATION)
    ms = [s["device_ms"] for s in spans
          if s["name"] == name and s["device_ms"] is not None]
    if not iterations or not ms:
        return None
    return sum(ms) / iterations


def median_ms(ctx, name: str) -> Optional[float]:
    """The median host duration of the ``name`` spans, in ms."""
    ms = [(s["end_ns"] - s["start_ns"]) / 1e6 for s in recorded(ctx)
          if s["name"] == name]
    return statistics.median(ms) if ms else None
