"""The table of peaks and the least time of each kernel call of the port.

A call's least time is the larger of its bytes over the HBM rate and its
operations over the peak rate of its kind (tensor-core math for the fused
3x3 conv, the float32 rate outside the tensor cores for elementwise work),
with each input read once and each output written once.  The operations
and bytes are those of ``chip_smoke.py``'s kernel table, worked out from
the call's shapes as the profiler records them (``record_shapes``), so the
work counted is the call's, whatever implements it.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

# one H100 SXM (NVIDIA data sheet), dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
F32_ELEMENTWISE_OPS = 67e12

_SIZES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8}


def _numel(dims: Sequence[int]) -> int:
    return math.prod(dims) if dims else 0


def _flags(text) -> List[bool]:
    """A recorded ``bool[]`` argument ("[True, False, True]" or a list)."""
    if isinstance(text, (list, tuple)):
        return [bool(v) for v in text]
    return [t.strip().lower() in ("true", "1")
            for t in str(text).strip("[]()").split(",") if t.strip()]


def call_seconds(op: str, dims: List[List[int]], types: List[str],
                 concrete: Optional[list] = None) -> Optional[float]:
    """Least seconds of one call of ``pgx_torch::<op>`` with input shapes
    ``dims`` and input types ``types``; None for a call this table does not
    cover (its device time is then left out of the share as well)."""
    if not dims or not dims[0]:
        return None
    es = _SIZES.get(types[0]) if types else None
    if es is None:
        return None
    n, c = _numel(dims[0]), dims[0][-1]
    dtype = "bfloat16" if es == 2 else "float32"
    ops, peak = 0.0, F32_ELEMENTWISE_OPS
    if op in ("bias_pixelnorm_lrelu", "pixel_norm_lrelu"):
        ops, nbytes = 6.0 * n, 2 * n * es + c * es
    elif op in ("conv3x3_epilogue", "conv3x3_epilogue_r"):
        cout = dims[1][-1]
        m = n // c
        ops, peak = 2.0 * m * 9 * c * cout, PEAK_OPS[dtype]
        nbytes = (n + 9 * c * cout + cout + m * cout) * es
        if op == "conv3x3_epilogue_r":
            nbytes += m * 4
    elif op == "bias_pixelnorm_lrelu_bwd":
        ops, nbytes = 10.0 * n, 3 * n * es + c * es + c * 4
    elif op == "bias_pixelnorm_lrelu_bwd2":
        needs = _flags(concrete[7]) if concrete and len(concrete) > 7 \
            and concrete[7] not in ("", None) else [True, True, True]
        has_ddy, has_ddb = bool(dims[3]), bool(dims[4])
        full = 2 + has_ddy + needs[0] + needs[2]
        ops = 30.0 * n
        nbytes = full * n * es + c * es + c * 4 * (has_ddb + needs[1])
    elif op == "bias_pixelnorm_lrelu_jvp":
        nbytes = 3 * n * es + c * es * (1 + bool(dims[3]))
    elif op == "shift_1d":
        ops, nbytes = 3.0 * n, 2 * n * es + _numel(dims[1]) * 4
    elif op == "bias_act":
        ops, nbytes = 10.0 * n, 2 * n * es + c * es
    else:
        return None
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)
