"""What the per-layer metrics read, one function a quantity: each reader
under ``metrics/`` is one of these, named for the cells it reads.  Each
takes the run's ``ctx`` and returns the value, or None where the run has
nothing to read."""

from perfbench.flops import PEAK_BF16_FLOPS


def mfu(ctx):
    """Model FLOPs of the window's work (``perfbench.flops``: the
    reference's passes, a bucket's padding rows not counted) over the
    window's seconds times the chips' dense bf16 peak, in per cent."""
    if not ctx.get("images"):
        return None
    work = ctx["images"] * ctx["flops_per_image"]
    return 100.0 * work / (ctx["window_s"] * ctx["chips"] * PEAK_BF16_FLOPS)


def conv_ms(ctx):
    """Device ms per unit of work (an iteration) of the kernels launched
    under aten's convolution ops and their backwards, in the attribution
    segment of ``--trace 1`` (each kernel tied to its launch, the launch to
    the operators around it)."""
    tr = ctx.get("trace")
    if not tr or not tr.get("units") or tr["conv_s"] <= 0:
        return None
    return 1e3 * tr["conv_s"] / tr["units"]


def kernel_roofline(ctx):
    """The least time of the port's kernel calls (each call's larger of
    bytes over the HBM rate and operations over the peak, from its recorded
    shapes, ``perfbench.lib.roofline``) over the device time of the kernels
    those calls launched, in the traced segment, in per cent."""
    tr = ctx.get("trace")
    if not tr or tr["port_device_s"] <= 0:
        return None
    return 100.0 * tr["port_bound_s"] / tr["port_device_s"]


def device_idle(ctx):
    """The share of the untraced window in which the device was idle, in
    per cent: one minus the device's busy time per unit of work in the
    timing segment of ``--trace 1`` (the union of its kernels, copies and
    sets, which the profiler's cost on the host does not lengthen) times
    the window's work, over the window.  The timing segment's own idle
    share, which the profiler's cost on the host inflates, is
    ``device.busy_s`` over ``device.window_s``."""
    tr = ctx.get("trace")
    if not tr or not tr.get("units") or not ctx.get("units"):
        return None
    busy = tr["busy_s"] / tr["units"] * ctx["units"]
    return 100.0 * (1.0 - busy / ctx["window_s"])
