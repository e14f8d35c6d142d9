"""Kernel A: the conv-block epilogue bias -> pixel-norm -> leaky-ReLU.

Replaces ``pgx/ops/pallas/epilogue.py:bias_pixelnorm_lrelu`` (``_forward``,
body ``_fwd_kernel``).  Per NHWC row of C channels::

    a   = y + b                      (in y's dtype)
    r   = rsqrt(mean_c(a^2) + eps)   (f32, or wider for an f64 input)
    out = lrelu(a * r, slope)        (stored in y's dtype)

Bound: bytes (read y once, write out once; a few operations per element).
The CUDA kernel (``csrc/epilogue.cu``) gives each row a group of lanes sized
to it (the power of two that covers its 16-byte vectors, at most a warp),
keeps the row in registers between the reduction and the store, and so moves
exactly those bytes.

Differentiation.  The wrapper is a ``torch.autograd.Function`` whose forward
launches the kernel.  Its backward is a second Function,
``_BiasPixelNormLreluGrad``, whose forward launches the backward kernel
(``pgx_bias_pixelnorm_lrelu_bwd``; the plain version for a CPU tensor): the
transpose of pgx's tangent rule (``epilogue.py:_jvp_rule``)::

    s   = lrelu's slope at a,   dpn = s * g
    da  = r * dpn - r^3 * mean_c(dpn * a) * a
    dy  = da,  db = sum_rows(da)

Neither is ``once_differentiable``: the discriminator runs this epilogue
under the WGAN-GP gradient penalty, where ``torch.autograd.grad(...,
create_graph=True)`` records the backward and differentiates it again.  The
backward Function's own backward is a third Function,
``_BiasPixelNormLreluGrad2``, whose forward launches the second-order kernel
(``pgx_bias_pixelnorm_lrelu_bwd2``; the plain version for a CPU tensor): the
second derivative in closed form (``rownorm_lrelu_backward_vjp``), which the
penalty's outer pass runs in place of autograd through the first
derivative's ops.  Its backward differentiates the plain closed form again.
pgx has no backward kernels (its rule is plain jnp).

Forward mode.  ``_BiasPixelNormLrelu.jvp`` returns the tangent through a
fourth Function, ``_BiasPixelNormLreluTangent``, whose forward launches the
tangent kernel (``pgx_bias_pixelnorm_lrelu_jvp``; the plain version
``bias_pixelnorm_lrelu_jvp_ref`` for a CPU tensor): pgx's ``_jvp_rule``::

    a = y + b,  da = dy + db        (each in y's dtype, then f32)
    m = mean_c(a * da),  dpn = da * r - a * r^3 * m
    dout = dpn where a >= 0, else slope * dpn

The JVP form of the gradient penalty differentiates that tangent in reverse
mode.  The tangent is linear in ``(dy, db)``, so its transpose there is A's
VJP (the backward kernel); its gradient in ``(y, b)`` for the cotangent c is
``d/dy <c, J(y) t> = d/dy <J(y)^T c, t>``, which is A's second derivative
with ``g = c`` and ``(ddy, ddb) = (dy, db)`` (the second-order kernel).  So
reverse over forward mode runs kernels only.

``supported(y)`` says whether the kernels take ``y``: float32 or bfloat16
with C a multiple of 8 and at most 512.  The layers ask it before calling
``bias_pixelnorm_lrelu`` and otherwise take the plain torch ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from pgx_torch.ops.kernels import build

NAME = "bias_pixelnorm_lrelu"
NAME_BWD = "bias_pixelnorm_lrelu_bwd"
NAME_BWD2 = "bias_pixelnorm_lrelu_bwd2"
NAME_JVP = "bias_pixelnorm_lrelu_jvp"
MAX_C = 512


def supported(y: torch.Tensor) -> bool:
    """Whether the kernels take ``y``: float32 or bfloat16, its last axis C
    a multiple of 8 and at most 512 (shared by kernels A and B)."""
    c = y.shape[-1] if y.dim() else 0
    return (y.dtype in (torch.float32, torch.bfloat16) and 0 < c <= MAX_C
            and c % 8 == 0)


def check_channels(name: str, c: int) -> None:
    if c % 8 or not 0 < c <= MAX_C:
        raise ValueError(f"{name}: C={c} must be a multiple of 8, <= "
                         f"{MAX_C}")


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the row statistics are taken in: f32, or wider."""
    return torch.promote_types(dtype, torch.float32)


def rownorm_lrelu_ref(a: torch.Tensor, slope: float, eps: float,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """``lrelu(a * rsqrt(mean_c(a^2) + eps))`` for ``a`` already in the
    statistics dtype; shared by the plain versions of kernels A and B."""
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True)
                    * (1.0 / a.shape[-1]) + eps)
    out = a * r
    return torch.where(out < 0, slope * out, out).to(out_dtype)


def rownorm_lrelu_backward(a: torch.Tensor, g: torch.Tensor, slope: float,
                           eps: float) -> torch.Tensor:
    """Gradient of ``rownorm_lrelu_ref`` with respect to ``a`` for the
    cotangent ``g``, both in the statistics dtype.  Plain torch ops, so
    autograd can differentiate it again."""
    inv_c = 1.0 / a.shape[-1]
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True) * inv_c + eps)
    dpn = torch.where(a >= 0, g, slope * g)
    m = torch.sum(dpn * a, dim=-1, keepdim=True) * inv_c
    return dpn * r - a * (r * r * r) * m


def rownorm_lrelu_backward_vjp(a: torch.Tensor, g: torch.Tensor,
                               u: torch.Tensor, slope: float, eps: float):
    """The second derivative in closed form: for the cotangent ``u`` of
    ``rownorm_lrelu_backward(a, g)``, its gradients ``(d_a, d_g)``.  All in
    the statistics dtype; plain torch ops, differentiable again.  Per row,
    with P = sum(u * dpn), Q = sum(u * a)::

        d_g = s * (r u - r^3 Q a / C)
        d_a = (3 r^5 m Q / C - r^3 P / C) a - r^3 Q dpn / C - r^3 m u
    """
    inv_c = 1.0 / a.shape[-1]
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True) * inv_c + eps)
    pos = a >= 0
    # tensors on both sides of torch.where: a Python scalar there is f32
    dpn = torch.where(pos, g, g * slope)
    m = torch.sum(dpn * a, dim=-1, keepdim=True) * inv_c
    p = torch.sum(u * dpn, dim=-1, keepdim=True) * inv_c
    q = torch.sum(u * a, dim=-1, keepdim=True) * inv_c
    r3 = r * r * r
    r3q = r3 * q
    # per-row coefficients first: each full-size term is one fused pass
    t = torch.addcmul(r * u, a, r3q, value=-1.0)
    d_g = torch.where(pos, t, t * slope)
    d_a = torch.addcmul((3.0 * r3 * r * r * m * q - r3 * p) * a, dpn, r3q,
                        value=-1.0)
    d_a = torch.addcmul(d_a, u, r3 * m, value=-1.0)
    return d_a, d_g


def bias_pixelnorm_lrelu_ref(y: torch.Tensor, b: torch.Tensor,
                             slope: float = 0.2,
                             eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version: the same arithmetic, statistics in f32 (f64
    for an f64 input)."""
    a = (y + b.to(y.dtype)).to(stat_dtype(y.dtype))
    return rownorm_lrelu_ref(a, slope, eps, y.dtype)


def _launch(y: torch.Tensor, b: torch.Tensor, slope: float,
            eps: float) -> torch.Tensor:
    y = build.aligned(y)
    build.check_cuda_input(NAME, y)
    c = y.shape[-1]
    check_channels(NAME, c)
    bb = build.aligned(b.to(device=y.device, dtype=y.dtype).contiguous())
    out = torch.empty_like(y)
    lib = build.load_library()
    build.check(lib.pgx_bias_pixelnorm_lrelu(
        y.data_ptr(), bb.data_ptr(), out.data_ptr(), y.numel() // c, c,
        build.dtype_code(y), float(slope), float(eps), build.stream_ptr()),
        NAME)
    build.LAUNCHES[NAME] += 1
    return out


def bias_pixelnorm_lrelu_backward_ref(y: torch.Tensor, b: torch.Tensor,
                                      g: torch.Tensor, slope: float = 0.2,
                                      eps: float = 1e-8):
    """Plain version of the backward kernel: ``(dy, db)`` of
    ``bias_pixelnorm_lrelu`` for the cotangent ``g``, in y's and b's
    dtypes, statistics and the ``db`` sum in f32 (f64 for f64)."""
    acc = stat_dtype(y.dtype)
    a = (y + b.to(y.dtype)).to(acc)
    da = rownorm_lrelu_backward(a, g.to(acc), slope, eps)
    return (da.to(y.dtype),
            da.reshape(-1, da.shape[-1]).sum(0).to(b.dtype))


def _launch_backward(y: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                     slope: float, eps: float):
    y = build.aligned(y)
    build.check_cuda_input(NAME_BWD, y)
    c = y.shape[-1]
    check_channels(NAME_BWD, c)
    if g.shape != y.shape:
        raise ValueError(f"{NAME_BWD}: cotangent shape {tuple(g.shape)} != "
                         f"{tuple(y.shape)}")
    bb = build.aligned(b.to(device=y.device, dtype=y.dtype).contiguous())
    gg = build.aligned(g.to(dtype=y.dtype).contiguous())
    rows = y.numel() // c
    lib = build.load_library()
    dy = torch.empty_like(y)
    # f32 column sums of each block of the kernel's grid (sized to the card,
    # the width and the dtype); the kernel leaves db in row 0
    blocks = lib.pgx_bias_pixelnorm_lrelu_bwd_partials(rows, c,
                                                       build.dtype_code(y))
    part = torch.empty((max(blocks, 1), c), dtype=torch.float32,
                       device=y.device)
    if rows == 0:
        part.zero_()
    build.check(lib.pgx_bias_pixelnorm_lrelu_bwd(
        y.data_ptr(), bb.data_ptr(), gg.data_ptr(), dy.data_ptr(),
        part.data_ptr(), rows, c, build.dtype_code(y), float(slope),
        float(eps), build.stream_ptr()), NAME_BWD)
    build.LAUNCHES[NAME_BWD] += 1
    return dy, part[0].to(b.dtype)


class _BiasPixelNormLrelu(torch.autograd.Function):
    """Forward: the kernel (the plain version for a CPU tensor).  Backward:
    ``_BiasPixelNormLreluGrad``, differentiable again.  Forward mode:
    ``_BiasPixelNormLreluTangent``, differentiable in reverse mode."""

    @staticmethod
    def forward(ctx, y, b, slope, eps):
        ctx.save_for_backward(y, b)
        ctx.save_for_forward(y, b)
        ctx.slope, ctx.eps = slope, eps
        if y.device.type == "cpu":
            return bias_pixelnorm_lrelu_ref(y, b, slope, eps)
        return _launch(y, b, slope, eps)

    @staticmethod
    def jvp(ctx, dy, db, _dslope, _deps):
        y, b = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        return _BiasPixelNormLreluTangent.apply(y, b, dy, db, ctx.slope,
                                                ctx.eps)

    @staticmethod
    def backward(ctx, g):
        y, b = ctx.saved_tensors
        dy, db = _BiasPixelNormLreluGrad.apply(y, b, g, ctx.slope, ctx.eps)
        return (dy if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None, None, None)


class _BiasPixelNormLreluGrad(torch.autograd.Function):
    """``(dy, db)`` for the cotangent g.  Forward: the backward kernel (the
    plain version for a CPU tensor).  Backward: ``_BiasPixelNormLreluGrad2``,
    the second derivative in closed form (the second-order kernel)."""

    @staticmethod
    def forward(ctx, y, b, g, slope, eps):
        ctx.save_for_backward(y, b, g)
        ctx.slope, ctx.eps = slope, eps
        ctx.set_materialize_grads(False)
        if y.device.type == "cpu":
            return bias_pixelnorm_lrelu_backward_ref(y, b, g, slope, eps)
        return _launch_backward(y, b, g, slope, eps)

    @staticmethod
    def backward(ctx, ddy, ddb):
        y, b, g = ctx.saved_tensors
        needs = tuple(ctx.needs_input_grad[:3])
        if (ddy is None and ddb is None) or not any(needs):
            return None, None, None, None, None
        d_y, d_b, d_g = _BiasPixelNormLreluGrad2.apply(
            y, b, g, ddy, ddb, ctx.slope, ctx.eps, needs)
        return d_y, d_b, d_g, None, None


def second_order_ref(y: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                     ddy: Optional[torch.Tensor], ddb: Optional[torch.Tensor],
                     slope: float = 0.2, eps: float = 1e-8,
                     needs=(True, True, True)):
    """Plain version of the second-order kernel: for the cotangents ``ddy``
    and ``ddb`` of A's backward outputs ``(dy, db)`` (either may be None),
    the gradients ``(d_y, d_b, d_g)`` in y's, b's and g's dtypes, each None
    where ``needs`` says so.  Statistics and the ``d_b`` sum in f32 (f64
    for f64); plain torch ops, differentiable again."""
    acc = stat_dtype(y.dtype)
    # dy and db are the same da (db summed over rows): one cotangent
    u = ddy.to(acc) if ddy is not None else torch.zeros((), dtype=acc,
                                                          device=y.device)
    if ddb is not None:
        u = u + ddb.to(acc)
    u = u.expand(y.shape)
    a = (y + b.to(y.dtype)).to(acc)
    d_a, d_g = rownorm_lrelu_backward_vjp(a, g.to(acc), u, slope, eps)
    d_y = d_a.to(y.dtype) if needs[0] else None
    d_b = (d_a.reshape(-1, d_a.shape[-1]).sum(0).to(b.dtype) if needs[1]
           else None)
    return d_y, d_b, (d_g.to(g.dtype) if needs[2] else None)


def _launch_second_order(y, b, g, ddy, ddb, slope, eps, needs):
    y = build.aligned(y)
    build.check_cuda_input(NAME_BWD2, y)
    c = y.shape[-1]
    check_channels(NAME_BWD2, c)
    for name, t, shape in (("g", g, y.shape), ("ddy", ddy, y.shape),
                           ("ddb", ddb, (c,))):
        if t is not None and t.shape != shape:
            raise ValueError(f"{NAME_BWD2}: {name} shape {tuple(t.shape)} "
                             f"!= {tuple(shape)}")
    if ddy is None and ddb is None:
        raise ValueError(f"{NAME_BWD2}: needs ddy or ddb")
    bb = build.aligned(b.to(device=y.device, dtype=y.dtype).contiguous())
    gg = build.aligned(g.to(dtype=y.dtype).contiguous())
    uy = (None if ddy is None
          else build.aligned(ddy.to(dtype=y.dtype).contiguous()))
    ub = (None if ddb is None
          else build.aligned(ddb.to(device=y.device,
                                    dtype=torch.float32).contiguous()))
    rows = y.numel() // c
    lib = build.load_library()
    d_y = torch.empty_like(y) if needs[0] else None
    d_g = torch.empty_like(y) if needs[2] else None
    part = None
    if needs[1]:
        # f32 column sums of each block; the kernel leaves d_b in row 0
        part = torch.empty(
            (max(lib.pgx_bias_pixelnorm_lrelu_bwd_blocks(rows), 1), c),
            dtype=torch.float32, device=y.device)
        if rows == 0:
            part.zero_()

    def ptr(t):
        return None if t is None else t.data_ptr()

    build.check(lib.pgx_bias_pixelnorm_lrelu_bwd2(
        y.data_ptr(), bb.data_ptr(), gg.data_ptr(), ptr(uy), ptr(ub),
        ptr(d_y), ptr(d_g), ptr(part), rows, c, build.dtype_code(y),
        float(slope), float(eps), build.stream_ptr()), NAME_BWD2)
    build.LAUNCHES[NAME_BWD2] += 1
    return (d_y, None if part is None else part[0].to(b.dtype),
            None if d_g is None else d_g.to(g.dtype))


class _BiasPixelNormLreluGrad2(torch.autograd.Function):
    """``(d_y, d_b, d_g)`` of ``_BiasPixelNormLreluGrad`` for the cotangents
    ``(ddy, ddb)``, each None where ``needs`` says so.  Forward: the
    second-order kernel (the plain version for a CPU tensor).  Backward:
    autograd through the plain closed form, recomputed from the saved
    inputs, so the chain stays differentiable to any order."""

    @staticmethod
    def forward(ctx, y, b, g, ddy, ddb, slope, eps, needs):
        ctx.save_for_backward(y, b, g, ddy, ddb)
        ctx.slope, ctx.eps, ctx.needs = slope, eps, needs
        ctx.set_materialize_grads(False)
        if y.device.type == "cpu":
            return second_order_ref(y, b, g, ddy, ddb, slope, eps, needs)
        return _launch_second_order(y, b, g, ddy, ddb, slope, eps, needs)

    @staticmethod
    def backward(ctx, gy, gb, gg):
        saved = ctx.saved_tensors
        # grad mode is on here only under create_graph=True
        create = torch.is_grad_enabled()
        wrt = [(i, t) for i, t in enumerate(saved)
               if ctx.needs_input_grad[i] and t is not None]
        with torch.enable_grad():
            outs = second_order_ref(*saved, ctx.slope, ctx.eps, ctx.needs)
        pairs = [(o, gout) for o, gout in zip(outs, (gy, gb, gg))
                 if o is not None and gout is not None and o.requires_grad]
        grads = [None] * 8
        if wrt and pairs:
            got = torch.autograd.grad(
                [o for o, _ in pairs], [t for _, t in wrt],
                [gout for _, gout in pairs], allow_unused=True,
                create_graph=create)
            for (i, _), d in zip(wrt, got):
                grads[i] = d
        return tuple(grads)


def bias_pixelnorm_lrelu_jvp_ref(y: torch.Tensor, b: torch.Tensor,
                                 dy: torch.Tensor,
                                 db: Optional[torch.Tensor] = None,
                                 slope: float = 0.2,
                                 eps: float = 1e-8) -> torch.Tensor:
    """Plain version of the tangent kernel: pgx's ``_jvp_rule``, the
    tangent of ``bias_pixelnorm_lrelu`` for the tangents ``dy`` and ``db``
    (None: no bias tangent), in y's dtype.  Both sums in y's dtype, the
    statistics in f32 (f64 for f64); plain torch ops, differentiable."""
    acc = stat_dtype(y.dtype)
    inv_c = 1.0 / y.shape[-1]
    a = (y + b.to(y.dtype)).to(acc)
    da = (dy.to(y.dtype) if db is None
          else dy.to(y.dtype) + db.to(y.dtype)).to(acc)
    r = torch.rsqrt(torch.sum(a * a, dim=-1, keepdim=True) * inv_c + eps)
    m = torch.sum(a * da, dim=-1, keepdim=True) * inv_c
    dpn = da * r - a * (r * r * r) * m
    return torch.where(a >= 0, dpn, dpn * slope).to(y.dtype)


def _launch_jvp(y, b, dy, db, slope, eps):
    y = build.aligned(y)
    build.check_cuda_input(NAME_JVP, y)
    c = y.shape[-1]
    check_channels(NAME_JVP, c)
    if dy.shape != y.shape:
        raise ValueError(f"{NAME_JVP}: tangent shape {tuple(dy.shape)} != "
                         f"{tuple(y.shape)}")
    bb = build.aligned(b.to(device=y.device, dtype=y.dtype).contiguous())
    dd = build.aligned(dy.to(dtype=y.dtype).contiguous())
    tb = (None if db is None else build.aligned(
        db.to(device=y.device, dtype=y.dtype).contiguous()))
    out = torch.empty_like(y)
    lib = build.load_library()
    build.check(lib.pgx_bias_pixelnorm_lrelu_jvp(
        y.data_ptr(), bb.data_ptr(), dd.data_ptr(),
        None if tb is None else tb.data_ptr(), out.data_ptr(),
        y.numel() // c, c, build.dtype_code(y), float(slope), float(eps),
        build.stream_ptr()), NAME_JVP)
    build.LAUNCHES[NAME_JVP] += 1
    return out


class _BiasPixelNormLreluTangent(torch.autograd.Function):
    """The tangent of A, ``J(y, b) (dy, db)``, in y's dtype (``db`` may be
    None).  Forward: the tangent kernel (the plain version for a CPU
    tensor).  Backward, for the cotangent c: the gradients in ``(dy, db)``
    are A's VJP ``J^T c`` (``_BiasPixelNormLreluGrad``: the backward
    kernel), those in ``(y, b)`` A's second derivative with ``g = c`` and
    ``(ddy, ddb) = (dy, db)`` (``_BiasPixelNormLreluGrad2``: the
    second-order kernel)."""

    @staticmethod
    def forward(ctx, y, b, dy, db, slope, eps):
        ctx.save_for_backward(y, b, dy, db)
        ctx.slope, ctx.eps = slope, eps
        if y.device.type == "cpu":
            return bias_pixelnorm_lrelu_jvp_ref(y, b, dy, db, slope, eps)
        return _launch_jvp(y, b, dy, db, slope, eps)

    @staticmethod
    def backward(ctx, c):
        y, b, dy, db = ctx.saved_tensors
        need_y, need_b, need_dy, need_db = ctx.needs_input_grad[:4]
        g_y = g_b = g_dy = g_db = None
        if need_dy or (need_db and db is not None):
            t_y, t_b = _BiasPixelNormLreluGrad.apply(y, b, c, ctx.slope,
                                                     ctx.eps)
            g_dy = t_y.to(dy.dtype) if need_dy else None
            g_db = (t_b.to(db.dtype) if need_db and db is not None
                    else None)
        if need_y or need_b:
            g_y, g_b, _ = _BiasPixelNormLreluGrad2.apply(
                y, b, c, dy, db, ctx.slope, ctx.eps, (need_y, need_b, False))
        return g_y, g_b, g_dy, g_db, None, None


def bias_pixelnorm_lrelu_tangent(y: torch.Tensor, b: torch.Tensor,
                                 dy: torch.Tensor,
                                 db: Optional[torch.Tensor] = None,
                                 slope: float = 0.2,
                                 eps: float = 1e-8) -> torch.Tensor:
    """The tangent of ``bias_pixelnorm_lrelu`` at ``(y, b)`` for the
    tangents ``dy`` and ``db`` (None: no bias tangent), as a plain tensor
    differentiable in reverse mode: the tangent kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    return _BiasPixelNormLreluTangent.apply(y, b, dy, db, slope, eps)


def bias_pixelnorm_lrelu(y: torch.Tensor, b: torch.Tensor,
                         slope: float = 0.2,
                         eps: float = 1e-8) -> torch.Tensor:
    """``lrelu(pixel_norm(y + b), slope)`` over the last axis of NHWC ``y``,
    differentiable to second order in ``y`` and ``b``, and in forward mode
    (the tangent differentiable in reverse mode).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes float32/bfloat16, contiguous, with C a multiple of 8 and at
    most 512 (``supported``); a view whose pointer is not 16-byte aligned is
    copied first."""
    if b.shape != (y.shape[-1],):
        raise ValueError(f"{NAME}: bias shape {tuple(b.shape)} != "
                         f"({y.shape[-1]},)")
    return _BiasPixelNormLrelu.apply(y, b, slope, eps)
