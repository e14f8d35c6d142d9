"""The kernels' ``torch.library`` ops (``torch.ops.pgx_torch.*``) on the CPU.

Every C entry of the kernel library is one op (``build.define_op``): the
kernel's launch for CUDA tensors, the plain version for CPU tensors, a fake
implementation for tracing.  Here: each op is registered with all three; on
the CPU each equals its plain version bit for bit (it is the same
function); ``torch.library.opcheck`` passes its schema and fake-tensor
tests for each op at a small shape (C's ``r``, A's backward's ``db`` and the
second derivative's empty outputs included); no kernel launch, pointer or
launch count sits outside an op's CUDA implementation; and the
``autograd.Function``s around the ops differentiate as before (gradcheck in
float64, A also to second order and in forward mode).
"""

import ast
import importlib
import os

import numpy as np
import pytest
import torch

from pgx_torch.ops.kernels import build

# the modules (some packages export functions of the same names)
A, B, C, D, E, F, W = (
    importlib.import_module(f"pgx_torch.ops.kernels.{m}")
    for m in ("epilogue", "pixel_norm_lrelu", "conv_epilogue", "upfirdn2d",
              "bias_act", "shear", "warp_resample"))

KERNELS = os.path.join(os.path.dirname(__file__), "..", "pgx_torch", "ops",
                       "kernels")
# module, entry and its _launch function: where each op lives
OPS = {"bias_pixelnorm_lrelu": (A, "forward_op"),
       "bias_pixelnorm_lrelu_bwd": (A, "backward_op"),
       "bias_pixelnorm_lrelu_bwd2": (A, "second_order_op"),
       "bias_pixelnorm_lrelu_jvp": (A, "tangent_op"),
       "pixel_norm_lrelu": (B, "op"),
       "conv3x3_epilogue": (C, "op"),
       "conv3x3_epilogue_r": (C, "op_r"),
       "shift_1d": (F, "op"),
       "upfirdn2d": (D, "op"),
       "bias_act": (E, "op"),
       "warp_resample": (W, "op"),
       "warp_resample_t": (W, "transpose_op"),
       "warp_down2": (W, "down_op"),
       "warp_down2_t": (W, "down_transpose_op")}


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.randn(*shape)).to(dtype)


def _cases(dtype=torch.float32):
    """(op name, args, the plain version's result) at small shapes."""
    rng = np.random.RandomState(0)
    y, g, u = (_t(rng, 2, 3, 3, 16, dtype=dtype) for _ in range(3))
    b, ub = (_t(rng, 16, dtype=dtype) for _ in range(2))
    x = _t(rng, 2, 5, 5, 8, dtype=dtype)
    w = _t(rng, 3, 3, 8, 16, dtype=dtype) * 0.2
    img = _t(rng, 2, 3, 6, 10, dtype=dtype)
    taps = [0.125, 0.375, 0.375, 0.125]
    # kernel W: a 5px image, its 2x grid (64 x 128), the sym6-length filter
    sq = _t(rng, 2, 5, 5, 3, dtype=dtype)
    params = torch.tensor([[0.0, 1.0, 1.0, 0.3, -0.2],
                           [1.0, -0.8, 1.2, 2.0, -1.0]])
    grid = _t(rng, 2, 3, 64, 128, dtype=dtype)
    crop = _t(rng, 2, 3, 22, 22, dtype=dtype)
    hz = list(np.linspace(0.02, 0.15, 12))
    return [
        ("bias_pixelnorm_lrelu", (y, b, 0.2, 1e-8),
         lambda: A.bias_pixelnorm_lrelu_ref(y, b, 0.2, 1e-8)),
        ("bias_pixelnorm_lrelu_bwd", (y, b, g, 0.2, 1e-8),
         lambda: A.bias_pixelnorm_lrelu_backward_ref(y, b, g, 0.2, 1e-8)),
        ("bias_pixelnorm_lrelu_bwd2",
         (y, b, g, u, ub, 0.2, 1e-8, (True, True, True)),
         lambda: A.second_order_ref(y, b, g, u, ub, 0.2, 1e-8)),
        ("bias_pixelnorm_lrelu_bwd2",
         (y, b, g, None, ub, 0.2, 1e-8, (True, False, True)),
         lambda: A.second_order_ref(y, b, g, None, ub, 0.2, 1e-8,
                                    (True, False, True))),
        ("bias_pixelnorm_lrelu_jvp", (y, b, u, ub, 0.2, 1e-8),
         lambda: A.bias_pixelnorm_lrelu_jvp_ref(y, b, u, ub, 0.2, 1e-8)),
        ("bias_pixelnorm_lrelu_jvp", (y, b, u, None, 0.2, 1e-8),
         lambda: A.bias_pixelnorm_lrelu_jvp_ref(y, b, u, None, 0.2, 1e-8)),
        ("pixel_norm_lrelu", (y, 0.2, 1e-8),
         lambda: B.pixel_norm_lrelu_ref(y, 0.2, 1e-8)),
        ("conv3x3_epilogue", (x, w, b, True, 0.2, 1e-8),
         lambda: C.conv3x3_epilogue_ref(x, w, b)),
        ("conv3x3_epilogue", (x, w, b, False, 0.2, 1e-8),
         lambda: C.conv3x3_epilogue_ref(x, w, b, use_pixel_norm=False)),
        ("conv3x3_epilogue_r", (x, w, b, 0.2, 1e-8),
         lambda: C.conv3x3_epilogue_ref(x, w, b, return_r=True)),
        ("shift_1d", (img, _t(rng, 2, 6) * 3, 3),
         None),
        ("shift_1d", (img, _t(rng, 2, 10) * 3, 2),
         None),
        ("upfirdn2d", (x, taps, 2, 1, (2, 1, 2, 1), False),
         lambda: D.upfirdn2d_ref(x, taps, 2, 1, (2, 1, 2, 1), False)),
        ("upfirdn2d", (x, taps, 1, 2, (1, 1, 1, 1), True),
         lambda: D.upfirdn2d_ref(x, taps, 1, 2, (1, 1, 1, 1), True)),
        ("bias_act", (y, b, "lrelu", 0.2, 2 ** 0.5, 1.5),
         lambda: E.bias_act_ref(y, b, -1, "lrelu", 0.2, 2 ** 0.5, 1.5)),
        ("bias_act", (y, None, "linear", 0.0, 1.0, -1.0),
         lambda: E.bias_act_ref(y, None, -1, "linear", 0.0, 1.0, None)),
        ("warp_resample", (sq, params, 64, 128, hz),
         lambda: W.warp_resample_ref(sq, params, 64, 128, hz)),
        ("warp_resample_t", (grid, params, 5, hz),
         lambda: W.warp_resample_t_ref(grid, params, 5, hz)),
        ("warp_down2", (crop, hz), lambda: W.warp_down2_ref(crop, hz)),
        ("warp_down2_t", (sq, hz), lambda: W.warp_down2_t_ref(sq, hz)),
    ]


def _op(name):
    return getattr(torch.ops.pgx_torch, name).default


def test_every_kernel_entry_is_one_registered_op():
    assert set(OPS) == set(build.LAUNCHES)
    for name, (module, attr) in OPS.items():
        qual = f"{build.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), (
                qual, key)
        assert getattr(module, attr) is _op(name)


@pytest.mark.parametrize("case", range(len(_cases())))
def test_op_on_the_cpu_is_its_plain_version(case):
    name, args, plain = _cases()[case]
    before = build.launch_counts()
    got = _op(name)(*args)
    assert build.launch_counts() == before       # no launch on the CPU
    if plain is None:           # F: the plain version checks its shapes
        plain = lambda: F.shift_1d_ref(*args)
    want = plain()
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:           # left out by ``needs``: empty
            assert g.numel() == 0
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", range(len(_cases())))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_opcheck_schema_and_fake_tensors(case, dtype):
    name, args, _ = _cases(dtype)[case]
    torch.library.opcheck(_op(name), args,
                          test_utils=("test_schema", "test_faketensor"))


def test_an_identity_op_returns_no_alias_of_its_input():
    x = torch.randn(2, 4, 8)
    out = _op("bias_act")(x, None, "linear", 0.0, 1.0, -1.0)
    assert torch.equal(out, x)
    assert out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()


def _loads(tree, prefix):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Name)
            and n.id.startswith(prefix)]


@pytest.mark.parametrize("path", sorted(
    n for n in os.listdir(KERNELS) if n.endswith(".py")
    and n not in ("__init__.py", "build.py")))
def test_launches_only_inside_the_ops_cuda_implementations(path):
    """Pointers, the C library and the launch count appear only in the
    ``_launch*`` functions, and those are reached only from the ``cuda=``
    implementation of a ``define_op`` call."""
    with open(os.path.join(KERNELS, path)) as f:
        tree = ast.parse(f.read())
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        text = ast.unparse(fn)
        if any(s in text for s in ("data_ptr", "LAUNCHES", "load_library",
                                   "_library()", "build.check(")):
            assert fn.name.startswith("_launch") or fn.name == "_library", (
                path, fn.name)
    inside = set()
    for call in (n for n in ast.walk(tree) if isinstance(n, ast.Call)
                 and ast.unparse(n.func) == "build.define_op"):
        for kw in call.keywords:
            if kw.arg == "cuda":
                inside |= {id(n) for n in _loads(kw.value, "_launch")}
    uses = _loads(tree, "_launch")
    if path == "upfirdn2d.py":      # _launch_args: the plan's cache
        uses = [n for n in uses if n.id != "_launch_args"]
    assert uses and all(id(n) in inside for n in uses), path


# ---------------------------------------------------------------------------
# The Functions around the ops differentiate as before (float64)
# ---------------------------------------------------------------------------

def _f64(rng, *shape, scale=1.0):
    return (torch.from_numpy(rng.randn(*shape)) * scale).requires_grad_(True)


def test_a_differentiates_twice_and_in_forward_mode():
    rng = np.random.RandomState(1)
    y, b = _f64(rng, 2, 2, 2, 8), _f64(rng, 8, scale=0.3)
    fn = lambda y, b: A.bias_pixelnorm_lrelu(y, b)
    assert torch.autograd.gradcheck(fn, (y, b))
    assert torch.autograd.gradgradcheck(fn, (y, b))
    assert torch.autograd.gradcheck(fn, (y, b), check_forward_ad=True,
                                    check_backward_ad=False)


def test_b_c_d_e_f_differentiate():
    rng = np.random.RandomState(2)
    x = _f64(rng, 1, 2, 2, 8)
    assert torch.autograd.gradcheck(
        lambda x: B.pixel_norm_lrelu(x), (x,))
    xc, w, b = (_f64(rng, 1, 3, 3, 8), _f64(rng, 3, 3, 8, 8, scale=0.2),
                _f64(rng, 8, scale=0.3))
    assert torch.autograd.gradcheck(
        lambda x, w, b: C.conv3x3_epilogue(x, w, b), (xc, w, b))
    xd = _f64(rng, 1, 4, 4, 2)
    assert torch.autograd.gradgradcheck(
        lambda x: D.upfirdn2d_separable(x, [0.25, 0.5, 0.25], up=2,
                                        pads=(1, 1, 1, 1)), (xd,))
    xe, be = _f64(rng, 2, 3, 4), _f64(rng, 4)
    assert torch.autograd.gradgradcheck(
        lambda x, b: E.bias_act_channel_last(x, b, "swish", 0.0, 1.0, 2.0),
        (xe, be))
    img = _f64(rng, 1, 2, 3, 5)
    shift = torch.from_numpy(rng.randn(1, 3) * 2)
    assert torch.autograd.gradgradcheck(
        lambda im: F.shift_1d(im, shift, 3), (img,))
