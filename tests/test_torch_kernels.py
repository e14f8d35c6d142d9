"""pgx_torch's kernels A/B/C against pgx's Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions, which are held
against pgx's Pallas kernels run in interpret mode (as pgx's own tests run
them) on the same numpy inputs, in f32.  Tolerance: atol/rtol 1e-5 — the
same f32 arithmetic summed in another order.  Where pgx's conv kernel gates
a shape out (W below its sublane tile, e.g. the 4x4 stage) the plain version
is held against pgx's XLA reference ``conv3x3_epilogue_ref`` instead.

The ``gpu`` cases hold each CUDA kernel against its plain version on the
card; they skip without one.  JAX is imported inside the fixtures, so the
file also runs where only torch is installed:
``python -m pytest --noconftest -m gpu tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from pgx_torch.ops import kernels as K

ATOL = RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """pgx's Pallas modules with every pallas_call in interpreter mode
    (the pattern of tests/test_pallas_kernels.py)."""
    pytest.importorskip("jax")
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    from pgx.ops.pallas import conv_epilogue, epilogue, kernels
    for mod in (conv_epilogue, epilogue, kernels):
        monkeypatch.setattr(mod.pl, "pallas_call", patched)
    return {"epilogue": epilogue, "kernels": kernels,
            "conv_epilogue": conv_epilogue}


@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (2, 8, 8, 256),
                                   (1, 4, 4, 512)])
def test_bias_pixelnorm_lrelu_matches_pallas(pallas_interpret, shape):
    import jax.numpy as jnp
    E = pallas_interpret["epilogue"]
    y, b = _rand(shape, 1), _rand(shape[-1:], 2)
    assert E.supported(jnp.asarray(y))
    want = np.asarray(E.bias_pixelnorm_lrelu(jnp.asarray(y), jnp.asarray(b),
                                             0.2))
    got = K.bias_pixelnorm_lrelu(torch.from_numpy(y), torch.from_numpy(b),
                                 0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,slope", [((2, 4, 4, 128), 0.2),
                                         ((3, 4, 4, 256), 0.1),
                                         ((2, 8, 8, 128), 0.2)])
def test_pixel_norm_lrelu_matches_pallas(pallas_interpret, shape, slope):
    import jax.numpy as jnp
    Kp = pallas_interpret["kernels"]
    x = _rand(shape, 3)
    want = np.asarray(Kp.pixel_norm_lrelu_pallas(jnp.asarray(x), slope))
    got = K.pixel_norm_lrelu(torch.from_numpy(x), slope)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,cout,pn", [
    ((2, 8, 8, 128), 128, True),
    ((1, 8, 8, 128), 256, True),
    ((2, 8, 16, 256), 128, False),
])
def test_conv3x3_epilogue_matches_pallas(pallas_interpret, shape, cout, pn):
    import jax.numpy as jnp
    C = pallas_interpret["conv_epilogue"]
    x = _rand(shape, 4)
    w = _rand((3, 3, shape[-1], cout), 5, np.sqrt(2.0 / (9 * shape[-1])))
    b = _rand((cout,), 6, 0.1)
    assert C.supported(jnp.asarray(x), jnp.asarray(w))
    want = np.asarray(C.conv3x3_epilogue_fwd(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), use_pixel_norm=pn,
        interpret=True))
    got = K.conv3x3_epilogue(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), use_pixel_norm=pn)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,cout,pn", [
    ((2, 4, 4, 128), 128, True),      # the 4x4 stage: below pgx's W gate
    ((2, 4, 4, 256), 128, False),
    ((1, 5, 3, 24), 40, True),        # C a multiple of 8, not of 128
])
def test_conv3x3_epilogue_matches_xla_ref(pallas_interpret, shape, cout, pn):
    import jax.numpy as jnp
    C = pallas_interpret["conv_epilogue"]
    x = _rand(shape, 7)
    w = _rand((3, 3, shape[-1], cout), 8, np.sqrt(2.0 / (9 * shape[-1])))
    b = _rand((cout,), 9, 0.1)
    want = np.asarray(C.conv3x3_epilogue_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), use_pixel_norm=pn))
    got = K.conv3x3_epilogue(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), use_pixel_norm=pn)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_wrappers_refuse_autograd():
    x = torch.zeros(1, 4, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.pixel_norm_lrelu(x)
    with pytest.raises(RuntimeError, match="forward-only"):
        K.bias_pixelnorm_lrelu(x, torch.zeros(8))
    with pytest.raises(RuntimeError, match="forward-only"):
        K.conv3x3_epilogue(x, torch.zeros(3, 3, 8, 8), torch.zeros(8))
    with torch.no_grad():
        assert K.pixel_norm_lrelu(x).shape == x.shape


def test_cpu_calls_do_not_count_launches():
    before = K.launch_counts()
    with torch.no_grad():
        K.pixel_norm_lrelu(torch.ones(1, 4, 4, 8))
    assert K.launch_counts() == before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

# bf16 tolerance: the kernel rounds once, the plain version after the conv,
# the bias and the norm; outputs are O(1..8), where a bf16 step is <= 2^-5
GPU_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.07}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(arr, dev, dtype):
    return torch.from_numpy(arr).to(dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4, 4, 512), (2, 64, 64, 256),
                                   (2, 17, 3, 40)])
def test_gpu_rownorm_kernels_match_plain(cuda, dtype, shape):
    y, b = _on(_rand(shape, 1), cuda, dtype), _on(_rand(shape[-1:], 2),
                                                   cuda, torch.float32)
    with torch.no_grad():
        got = K.bias_pixelnorm_lrelu(y, b)
        want = K.bias_pixelnorm_lrelu_ref(y, b)
        got_b = K.pixel_norm_lrelu(y, 0.1)
        want_b = K.pixel_norm_lrelu_ref(y, 0.1)
    torch.cuda.synchronize()
    tol = GPU_TOL[dtype]
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert (got_b.float() - want_b.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cout,pn", [
    ((4, 4, 4, 512), 512, True), ((2, 16, 16, 512), 512, True),
    ((2, 64, 64, 256), 256, True), ((1, 128, 128, 128), 128, True),
    ((3, 5, 7, 24), 40, False), ((1, 4, 4, 8), 8, True)])
def test_gpu_conv3x3_epilogue_matches_plain(cuda, dtype, shape, cout, pn):
    x = _on(_rand(shape, 4), cuda, dtype)
    w = _on(_rand((3, 3, shape[-1], cout), 5,
                  np.sqrt(2.0 / (9 * shape[-1]))), cuda, torch.float32)
    b = _on(_rand((cout,), 6, 0.1), cuda, torch.float32)
    with torch.no_grad():
        got = K.conv3x3_epilogue(x, w, b, use_pixel_norm=pn)
        want = K.conv3x3_epilogue_ref(x, w, b, use_pixel_norm=pn)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= GPU_TOL[dtype]


@pytest.mark.gpu
def test_gpu_wrappers_reject_bad_inputs(cuda):
    with torch.no_grad():
        with pytest.raises(ValueError, match="multiple of 8"):
            K.pixel_norm_lrelu(torch.zeros(1, 4, 4, 12, device=cuda))
        with pytest.raises(ValueError, match="contiguous"):
            K.pixel_norm_lrelu(
                torch.zeros(1, 8, 4, 4, device=cuda).permute(0, 2, 3, 1))
        with pytest.raises(TypeError):
            K.pixel_norm_lrelu(torch.zeros(1, 4, 4, 8, device=cuda,
                                           dtype=torch.float16))
        with pytest.raises(ValueError, match="C_out"):
            K.conv3x3_epilogue(torch.zeros(1, 4, 4, 8, device=cuda),
                               torch.zeros(3, 3, 8, 520, device=cuda),
                               torch.zeros(520, device=cuda))
