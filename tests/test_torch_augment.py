"""pgx_torch's ADA pipeline and controller against pgx on the CPU.

Both pipes see the same random numbers: the port's pipe takes a draw
source, and ``JaxDraws`` hands out ``jax.random.uniform/normal(next(keys),
shape, float32)`` from ``jax.random.split(key, 48)``, exactly what pgx's
``rand``/``randn`` consume in call order.

Tolerance: 3e-5 absolute on images in [-1, 1], in f32 and in f64 alike.
The transform matrices (``G_inv``, the color matrix, the tent matrices)
are f32 in both packages whatever the image type, and ``cos``, ``sin``,
``exp2`` and 3x3 products differ in their last f32 bit between XLA's CPU
code and torch's; measured errors are below 1e-5.  A ``floor`` or ``round``
that turned such a bit into a whole-pixel difference would show as an error
of order 0.1.  Pure color, noise and cutout transforms agree to 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx.augment import adaptive as jada
from pgx.augment import pipe as jpipe
from pgx_torch.augment import adaptive as tada
from pgx_torch.augment import pipe as tpipe

ATOL = 3e-5


class JaxDraws:
    """pgx's own draws, in pgx's order: key i of ``split(key, 48)`` serves
    the i-th call."""

    def __init__(self, key):
        self.keys = iter(jax.random.split(key, 48))
        self.calls = []

    def _draw(self, fn, shape):
        self.calls.append((fn.__name__, tuple(shape)))
        return torch.from_numpy(np.array(fn(next(self.keys), tuple(shape),
                                            jnp.float32)))

    def uniform(self, shape):
        return self._draw(jax.random.uniform, shape)

    def normal(self, shape):
        return self._draw(jax.random.normal, shape)


def _images(b=4, h=16, w=16, c=3, seed=0, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return np.tanh(rng.randn(b, h, w, c)).astype(dtype)


def _both(kw, x, p=0.9, dp=None, seed=0):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jpipe.augment_pipe(
        key, jnp.asarray(x), jpipe.AugmentConfig(**kw), p,
        debug_percentile=dp))
    draws = JaxDraws(key)
    got = tpipe.augment_pipe(draws, torch.from_numpy(x),
                             tpipe.AugmentConfig(**kw), p,
                             debug_percentile=dp)
    assert got.shape == want.shape and got.is_contiguous()
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    return got.numpy(), want, draws


BGC = {k: v for k, v in dataclasses.asdict(jpipe.bgc_config()).items()
       if k != "warp_impl"}
GEOM = ["xflip", "rotate90", "xint", "scale", "rotate", "aniso", "xfrac"]
COLOR = ["brightness", "contrast", "lumaflip", "hue", "saturation"]


def test_configs_match_pgx():
    assert (dataclasses.asdict(tpipe.AugmentConfig())
            == dataclasses.asdict(jpipe.AugmentConfig()))
    assert (dataclasses.asdict(tpipe.bgc_config(noise=0.5))
            == dataclasses.asdict(jpipe.bgc_config(noise=0.5)))
    assert tpipe.WAVELETS == jpipe.WAVELETS
    np.testing.assert_array_equal(tpipe._hz_geom(), jpipe._hz_geom())
    np.testing.assert_array_equal(tpipe._filter_bank(), jpipe._filter_bank())
    assert (dataclasses.asdict(tada.AdaConfig())
            == dataclasses.asdict(jada.AdaConfig()))


@pytest.mark.parametrize("impl", ["shear", "gather"])
@pytest.mark.parametrize("name", GEOM)
def test_geometric_transform_matches_pgx(name, impl):
    x = _images(seed=len(name))
    for dp in (None, 0.3, 0.8):
        got, want, _ = _both({name: 1, "warp_impl": impl}, x, dp=dp)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=f"{name} {impl} dp={dp}")
    assert np.abs(want - x).max() > 1e-3       # the transform did something


@pytest.mark.parametrize("name", COLOR + ["noise", "cutout"])
def test_color_and_corruption_transform_matches_pgx(name):
    x = _images(seed=len(name) + 7)
    for dp in (None, 0.3):
        got, want, _ = _both({name: 1}, x, dp=dp)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0,
                                   err_msg=f"{name} dp={dp}")


@pytest.mark.parametrize("dp", [None, 0.6])
def test_imgfilter_matches_pgx(dp):
    x = _images(b=2, h=32, w=32, seed=3)
    got, want, _ = _both({"imgfilter": 1}, x, dp=dp)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    got, want, _ = _both({"imgfilter": 1,
                          "imgfilter_bands": (1.0, 0.0, 0.5, 1.0)}, x, dp=dp)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dp", [None, 0.6])
@pytest.mark.parametrize("size", [4, 8, 16])
def test_imgfilter_below_its_pad_matches_pgx(size, dp):
    """Images smaller than the filter bank's pad of 21: the pad reflects
    again and again, as pgx's ``jnp.pad(..., mode="reflect")`` does."""
    x = _images(b=2, h=size, w=size, seed=size)
    got, want, _ = _both({"imgfilter": 1}, x, p=1.0, dp=dp)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", range(1, 41))
def test_reflect_index_matches_numpy_pad(n):
    """The folded index against numpy's reflect pad, pads 1 to 21."""
    axis = np.arange(n)
    for pad in range(1, 22):
        got = tpipe._reflect_index(n, pad, "cpu").numpy()
        np.testing.assert_array_equal(got, np.pad(axis, pad, mode="reflect"),
                                      err_msg=f"pad {pad}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("impl", ["shear", "gather"])
def test_bgc_policy_matches_pgx(impl, dtype):
    """The production policy, stochastic, three keys, f32 and f64 images
    (f32 matrices in both)."""
    for seed in range(3):
        x = _images(seed=seed, dtype=dtype)
        got, want, draws = _both(dict(BGC, warp_impl=impl), x, p=0.8,
                                 seed=seed)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # 13 transforms (rotate twice), a value and a gate each
    assert len(draws.calls) == 26
    assert draws.calls[:4] == [("uniform", (4,)), ("uniform", (4,)),
                               ("uniform", (4,)), ("uniform", (4,))]


@pytest.mark.parametrize("impl", ["shear", "gather"])
def test_all_transforms_match_pgx(impl):
    kw = dict(BGC, imgfilter=1, noise=1, cutout=1, warp_impl=impl)
    x = _images(b=2, h=32, w=32, seed=5)
    got, want, draws = _both(kw, x, p=1.0, seed=9)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert len(draws.calls) == 26 + 8 + 3 + 2 <= 48
    got, want, _ = _both(kw, x, p=1.0, dp=0.7)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["shear", "gather"])
def test_grayscale_matches_pgx(impl):
    x = _images(c=1, seed=6)
    got, want, draws = _both(dict(BGC, warp_impl=impl), x, seed=2)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert len(draws.calls) == 22          # hue and saturation are skipped
    with pytest.raises(ValueError, match="RGB or grayscale"):
        tpipe.augment_pipe(JaxDraws(jax.random.PRNGKey(0)),
                           torch.zeros(1, 8, 8, 2), tpipe.bgc_config(), 1.0)


def test_non_square_falls_back_to_gather():
    x = _images(h=12, w=16, seed=7)
    shear, want, _ = _both(dict(BGC, warp_impl="shear"), x, seed=4)
    gather, _, _ = _both(dict(BGC, warp_impl="gather"), x, seed=4)
    np.testing.assert_allclose(shear, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(shear, gather)


def test_p_zero_and_p_tensor():
    """p = 0 gates every transform to its identity (the warp still runs);
    p may be a 0-d tensor, as the train step passes it."""
    x = _images(seed=8)
    got, want, _ = _both(dict(BGC), x, p=0.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, x, atol=1e-4, rtol=0)
    key = jax.random.PRNGKey(3)
    a = tpipe.augment_pipe(JaxDraws(key), torch.from_numpy(x),
                           tpipe.bgc_config(), 0.7)
    b = tpipe.augment_pipe(JaxDraws(key), torch.from_numpy(x),
                           tpipe.bgc_config(), torch.tensor(0.7))
    assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["shear", "gather"])
def test_pipe_gradient_matches_pgx(impl):
    """The G step differentiates through the pipe once."""
    x = _images(b=2, seed=9, dtype=np.float64)
    key = jax.random.PRNGKey(5)
    ct = np.random.RandomState(1).randn(*x.shape)
    jc = jpipe.bgc_config(warp_impl=impl)
    _, vjp = jax.vjp(lambda v: jpipe.augment_pipe(key, v, jc, 0.9),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tpipe.augment_pipe(JaxDraws(key), tx,
                             tpipe.bgc_config(warp_impl=impl), 0.9)
    got, = torch.autograd.grad(out, tx, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_torch_draws_are_seeded_and_fresh():
    x = torch.from_numpy(_images(seed=10))
    cfg = tpipe.bgc_config(noise=1)
    outs = []
    for seed in (0, 0, 1):
        g = torch.Generator().manual_seed(seed)
        d = tpipe.TorchDraws(g)
        first = tpipe.augment_pipe(d, x, cfg, 1.0)
        outs.append((first, tpipe.augment_pipe(d, x, cfg, 1.0)))
        assert d.uniform((3, 1)).dtype == torch.float32
        assert d.normal((2,)).shape == (2,)
    assert torch.equal(outs[0][0], outs[1][0])            # same seed
    assert not torch.equal(outs[0][0], outs[2][0])        # another seed
    assert not torch.equal(outs[0][0], outs[0][1])        # the stream moves
    assert all(torch.isfinite(o).all() for pair in outs for o in pair)


def test_bf16_images_leave_the_color_stage_as_f32():
    """jnp promotes the f32 color matrix times a bf16 image to f32; so
    does the port.  Geometry alone keeps bf16."""
    x = torch.from_numpy(_images(seed=11)).to(torch.bfloat16)
    key = jax.random.PRNGKey(1)
    geo = tpipe.augment_pipe(JaxDraws(key), x,
                             tpipe.AugmentConfig(xflip=1, rotate=1), 1.0)
    assert geo.dtype == torch.bfloat16
    want = jpipe.augment_pipe(key, jnp.asarray(_images(seed=11),
                                               jnp.bfloat16),
                              jpipe.bgc_config(), 1.0)
    got = tpipe.augment_pipe(JaxDraws(key), x, tpipe.bgc_config(), 1.0)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32


# ---------------------------------------------------------------------------
# the adaptive controller
# ---------------------------------------------------------------------------

def _ada_equal(t, j):
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].dtype == torch.float32 and t[k].ndim == 0
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("bias,prev_p", [(0.8, 0.0), (-0.5, 0.3),
                                         (3.0, 0.9999)])
def test_ada_update_matches_pgx_over_triggers(bias, prev_p):
    """Ten batches of 8: the update triggers on the 4th and the 8th; p
    rises when most real logits are positive, falls otherwise, and stays
    clamped to [0, 1]."""
    jcfg = jada.AdaConfig(ada_length=1000)
    tcfg = tada.AdaConfig(ada_length=1000)
    js = jada.init_ada_state(prev_p)
    ts = tada.init_ada_state(prev_p, device="cpu")
    _ada_equal(ts, js)
    rng = np.random.RandomState(0)
    ps = []
    for _ in range(10):
        logits = (rng.randn(8) + bias).astype(np.float32)
        js = jada.ada_update(js, jnp.asarray(logits), jcfg, 8)
        ts = tada.ada_update(ts, torch.from_numpy(logits), tcfg, 8)
        _ada_equal(ts, js)
        ps.append(float(ts["p"]))
    assert ps[2] == np.float32(prev_p) and ps[3] != ps[2]
    assert ps[7] != ps[6] or ps[7] == 1.0          # clamped at the top
    assert float(ts["count"]) == 16.0
    assert 0.0 <= min(ps) and max(ps) <= 1.0
    assert (ps[-1] > prev_p) == (bias > 0.5) or ps[-1] in (0.0, 1.0)


def test_ada_state_stays_on_the_requested_device():
    """The controller's state is made on the card unless the CPU is asked
    for, as every entry point of the port; an update keeps every leaf where
    the state was made and refuses logits from another device."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tada.init_ada_state()
    state = tada.init_ada_state(0.25, device="cpu")
    cfg = tada.AdaConfig(ada_length=1000)
    for _ in range(5):                  # the update triggers on the 4th
        state = tada.ada_update(state, torch.ones(8), cfg, 8)
        assert all(v.device.type == "cpu" and v.dtype == torch.float32
                   for v in state.values())
    assert float(state["p"]) > 0.25 and float(state["count"]) == 8.0
    elsewhere = {k: torch.zeros((), device="meta") for k in state}
    with pytest.raises(ValueError, match="is on meta"):
        tada.ada_update(elsewhere, torch.ones(8), cfg, 8)
