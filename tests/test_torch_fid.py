"""pgx_torch.eval.fid against pgx.eval.fid on the CPU, and its card cases.

The preprocessing is compared byte for byte and float for float with pgx's
PIL chain (uint8, float32 and float64 NHWC, NCHW float items, grey); the
torch integer-op resize (the path a CUDA device takes) with the numpy one
(``_resize_batch``), here on CPU tensors.  The Frechet distance runs the
same numpy/scipy code as pgx's: 1e-12 relative, the singular fallback
included.  ``calculate_fid_given_data`` against pgx's with one random
weights file, the features cut to their first 64 of 2048 dimensions in
both packages (a 2048 x 2048 ``sqrtm`` takes ~12 s on a CPU): the two
packages' f32 convolutions sum in other orders, so the features differ by
~1e-6 relative; the bound is pgx's own between its JAX and torch stacks,
1e-3.

The ``gpu`` cases skip without a card; on the card they run without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_fid.py
"""

import os

import numpy as np
import pytest
import torch

from pgx_torch.data.datasets import _resize_batch
from pgx_torch.eval import fid as tfid
from pgx_torch.eval import inception as tinc

try:                                   # the card machine has no JAX
    import jax

    from pgx.eval import fid as jfid
    from pgx.eval import inception as jinc
except ImportError:                    # pragma: no cover
    jax = jfid = jinc = None

needs_pgx = pytest.mark.skipif(jfid is None, reason="needs pgx (JAX)")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the parallel test run every worker's torch would take every
    core; one intra-op thread each keeps them from contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    rng = np.random.RandomState(0)
    return {
        "uint8_nhwc": (rng.rand(3, 32, 32, 3) * 255).astype(np.uint8),
        "float32_nhwc": rng.randn(3, 16, 16, 3).astype(np.float32),
        "float64_nhwc": rng.randn(2, 8, 8, 3),
        "float32_nchw": rng.randn(2, 3, 20, 20).astype(np.float32),
        "grey_nhwc1": (rng.rand(2, 28, 28, 1) * 255).astype(np.uint8),
        "grey_nhw": (rng.rand(2, 12, 12) * 255).astype(np.uint8),
        "float32_128": rng.randn(2, 128, 128, 3).astype(np.float32),
    }


@needs_pgx
@pytest.mark.parametrize("kind", list(_batches()))
def test_preprocess_equals_pgx_pil_chain(kind):
    x = _batches()[kind]
    want = jfid.preprocess(x)
    got = tfid.preprocess(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if x.dtype.kind == "f":
        np.testing.assert_array_equal(tfid.to_uint8_quirk(x),
                                      jfid.to_uint8_quirk(x))


@pytest.mark.parametrize("size", [8, 32, 128, 400])
def test_torch_resize_equals_numpy_resize(size):
    """The integer sums of the device path, on CPU tensors, against
    ``_resize_batch`` (PIL's bytes): three upscales to 299 and one
    downscale (wider taps)."""
    rng = np.random.RandomState(size)
    n = 1 if size == 400 else 2
    u8 = (rng.rand(n, size, size, 3) * 255).astype(np.uint8)
    got = tfid.resize_uint8(torch.from_numpy(u8), 299)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), _resize_batch(u8, 299))
    # the device path's floats: the lookup table is the host float chain
    np.testing.assert_array_equal(
        tfid._preprocess_tensor(torch.from_numpy(u8)).numpy(),
        tfid.preprocess(u8).numpy())


def test_preprocess_refuses_other_layouts():
    with pytest.raises(ValueError):
        tfid.preprocess(np.zeros((2, 8, 8, 4), np.uint8))
    with pytest.raises(TypeError):
        tfid.preprocess(np.zeros((2, 8, 8, 3), np.int32))


@needs_pgx
@pytest.mark.parametrize("case", ["full_rank", "few_samples", "fallback"])
def test_frechet_distance_equals_pgx(case):
    rng = np.random.RandomState(2)
    if case == "fallback":
        # a nilpotent product: sqrtm gives inf/nan, the eps diagonal
        # takes over
        s1 = np.zeros((4, 4))
        s1[0, 1] = 1.0
        stats = (np.zeros(4), s1, np.ones(4), np.eye(4))
    else:
        n = 200 if case == "full_rank" else 5
        a, b = rng.randn(n, 16), rng.randn(n, 16) * 1.3 + 0.2
        stats = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
                 np.cov(b, rowvar=False))
    want = jfid.calculate_frechet_distance(*stats)
    got = tfid.calculate_frechet_distance(*stats)
    assert np.isfinite(got)
    assert abs(got - want) <= 1e-12 * max(abs(want), 1.0)


def test_frechet_distance_of_equal_statistics_is_zero():
    acts = np.random.RandomState(0).randn(200, 16)
    mu, sigma = acts.mean(0), np.cov(acts, rowvar=False)
    assert abs(tfid.calculate_frechet_distance(mu, sigma, mu, sigma)) < 1e-6
    with pytest.raises(ValueError):
        tfid.calculate_frechet_distance(mu, sigma, mu[:3], sigma)


def test_get_activations_batching():
    """Any batch size gives the same float64 activations, in order; a
    callable without ``device`` gets CPU tensors; no images raise."""
    def extractor(batch):
        assert batch.device.type == "cpu" and batch.shape[1:] == (299, 299, 3)
        return batch.mean(dim=(1, 2)).numpy()[:, [0, 1, 2, 0]]

    data = (np.random.RandomState(3).rand(7, 12, 12, 3) * 255).astype(
        np.uint8)
    ref = tfid.get_activations(data, extractor, batch_size=7)
    assert ref.shape == (7, 4) and ref.dtype == np.float64
    for bs in (1, 3, 50):
        np.testing.assert_array_equal(
            tfid.get_activations(data, extractor, batch_size=bs), ref)
    mu, sigma = tfid.calculate_activation_statistics(data, extractor, 3)
    np.testing.assert_array_equal(mu, ref.mean(0))
    np.testing.assert_array_equal(sigma, np.cov(ref, rowvar=False))
    with pytest.raises(ValueError):
        tfid.get_activations(data[:0], extractor)


@needs_pgx
def test_fid_given_data_equals_pgx(tmp_path):
    from tests.torch_fid_inception import FIDInceptionV3, randomize_
    model = randomize_(FIDInceptionV3(), seed=3).eval()
    path = os.path.join(str(tmp_path), "rand_inception.pt")
    torch.save(model.state_dict(), path)
    rng = np.random.RandomState(4)
    a = (rng.rand(8, 16, 16, 3) * 255).astype(np.uint8)
    b = (rng.rand(8, 16, 16, 3) * 255).astype(np.uint8)
    jext = jfid.make_extractor(jinc.load_torch_weights(path))
    text = tfid.make_extractor(tinc.load_torch_weights(path), device="cpu")
    want = jfid.calculate_fid_given_data(
        a, b, lambda x: jext(x)[:, :64], batch_size=4)
    got = tfid.calculate_fid_given_data(
        a, b, lambda x: text(x)[:, :64], batch_size=4)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= 1e-3 * max(abs(want), 1.0)


def test_extractor_scopes_tf32_off_and_refuses_a_mesh():
    """TF32 is off inside the call and the caller's flags come back after
    it, also when the forward raises; ``mesh=`` is not ported."""
    ext = tfid.make_extractor(device="cpu")
    seen = []

    class Spy(torch.nn.Module):
        def forward(self, x):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            if len(seen) > 1:
                raise RuntimeError("boom")
            return x.mean(dim=(2, 3))

    ext.model = Spy()
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        out = ext(np.zeros((2, 299, 299, 3), np.float32))
        assert out.shape == (2, 3) and out.dtype == np.float32
        with pytest.raises(RuntimeError, match="boom"):
            ext(np.zeros((1, 299, 299, 3), np.float32))
        assert seen == [(False, False), (False, False)]
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    with pytest.raises(NotImplementedError, match="item 5"):
        tfid.make_extractor(device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfid.make_extractor()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["float32_nhwc", "float32_128",
                                  "grey_nhwc1", "uint8_nhwc"])
def test_gpu_preprocess_equals_the_host_path(cuda, kind):
    x = _batches()[kind]
    got = tfid.preprocess(x, cuda)
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tfid.preprocess(x).numpy())


@pytest.mark.gpu
def test_gpu_features_equal_the_cpu_features(cuda):
    """f32 Inception on the card against the CPU with the same random
    weights, one batch of 4: 1e-4 of the largest feature (cuDNN and the
    CPU sum in other orders; TF32 would move them by ~1e-3).  The
    caller's TF32 flag stays on around the call and does not change the
    features."""
    sd = tinc.init_inception(torch.Generator().manual_seed(0))
    x = tfid.preprocess(_batches()["float32_128"].repeat(2, axis=0))
    want = tfid.make_extractor(sd, device="cpu")(x)
    ext = tfid.make_extractor(sd, device=cuda)
    flag = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        got = ext(x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-4, err
