"""pgx_torch's FID InceptionV3 against pgx's ``inception_pool3`` on the CPU.

One random state dict in pytorch_fid's layout (tests/torch_fid_inception.py's
``randomize_``: scaled convs, BatchNorm statistics away from identity) goes
into both packages: through each package's ``load_torch_weights``, and
pgx's tree into the port through ``inception_from_jax_params``.  float64,
full 299x299 input, batch 2; tolerance 1e-6 relative and absolute (pgx's
own oracle test's bound; measured 4.4e-16 at features of magnitude 0.93).
"""

import os

import numpy as np
import pytest
import torch

import jax

from pgx.eval import inception as jinc
from pgx_torch.eval import inception as tinc
from tests.torch_fid_inception import FIDInceptionV3, randomize_

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under the parallel test run every worker's torch would take every
    core; one intra-op thread each keeps them from contending."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A random f64 oracle network, its state dict file, one input batch
    and pgx's features of it."""
    model = randomize_(FIDInceptionV3(), seed=0).double().eval()
    path = str(tmp_path_factory.mktemp("w") / "rand_inception.pt")
    torch.save(model.state_dict(), path)
    x = (np.random.RandomState(1).rand(2, 299, 299, 3) * 2.0 - 1.0)
    jparams = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           jinc.load_torch_weights(path))
    want = np.asarray(jinc.inception_pool3(jparams, x))
    return model, path, x, jparams, want


@pytest.mark.parametrize("carry", ["load_torch_weights",
                                   "inception_from_jax_params"])
def test_inception_matches_pgx(weights, carry):
    _, path, x, jparams, want = weights
    sd = (tinc.load_torch_weights(path) if carry == "load_torch_weights"
          else tinc.inception_from_jax_params(jparams))
    got = tinc.inception_pool3(sd, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, tinc.POOL3_DIM)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_inception_matches_the_torch_oracle(weights):
    """The oracle's own module (nn.BatchNorm2d, no folding) on the port's
    state dict: the port's fold and pools are pytorch_fid's."""
    oracle, path, x, _, _ = weights
    with torch.no_grad():
        want = oracle(torch.from_numpy(
            np.ascontiguousarray(x.transpose(0, 3, 1, 2)))).numpy()
    sd = {k: v.double() for k, v in tinc.load_torch_weights(path).items()}
    got = tinc.inception_pool3(sd, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["pt_inception", "torchvision"])
def test_both_checkpoint_layouts_load_the_same(tmp_path, layout):
    """pytorch_fid's file (backbone + a 1008-class fc) and torchvision's
    (backbone + AuxLogits + fc + num_batches_tracked) give the backbone's
    tensors, the extra heads ignored; pgx reads the same file to the same
    numbers."""
    model = randomize_(FIDInceptionV3(), seed=7).eval()
    base = model.state_dict()
    sd = dict(base)
    if layout == "pt_inception":
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(1008, 2048), \
            torch.zeros(1008)
    else:
        for name, shape in [("AuxLogits.conv0.conv.weight", (128, 768, 1, 1)),
                            ("AuxLogits.conv0.bn.weight", (128,)),
                            ("AuxLogits.conv1.conv.weight", (768, 128, 5, 5)),
                            ("AuxLogits.fc.weight", (1000, 768)),
                            ("AuxLogits.fc.bias", (1000,)),
                            ("fc.weight", (1000, 2048)), ("fc.bias", (1000,))]:
            sd[name] = torch.zeros(*shape)
    path = os.path.join(str(tmp_path), f"{layout}.pt")
    torch.save(sd, path)
    got = tinc.load_torch_weights(path)
    assert set(got) == set(tinc.InceptionV3().state_dict())
    for k, v in got.items():
        torch.testing.assert_close(v, base[k], rtol=0, atol=0)
    jparams = jinc.load_torch_weights(path)
    back = tinc.inception_from_jax_params(
        jax.tree.map(np.asarray, jparams))
    for k, v in back.items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)


def test_key_completeness_against_pgx():
    """The port's network has one conv + BatchNorm per entry of pgx's
    ``init_inception`` tree, of the same shapes (OIHW against HWIO), and
    the port's ``init_inception`` fills every key of its module."""
    jp = jinc.init_inception(jax.random.PRNGKey(0))
    sd = tinc.init_inception(torch.Generator().manual_seed(0))
    assert set(sd) == set(tinc.InceptionV3().state_dict())
    names = {k.rsplit(".", 2)[0] for k in sd}
    assert names == set(jp)
    for name, p in jp.items():
        w = sd[f"{name}.conv.weight"]
        assert tuple(w.permute(2, 3, 1, 0).shape) == p["w"].shape
        for leaf, key in (("weight", "gamma"), ("bias", "beta"),
                          ("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_array_equal(sd[f"{name}.bn.{leaf}"].numpy(),
                                          np.asarray(p[key]))


def test_init_inception_is_pgx_init_from_a_generator():
    """Weights normal * sqrt(1/fan_in) (pgx's init), the same draws from the
    same seed, other draws from another."""
    a = tinc.init_inception(torch.Generator().manual_seed(3))
    b = tinc.init_inception(torch.Generator().manual_seed(3))
    c = tinc.init_inception(torch.Generator().manual_seed(4))
    w = a["Mixed_7c.branch3x3dbl_1.conv.weight"]        # 448 x 2048 x 1 x 1
    assert abs(float(w.std()) * np.sqrt(2048) - 1.0) < 0.01
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["Conv2d_1a_3x3.conv.weight"],
                           c["Conv2d_1a_3x3.conv.weight"])


def test_batchnorm_fold_is_made_at_load(weights):
    """Every BatchNorm's scale and shift are folded when the weights load,
    with pgx's operations in pgx's order (``gamma * rsqrt(var + 1e-3)``,
    ``beta - mean * scale``); the state dict does not carry them, and
    loading other weights into a built network folds those."""
    _, path, _, _, _ = weights
    sd = {k: v.double() for k, v in tinc.load_torch_weights(path).items()}
    model = tinc.build_inception(dtype=torch.float64)
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(sd)
    bns = [(n[:-len(".bn")], m) for n, m in model.named_modules()
           if isinstance(m, tinc._FoldedBatchNorm)]
    assert len(bns) == len(tinc.conv_specs()) == 94
    for name, bn in bns:
        scale = sd[f"{name}.bn.weight"] * torch.rsqrt(
            sd[f"{name}.bn.running_var"] + 1e-3)
        shift = sd[f"{name}.bn.bias"] - sd[f"{name}.bn.running_mean"] * scale
        assert bn.scale.dtype == bn.shift.dtype == torch.float64
        assert torch.equal(bn.scale, scale) and torch.equal(bn.shift, shift)
