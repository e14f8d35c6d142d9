"""The port's WGAN-GP step at world 2 against pgx's step on a 2-device mesh.

Two gloo ranks on the CPU (tests/torch_ddp_worker.py, which imports
pgx_torch and never JAX or pgx) each take their half of the batch through
``make_train_step(..., process_group=)``; pgx runs the same iteration here
on a 2-device ``('data',)`` mesh at the global batch (GSPMD: what pgx
computes on one device).  The tiny conditional "proper" pair of
tests/test_torch_train_ada.py (channel 8, step 2, global batch 4), f64 in
both packages, one shared initial state carried across with
``train_state_from_jax``; z, eps and the augmentation draws are pgx's own
(split from ``state["rng"]`` as its step splits it) at the global batch,
handed to every rank, each keeping its rows.

Variants: the reverse and the jvp penalty, each also with ``remat='full'``
(its checkpoint regions re-run the forward's collectives in the backward;
held against pgx's step without remat, the same arithmetic, which shares
its compile), and ``d_concat`` (per-group statistics over the ranks,
against pgx's ``d_concat`` step on the mesh).  tests/test_torch_ddp_ada.py
holds both penalties with ADA (bgc policy, the controller firing).

Tolerances (as the single-process parity tests hold them): without ADA
metrics at rtol 1e-9 (atol 1e-12) and Adam's ``mu`` (the gradient at
beta1 = 0) and ``nu`` at 1e-9 of each tensor's largest entry; with ADA
1e-4 (the pipe's f32 transform matrices differ in their last bit between
XLA and torch, tests/test_torch_train_ada.py), the controller's state to
f32 rounding.  Every rank's state is checked equal to rank 0's bit for bit
(``check_replica_consistency``) in the worker.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx import parallel as jpar
from pgx.augment import AdaConfig as JAdaConfig
from pgx.augment import pipe as jpipe
from pgx.models import zoo as jzoo
from pgx.train import wgan as jwgan
from pgx_torch.augment import pipe as tpipe
from pgx_torch.train import wgan as twgan
from tests.test_torch_augment import JaxDraws
from tests.test_torch_parallel import run_ranks

B, NUM_CLASSES, STEP = 4, 3, 2
GKW = dict(z_dim=8, num_classes=NUM_CLASSES, max_step=3, dtype="float64",
           channel=8)
DKW = dict(feat_dim=8, num_classes=NUM_CLASSES, max_step=3, dtype="float64")
JG = jzoo.conditional_correct_generator(**GKW)
JD = jzoo.conditional_correct_discriminator_wgangp(**DKW)
ADA = dict(interval_batches=1, ada_length=100)

# "tc": the port's TrainConfig; "pgx_tc": pgx's, where remat (which
# changes no number) is left out so the variant shares a compile
VARIANTS = {
    "reverse": dict(tc={}, ada=False, iterations=2),
    "jvp": dict(tc=dict(gp_mode="jvp"), ada=False, iterations=1),
    "reverse_remat": dict(tc=dict(remat=True, remat_policy="full"),
                          pgx_tc={}, ada=False, iterations=1),
    "jvp_remat": dict(tc=dict(gp_mode="jvp", remat=True,
                              remat_policy="full"),
                      pgx_tc=dict(gp_mode="jvp"), ada=False, iterations=1),
    "d_concat": dict(tc=dict(d_concat=True), ada=False, iterations=1),
}


class RecordingDraws(JaxDraws):
    """pgx's draws, kept in call order."""

    def __init__(self, key):
        super().__init__(key)
        self.arrays = []

    def _draw(self, fn, shape):
        a = super()._draw(fn, shape)
        self.arrays.append(a.numpy())
        return a


def _initial_state(seed, ada_p=0.0):
    tc = jwgan.TrainConfig()
    state = jwgan.init_train_state(jax.random.PRNGKey(seed), JG, JD, tc)
    f64 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float64), t)
    state["g"], state["d"] = f64(state["g"]), f64(state["d"])
    state["g_ema"] = jax.tree.map(jnp.copy, state["g"])
    opt = jwgan.make_optimizer(tc)
    state["opt_g"], state["opt_d"] = opt.init(state["g"]), opt.init(state["d"])
    state["ada"] = dict(state["ada"], p=jnp.asarray(ada_p, jnp.float32))
    return state


def _plain(jstate):
    """pgx's state as numpy and Python objects (what the worker can load
    without JAX)."""
    s = jax.device_get(jstate)
    out = {k: s[k] for k in ("g", "d", "g_ema")}
    for key in ("opt_g", "opt_d"):
        adam = s[key][0]
        out[key] = {"count": int(adam.count), "mu": adam.mu, "nu": adam.nu}
    out["iteration"] = int(s["iteration"])
    out["ada"] = {k: float(v) for k, v in s["ada"].items()}
    return out


def _draws(jstate, ada: bool, res: int):
    """z, eps and (with ADA) the three pipe's recorded draws, as pgx's step
    makes them from ``state['rng']``, at the global batch."""
    _, kz, keps, kar, kaf, kag = jax.random.split(jstate["rng"], 6)
    z = np.array(jax.random.normal(kz, (B, JG.z_dim), jnp.float32))
    eps = np.array(jax.random.uniform(keps, (B, 1, 1, 1), jnp.float64))
    aug = None
    if ada:
        aug = []
        img = torch.zeros(B, res, res, 3, dtype=torch.float64)
        for key in (kar, kaf, kag):
            rec = RecordingDraws(key)
            tpipe.augment_pipe(rec, img, tpipe.bgc_config(), 0.5)
            aug.append(rec.arrays)
    return z, eps, aug


def _batch(seed):
    rng = np.random.RandomState(seed)
    res = JG.resolution(STEP)
    return (np.tanh(rng.randn(B, res, res, 3)),
            rng.randint(0, NUM_CLASSES, B).astype(np.int32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def run_variants(variants):
    """Every variant through pgx on the mesh and through the port at world
    2 (one launch of two ranks): ``{variant: (pgx's metrics per
    iteration, pgx's final state, the ranks' results)}``."""
    mesh = jpar.make_mesh(jax.devices()[:2])
    res = JG.resolution(STEP)
    inputs, want, steps = {}, {}, {}
    for name, var in variants.items():
        seed = 3 + len(inputs)
        jstate = _initial_state(seed, ada_p=0.6 if var["ada"] else 0.0)
        plain = _plain(jstate)
        kw = {}
        if var["ada"]:
            kw = dict(augment_cfg=jpipe.bgc_config(),
                      ada_cfg=JAdaConfig(**ADA))
        jstate = jpar.replicate(mesh, jstate)
        its, jmetrics = [], []
        for i in range(var["iterations"]):
            real, labels = _batch(seed=40 + 7 * seed + i)
            z, eps, aug = _draws(jstate, var["ada"], res)
            pgx_tc = var.get("pgx_tc", var["tc"])
            key = (tuple(sorted(pgx_tc.items())), var["ada"])
            if key not in steps:
                steps[key] = jwgan.make_train_step(
                    JG, JD, jwgan.TrainConfig(**pgx_tc), step=STEP,
                    fading=False, donate=False, **kw)
            step = steps[key]
            r_dev, l_dev = jpar.shard_batch(mesh, jnp.asarray(real),
                                            jnp.asarray(labels))
            jstate, m = step(jstate, r_dev, l_dev,
                             jnp.asarray(1.0, jnp.float64))
            jmetrics.append({k: float(v) for k, v in m.items()})
            its.append(dict(real=real, labels=labels, z=z, eps=eps, aug=aug,
                            apply_gp=True))
        inputs[name] = dict(tc=var["tc"], ada=ADA if var["ada"] else None,
                            step=STEP, state=plain, iterations=its)
        want[name] = (jmetrics, jax.device_get(jstate))
    outs = run_ranks("step", {"gkw": GKW, "dkw": DKW, "variants": inputs},
                     timeout=300)
    return {name: (*want[name], [o[name] for o in outs])
            for name in variants}


@pytest.fixture(scope="module")
def ddp():
    return run_variants(VARIANTS)


def check_variant(result, name, ada):
    """One variant's ranks against pgx (the module docstring's
    tolerances)."""
    jmetrics, jstate, ranks = result
    rtol, atol, gtol = (1e-4, 1e-5, 1e-4) if ada else (1e-9, 1e-12, 1e-9)
    for r, out in enumerate(ranks):
        where = f"{name}, rank {r}"
        assert len(out["metrics"]) == len(jmetrics)
        for i, (got, want) in enumerate(zip(out["metrics"], jmetrics)):
            assert set(got) == set(twgan.METRICS) == set(want)
            for k in twgan.METRICS:
                np.testing.assert_allclose(
                    got[k], want[k], rtol=rtol, atol=atol,
                    err_msg=f"{where}: iteration {i + 1}, metric {k}")
        st = out["state"]
        for opt in ("opt_d", "opt_g"):
            adam = jstate[opt][0]
            assert st[opt]["count"] == int(adam.count), where
            for moment in ("mu", "nu"):
                want = _flat(getattr(adam, moment))
                got = st[opt][moment]
                assert got.keys() == want.keys()
                for n in want:
                    assert got[n].dtype == np.float64
                    scale = max(float(np.abs(want[n]).max()), 1e-30)
                    err = float(np.abs(got[n] - want[n]).max())
                    assert err <= gtol * scale, (
                        f"{where}: {opt}.{moment}.{n}: err {err} at scale "
                        f"{scale}")
        for k, v in jstate["ada"].items():
            np.testing.assert_allclose(st["ada"][k], float(v), rtol=1e-6,
                                       atol=0, err_msg=f"{where}: ada.{k}")
        assert st["iteration"] == int(jstate["iteration"])
    # the replicas: bit for bit (the worker checked them in place too)
    for net in ("g", "d", "g_ema"):
        for n, p in ranks[0]["state"][net].items():
            assert np.array_equal(p, ranks[1]["state"][net][n]), (name, n)
    if ada:
        assert jmetrics[0]["ada_p"] != pytest.approx(0.6)   # it fired


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_at_world_2_equals_pgx_on_the_mesh(ddp, name):
    check_variant(ddp[name], name, VARIANTS[name]["ada"])

