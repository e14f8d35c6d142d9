"""pgx_torch.parallel against pgx.parallel on the CPU.

The multi-rank cases run two gloo ranks on the CPU, each a subprocess of
tests/torch_ddp_worker.py (which imports pgx_torch and never JAX or pgx);
pgx's side runs here, on a 2-device mesh of the conftest's 8 virtual CPU
devices, at the global batch.  f64 in both packages, tolerances:

  * ``all_reduce_sum``: gradcheck, gradgradcheck, forward AD and reverse
    over forward at their defaults; values against pgx's psum at 1e-12;
  * ``minibatch_stddev`` over the ranks (plain and grouped): value,
    gradient and second derivative against pgx's on the mesh, 1e-12;
  * ``ada_update``: the controller's state exactly (f32);
  * ``stats``: the window's mean and std at 1e-12 against numpy;
  * ``train_loop`` and the trainer CLI at world 2: what rank 0 wrote and
    rank 1 did not, the per-rank data seeds, the replicas equal bit for
    bit after every iteration and after a resume;
  * the serving batcher and the Inception extractor over a list of two
    devices of this process: equal to the unsplit forward bit for bit and
    to pgx's on the mesh as the single-device tests hold them.
"""

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pgx import parallel as jpar
from pgx.augment.adaptive import AdaConfig as JAdaConfig
from pgx.augment.adaptive import ada_update as j_ada_update
from pgx.core import layers as jlayers
from pgx_torch import parallel as tpar
from pgx_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ddp_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(case: str, inp: dict, world: int = 2, timeout: int = 240):
    """Run ``case`` of the worker on ``world`` gloo ranks; their outputs,
    by rank.  A rank that fails fails the test with both ranks' output."""
    d = tempfile.mkdtemp(prefix=f"ddp_{case}_")
    with open(os.path.join(d, "in.pkl"), "wb") as f:
        pickle.dump(inp, f)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, case, str(r), str(world), str(port), d],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"--- rank {r} (rc {p.returncode}) ---\n{log[-4000:]}"
        for r, (p, log) in enumerate(zip(procs, logs)))
    outs = []
    for r in range(world):
        with open(os.path.join(d, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def _mesh2():
    return jpar.make_mesh(jax.devices()[:2])


# ---------------------------------------------------------------------------
# the collective
# ---------------------------------------------------------------------------

ADA_BATCH = 8
ADA_CFG = dict(ada_target=0.6, ada_length=40, interval_batches=2)
ADA_STATE = {"p": 0.25, "sign_sum": 0.0, "count": 0.0}


@pytest.fixture(scope="module")
def units():
    """One launch of two ranks for the collective, minibatch-stddev, the
    controller and the statistics: ``{part: (inputs, outputs by rank)}``."""
    rng = np.random.RandomState(0)
    inp = {"collectives": {"x": rng.randn(4, 3), "t": rng.randn(4, 3)},
           "stddev": {}, "ada": {
               "cfg": ADA_CFG, "state": ADA_STATE, "batch": ADA_BATCH,
               "logits": [rng.randn(ADA_BATCH) + 0.3 for _ in range(5)]},
           "stats": {"values": [[rng.randn(3), rng.randn(5)],
                                [rng.randn(4), rng.randn(2)]]}}
    for groups in (1, 3):
        inp["stddev"][f"x{groups}"] = rng.randn(4 * groups, 4, 4, 5)
        inp["stddev"][f"w{groups}"] = rng.randn(4 * groups, 4, 4, 6)
    outs = run_ranks("units", inp)
    return {k: (inp[k], [o[k] for o in outs]) for k in inp}


@pytest.fixture(scope="module")
def collectives(units):
    return units["collectives"]


def test_all_reduce_sum_passes_gradcheck_gradgradcheck_and_forward_ad(
        collectives):
    _, outs = collectives
    for out in outs:
        assert out["gradcheck"] and out["gradgradcheck"]
        assert out["reverse_over_forward"]


def test_all_reduce_sum_equals_psum_and_its_derivatives(collectives):
    """f(x) = psum(x * x) * x on pgx's mesh (each device its rows), its
    gradient of sum(f), the gradient of |grad|^2 and the tangent along t,
    against the ranks' values."""
    inp, outs = collectives
    x, t = jnp.asarray(inp["x"]), jnp.asarray(inp["t"])

    def f2(x):      # two ranks of two rows: psum over the rank axis
        xr = x.reshape(2, 2, 3)
        return (jnp.sum(xr * xr, axis=0, keepdims=True) * xr).reshape(4, 3)

    g = jax.grad(lambda x: jnp.sum(f2(x)))
    want = {"value": f2(x), "grad": g(x),
            "grad2": jax.grad(lambda x: jnp.sum(g(x) ** 2))(x),
            "tangent": jax.jvp(f2, (x,), (t,))[1]}
    for k, w in want.items():
        got = np.concatenate([o[k] for o in outs])
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-12,
                                   atol=1e-12, err_msg=k)


def test_library_all_reduce_backward_agrees_and_has_no_jvp(collectives):
    """torch.distributed.nn.functional.all_reduce: its backward is ours on
    this torch; forward mode is what it lacks."""
    _, outs = collectives
    for out in outs:
        assert out["library_backward_equal"]
        assert out["library_jvp"] != "ran"


# ---------------------------------------------------------------------------
# minibatch-stddev, the ADA controller, the statistics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stddev(units):
    return units["stddev"]


@pytest.mark.parametrize("groups", [1, 3])
def test_minibatch_stddev_over_ranks_equals_pgx_on_the_mesh(stddev, groups):
    """The statistic over the global batch (grouped: group g is slice g of
    every rank together, as pgx's concatenation of batch-sharded arrays),
    its gradient and second derivative through the collective."""
    inp, outs = stddev
    x, w = inp[f"x{groups}"], inp[f"w{groups}"]
    mesh = _mesh2()
    xs = jax.device_put(jnp.asarray(x), jpar.batch_sharding(mesh))

    def loss(x):
        return jnp.sum(jlayers.minibatch_stddev(x, groups=groups) * w)

    g = jax.jit(jax.grad(loss))
    want = {"value": jax.jit(lambda x: jlayers.minibatch_stddev(
        x, groups=groups))(xs), "grad": g(xs),
        "grad2": jax.jit(jax.grad(lambda x: jnp.sum(g(x) ** 2)))(xs)}
    gsz = x.shape[0] // groups
    b = gsz // 2
    for k, w_ in want.items():
        w_ = np.asarray(w_)
        for r, out in enumerate(outs):
            rows = np.concatenate([w_[gi * gsz + r * b:gi * gsz + (r + 1) * b]
                                   for gi in range(groups)])
            np.testing.assert_allclose(out[groups][k], rows, rtol=1e-12,
                                       atol=1e-12, err_msg=f"{k} rank {r}")


def test_ada_update_over_ranks_equals_pgx(units):
    inp, outs = units["ada"]
    state = {k: jnp.asarray(v, jnp.float32) for k, v in ADA_STATE.items()}
    want = []
    for lg in inp["logits"]:
        state = j_ada_update(state, jnp.asarray(lg, jnp.float32),
                             JAdaConfig(**ADA_CFG), ADA_BATCH)
        want.append({k: float(v) for k, v in state.items()})
    assert outs[0] == outs[1] == want
    assert len({w["p"] for w in want}) > 1       # the controller moved


def test_stats_collector_psum_and_replica_consistency(units):
    inp, outs = units["stats"]
    values = inp["values"]
    second = np.concatenate([values[0][1], values[1][1]])
    for out in outs:
        w = out["window"]
        assert w["num"] == second.size
        np.testing.assert_allclose(w["mean"], second.mean(), rtol=1e-6)
        np.testing.assert_allclose(w["std"], second.std(), rtol=1e-5)
        assert out["equal_passes"] and out["within_atol_passes"]
        assert out["perturbed"] is not None
        assert "state.opt.mu.w differs" in out["perturbed"]


def test_pgx_stats_functions_agree_in_one_process():
    """init_moments / report / Collector with no group: pgx's numbers."""
    from pgx.parallel import stats as jstats
    from pgx_torch.parallel import stats as tstats
    vals = np.random.RandomState(4).randn(7)
    jm = jstats.report(jstats.init_moments(), jnp.asarray(vals))
    tm = tstats.report(tstats.init_moments(), torch.tensor(vals))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    assert tstats.psum_moments(tm) is tm
    jc, tc = jstats.Collector(), tstats.Collector()
    jc.update({"a": jm})
    tc.update({"a": tm})
    for k in ("num", "mean", "std"):
        np.testing.assert_allclose(tc.as_dict()["a"][k],
                                   jc.as_dict()["a"][k], rtol=1e-6)
    tstats.check_replica_consistency({"x": torch.ones(2)})   # one process


# ---------------------------------------------------------------------------
# mesh and distributed helpers in one process
# ---------------------------------------------------------------------------

def test_mesh_helpers_match_pgx():
    cpu = torch.device("cpu")
    with pytest.warns(RuntimeWarning, match="only 3 device"):
        m = tpar.make_mesh_for_batch(6, devices=[cpu] * 4)
    with pytest.warns(RuntimeWarning, match="only 3 device"):
        jm = _prefix_mesh_like_pgx(6, 4)
    assert m.size == jm.devices.size == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tpar.make_mesh_for_batch(8, devices=[cpu] * 4).size == 4
    x = np.arange(12).reshape(6, 2)
    parts = tpar.shard_batch(tpar.make_mesh([cpu, cpu, cpu]), x)
    assert [p.tolist() for p in parts] == [x[:2].tolist(), x[2:4].tolist(),
                                           x[4:].tolist()]
    one = tpar.make_mesh([cpu])
    assert torch.equal(tpar.shard_batch(one, x), torch.as_tensor(x))
    assert tpar.batch_sharding(one).kind == "batch"
    assert tpar.replicated(one).kind == "replicated"
    assert tpar.host_batch_slice(8) == (8, 0, 8)
    assert tpar.initialize_multihost(num_processes=1, device="cpu") == (
        0, 1, cpu)
    assert tpar.broadcast_obj({"a": 1}) == {"a": 1}
    got = tpar.make_global_batch(one, {"x": x, "y": None})
    assert torch.equal(got["x"], torch.as_tensor(x)) and got["y"] is None
    for name in ("make_mesh_2d", "make_mesh_2d_for_batch", "shard_state",
                 "spatial_batch_sharding", "state_shardings"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            getattr(tpar, name)()
    from pgx_torch.parallel.distributed import backend_for
    assert backend_for("cpu") == "gloo"


def _prefix_mesh_like_pgx(batch, n):
    """pgx's make_mesh_for_batch on an n-device list (its rule, its
    warning), for a process that sees more devices."""
    import unittest.mock as mock
    with mock.patch.object(jax, "devices", lambda: jax.local_devices()[:n]):
        return jpar.make_mesh_for_batch(batch)


def test_data_parallel_apply_equals_the_unsplit_call():
    cpu = torch.device("cpu")
    mesh = tpar.make_mesh([cpu, cpu])
    lin = torch.nn.Linear(3, 2).double()
    reps = tpar.replicate(mesh, lin)
    assert reps[0] is lin and reps[1] is lin
    x = torch.randn(6, 3, dtype=torch.float64)
    got = tpar.data_parallel_apply(mesh, lambda m, r: m(r), reps, x)
    # each device's rows as one call on them computes them; against the
    # whole batch in one call, a matmul's blocking may move the last bit
    assert torch.equal(got, torch.cat([lin(x[:3]), lin(x[3:])]))
    torch.testing.assert_close(got, lin(x), rtol=1e-14, atol=1e-14)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.data_parallel_apply(mesh, lambda m, r: m(r), reps, x[:5])


# ---------------------------------------------------------------------------
# the loop and the CLI at world 2
# ---------------------------------------------------------------------------

def test_train_loop_at_world_2(tmp_path):
    root, root1 = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    os.makedirs(root)
    os.makedirs(root1)
    outs = run_ranks("loop", {"root": root, "root1": root1})
    r0, r1 = outs
    # rank 0 wrote the trial; rank 1 wrote nothing and read nothing
    assert os.path.basename(r0["trial"]).startswith("trial_ddp_")
    assert r0["resumed"] == r0["trial"]
    assert r1["resumed"] == os.path.join(root1, "trial_absent")
    assert r1["files"] == []
    names = r0["files"]
    trial = os.path.basename(r0["trial"])
    for it in (3, 4, 6, 7):
        assert f"{trial}/checkpoint/{it:03d}_state.pt" in names
    assert any(n.endswith(".png") for n in names)
    assert f"{trial}/timing.json" in names
    # the per-rank data seeds: seed + 104729 * rank + step (steps 2, 3),
    # each rank feeding 4 rows of the global 8
    assert r0["seeds"] and set(r0["seeds"]) <= {2, 3}
    assert r1["seeds"] == [s + 104729 for s in r0["seeds"]]
    assert set(r0["batches"]) == set(r1["batches"]) == {4}
    # replicas checked after every iteration of both runs, in step
    assert r0["first"] == r1["first"] == [0, 1, 2, 3]
    assert r0["checked"] == r1["checked"] == [0, 1, 2, 3, 4, 5, 6]


def test_trainer_cli_with_multihost_over_gloo(tmp_path):
    root, root1 = str(tmp_path / "rank0"), str(tmp_path / "rank1")
    os.makedirs(root)
    os.makedirs(root1)
    argv = ["--device", "cpu", "--synthetic", "--channels", "8", "--z-dim",
            "8", "--num-classes", "3", "--max-step", "3", "--init-step", "2",
            "--images-per-mini-step", "8", "--batch-size", "4",
            "--sample-every", "2", "--checkpoint-every", "2",
            "--log-every", "2"]
    outs = run_ranks("cli", {"argv": argv, "root": root, "root1": root1})
    for out in outs:
        assert out["world"] == 2 and out["backend"] == "gloo"
    assert outs[1]["files"] == []
    assert any(f.endswith("_state.pt") for f in outs[0]["files"])
    log = [f for f in outs[0]["files"] if "train_log_" in f]
    assert len(log) == 1
    with open(os.path.join(root, log[0])) as f:
        rows = f.read().strip().splitlines()[1:]
    assert rows and all(np.isfinite(float(v)) for r in rows
                        for v in r.split(",")[1:])


# ---------------------------------------------------------------------------
# data-parallel serving and FID over two devices of this process
# ---------------------------------------------------------------------------

@pytest.fixture()
def two_cpus(monkeypatch):
    """This process sees two CPU devices, as a host sees its cards."""
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 2)


def test_data_parallel_service_equals_pgx_on_the_mesh(two_cpus):
    from pgx.models import zoo as jzoo
    from pgx.models.generator import init_generator as j_init
    from pgx.serve import GeneratorService as JService
    from pgx_torch.models import zoo as tzoo
    from pgx_torch.serve import GeneratorService
    kw = dict(z_dim=8, num_classes=3, channel=8)
    jcfg = jzoo.mnist_conditional_generator(**kw)
    tcfg = tzoo.mnist_conditional_generator(**kw)
    params = jax.device_get(j_init(jax.random.PRNGKey(0), jcfg))
    one = GeneratorService.from_params(tcfg, params, step=2, max_batch=8,
                                       device="cpu")
    two = GeneratorService.from_params(tcfg, params, step=2, max_batch=8,
                                       data_parallel=2, device="cpu")
    jsvc = JService.from_params(jcfg, params, step=2, max_batch=8,
                                data_parallel=2)
    try:
        assert two._mesh is not None and len(two._mesh.devices) == 2
        rng = np.random.RandomState(5)
        for n in (1, 3, 8):
            z = rng.randn(n, 8).astype(np.float32)
            lab = rng.randint(0, 3, n).astype(np.int32)
            a = two.submit(z, lab).result(60)
            b = one.submit(z, lab).result(60)
            c = np.asarray(jsvc.submit(z, lab).result(60))
            assert a.shape == (n, 16, 16, 1) and a.dtype == np.uint8
            assert np.array_equal(a, b)
            diff = np.abs(a.astype(int) - c.astype(int))
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    finally:
        one.close()
        two.close()
        jsvc.close()
    with pytest.raises(ValueError, match="only 2 devices"):
        GeneratorService.from_params(tcfg, params, step=2, data_parallel=3,
                                     device="cpu")


def test_data_parallel_extractor_equals_pgx_on_the_mesh(two_cpus, tmp_path):
    """Inception's batch split over two devices (ragged batches padded)
    equals the unsplit extractor bit for bit, and pgx's mesh extractor as
    the single-device parity test holds them."""
    from pgx.eval import fid as jfid
    from pgx.eval import inception as jinc
    from pgx_torch.eval import fid as tfid
    from pgx_torch.eval import inception as tinc
    from tests.torch_fid_inception import FIDInceptionV3, randomize_
    model = randomize_(FIDInceptionV3(), seed=3).eval()
    path = os.path.join(str(tmp_path), "rand_inception.pt")
    torch.save(model.state_dict(), path)
    sd = tinc.load_torch_weights(path)
    mesh = tpar.make_mesh(tmesh.local_devices("cpu"))
    split = tfid.make_extractor(sd, device="cpu", mesh=mesh)
    whole = tfid.make_extractor(sd, device="cpu")
    jext = jfid.make_extractor(jinc.load_torch_weights(path), mesh=_mesh2())
    rng = np.random.RandomState(6)
    for n in (1, 3):
        x = rng.randn(n, 299, 299, 3).astype(np.float32)
        got = split(x)
        assert got.shape == (n, 2048)
        assert np.array_equal(got, whole(x))
        want = np.asarray(jext(x))
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    with pytest.raises(ValueError, match="own devices"):
        tfid.make_extractor(sd, device="cpu", mesh=tmesh.Mesh(
            (torch.device("cpu"),), world=2))
