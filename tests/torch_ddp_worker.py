"""One rank of the port's data-parallel CPU tests.

    python tests/torch_ddp_worker.py CASE RANK WORLD PORT DIR

Joins a gloo process group of WORLD ranks at 127.0.0.1:PORT (except the
``cli`` case, whose trainer joins it through ``--multihost``), reads the
case's inputs from ``DIR/in.pkl`` (numpy and Python objects only), runs
CASE and writes what it found to ``DIR/out{RANK}.pkl``.  It imports
``pgx_torch``, torch and numpy, never JAX or ``pgx``: an import hook makes
either an ``ImportError``.  tests/test_torch_parallel.py and
tests/test_torch_ddp.py launch it and hold the results against ``pgx``.
"""

import os
import pickle
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _NoJax:
    """Refuses every import of JAX and of the JAX package."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pgx", "optax", "flax"):
            raise ImportError(f"the worker must not import {name}")
        return None


sys.meta_path.insert(0, _NoJax())
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.autograd.forward_ad as fwAD  # noqa: E402

WORLD = None     # the default group, once initialized (main)


def _rows(a, rank, world):
    per = a.shape[0] // world
    return a[rank * per:(rank + 1) * per]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def case_collectives(inp, rank, world):
    """gradcheck, gradgradcheck and forward AD of all_reduce_sum (every rank
    perturbs its input in step, so the numerical derivative is that of the
    function of all ranks' inputs moved together, which the analytical one
    computes too); reverse over forward; and the library's all_reduce."""
    from pgx_torch.parallel import all_reduce_sum
    x = torch.tensor(_rows(inp["x"], rank, world), requires_grad=True)
    t = torch.tensor(_rows(inp["t"], rank, world))

    def f(x):
        return all_reduce_sum(x * x, WORLD) * x

    out = {"gradcheck": torch.autograd.gradcheck(
        f, (x,), check_forward_ad=True, check_backward_ad=True)}
    out["gradgradcheck"] = torch.autograd.gradgradcheck(f, (x,))

    def tangent(x):
        with fwAD.dual_level():
            return fwAD.unpack_dual(f(fwAD.make_dual(x, t))).tangent
    out["reverse_over_forward"] = torch.autograd.gradcheck(tangent, (x,))
    # the values themselves, against pgx's psum on the caller's side
    y = f(x)
    g, = torch.autograd.grad(y.sum(), x, create_graph=True)
    gg, = torch.autograd.grad((g * g).sum(), x)
    out["value"] = y.detach().numpy()
    out["grad"] = g.detach().numpy()
    out["grad2"] = gg.numpy()
    out["tangent"] = tangent(x).detach().numpy()
    # torch.distributed.nn.functional.all_reduce: backward, and its jvp
    from torch.distributed.nn.functional import all_reduce as lib_all_reduce
    xl = x.detach().clone().requires_grad_(True)
    gl, = torch.autograd.grad((lib_all_reduce(xl * xl) * xl).sum(), xl)
    out["library_backward_equal"] = bool(torch.equal(gl, g.detach()))
    try:
        with fwAD.dual_level():
            fwAD.unpack_dual(lib_all_reduce(fwAD.make_dual(
                x.detach(), t))).tangent
        out["library_jvp"] = "ran"
    except Exception as e:     # the finding: no jvp
        out["library_jvp"] = f"{type(e).__name__}: {e}"
    return out


def case_stddev(inp, rank, world):
    """minibatch_stddev over the ranks' rows, plain and grouped: the value,
    the gradient of a weighted sum (which crosses the ranks) and its
    second derivative through the collective."""
    from pgx_torch.core.layers import minibatch_stddev
    res = {}
    for groups in (1, 3):
        x_glob, w_glob = inp[f"x{groups}"], inp[f"w{groups}"]
        gsz = x_glob.shape[0] // groups
        # rank r holds rows [r * b, (r + 1) * b) of every group
        sl = lambda a: np.concatenate([
            _rows(a[g * gsz:(g + 1) * gsz], rank, world)
            for g in range(groups)])
        x = torch.tensor(sl(x_glob), requires_grad=True)
        w = torch.tensor(sl(w_glob))
        y = minibatch_stddev(x, groups=groups, group=WORLD)
        loss = (y * w).sum()
        g, = torch.autograd.grad(loss, x, create_graph=True)
        gg, = torch.autograd.grad((g * g).sum(), x)
        res[groups] = {"value": y.detach().numpy(),
                       "grad": g.detach().numpy(), "grad2": gg.numpy()}
    return res


def case_ada(inp, rank, world):
    from pgx_torch.augment.adaptive import AdaConfig, ada_update
    cfg = AdaConfig(**inp["cfg"])
    state = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in inp["state"].items()}
    seen = []
    for logits in inp["logits"]:
        state = ada_update(state, torch.tensor(_rows(logits, rank, world)),
                           cfg, inp["batch"], group=WORLD)
        seen.append({k: float(v) for k, v in state.items()})
    return seen


def case_stats(inp, rank, world):
    from pgx_torch.parallel import stats
    out = {}
    col = stats.Collector()
    m = stats.init_moments()
    for vals in inp["values"][rank]:
        m = stats.report(m, torch.tensor(vals))
        col.update({"loss": stats.psum_moments(m, WORLD)})
    out["window"] = col.as_dict()["loss"]
    lin = torch.nn.Linear(3, 2).double()
    torch.nn.init.constant_(lin.weight, 0.5)
    torch.nn.init.constant_(lin.bias, -0.25)
    state = {"net": lin, "opt": {"count": 3, "mu": {"w": torch.ones(4)}},
             "nan": torch.tensor([float("nan"), 1.0]),
             "rng": torch.Generator().manual_seed(5)}
    stats.check_replica_consistency(state, label="state", group=WORLD)
    out["equal_passes"] = True
    if rank == 1:
        with torch.no_grad():
            state["opt"]["mu"]["w"][2] += 1e-6
    try:
        stats.check_replica_consistency(state, label="state", group=WORLD)
        out["perturbed"] = None
    except AssertionError as e:
        out["perturbed"] = str(e)
    stats.check_replica_consistency(state, atol=1e-5, label="state",
                                    group=WORLD)
    out["within_atol_passes"] = True
    return out


def case_units(inp, rank, world):
    """The collective, minibatch-stddev, the controller and the statistics
    in one launch: each part's inputs under its name."""
    return {name: CASES[name](inp[name], rank, world)
            for name in ("collectives", "stddev", "ada", "stats")}


class ReplayDraws:
    """Hands out recorded draws in order (the caller's are pgx's)."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def _next(self, shape):
        a = self.arrays.pop(0)
        if tuple(a.shape) != tuple(shape):
            raise AssertionError(f"draw of {tuple(shape)}, recorded "
                                 f"{a.shape}")
        return torch.from_numpy(np.array(a))

    uniform = normal = _next


def _state_from(gcfg, dcfg, tc, tree):
    """The port's state from the caller's plain copy of pgx's state."""
    from pgx_torch.train import train_state_from_jax
    jstate = dict(tree)
    for key in ("opt_g", "opt_d"):
        jstate[key] = (types.SimpleNamespace(**tree[key]),)
    return train_state_from_jax(gcfg, dcfg, tc, jstate, "cpu")


def _flat_state(state):
    out = {"iteration": state["iteration"],
           "ada": {k: float(v) for k, v in state["ada"].items()}}
    for opt in ("opt_d", "opt_g"):
        out[opt] = {"count": state[opt]["count"],
                    **{m: {n: t.detach().numpy().copy()
                           for n, t in state[opt][m].items()}
                       for m in ("mu", "nu")}}
    for net in ("g", "d", "g_ema"):
        out[net] = {n: p.detach().numpy().copy()
                    for n, p in state[net].named_parameters()}
    return out


def case_step(inp, rank, world):
    """WGAN-GP iterations of the port at world ``world``: each rank its
    rows of the batch, the global draws handed in."""
    from pgx_torch.augment import AdaConfig, bgc_config
    from pgx_torch.models import zoo
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import TrainConfig, make_train_step
    gcfg = zoo.conditional_correct_generator(**inp["gkw"])
    dcfg = zoo.conditional_correct_discriminator_wgangp(**inp["dkw"])
    results = {}
    for name, var in inp["variants"].items():
        tc = TrainConfig(**var["tc"])
        state = _state_from(gcfg, dcfg, tc, var["state"])
        kw = {}
        if var["ada"]:
            kw = dict(augment_cfg=bgc_config(),
                      ada_cfg=AdaConfig(**var["ada"]))
        metrics = []
        for it in var["iterations"]:
            step = make_train_step(gcfg, dcfg, tc, step=var["step"],
                                   fading=False, apply_gp=it["apply_gp"],
                                   process_group=WORLD, **kw)
            aug = (None if it["aug"] is None
                   else [ReplayDraws(a) for a in it["aug"]])
            state, m = step(
                state, torch.from_numpy(_rows(it["real"], rank, world)),
                torch.from_numpy(_rows(it["labels"], rank, world)), 1.0,
                z=torch.from_numpy(it["z"]), eps=torch.from_numpy(it["eps"]),
                aug_draws=aug)
            metrics.append({k: float(v) for k, v in m.items()})
        check_replica_consistency(state, label=name, group=WORLD)
        results[name] = {"metrics": metrics, "state": _flat_state(state)}
    return results


def _tiny_pair():
    from pgx_torch.models import zoo
    gcfg = zoo.conditional_correct_generator(
        z_dim=8, num_classes=3, channel=8, max_step=3, dtype="float32")
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=8, num_classes=3, max_step=3, dtype="float32")
    return gcfg, dcfg


def case_loop(inp, rank, world):
    """train_loop at world 2: rank 0 writes alone, the per-rank data seeds,
    a resume read on rank 0 and broadcast, the replicas equal after every
    iteration."""
    from pgx_torch.data.datasets import synthetic_dataset
    from pgx_torch.data.pipeline import array_batches
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import LoopConfig, ProperSchedule, TrainConfig
    from pgx_torch.train.loop import train_loop
    gcfg, dcfg = _tiny_pair()
    root = inp["root"] if rank == 0 else inp["root1"]
    ds = synthetic_dataset(n=64, size=32, channels=3, num_classes=3, seed=0)
    sched = ProperSchedule(images_seen_per_mini_step=16, batch_size=8,
                           max_step=3, init_step=2)
    seeds, batches, checked = [], [], []

    def batch_fn(dataset, batch, res, seed):
        seeds.append(seed)
        batches.append(batch)
        return array_batches(dataset, batch, res, seed=seed)

    def on_iteration(i, st, state, metrics):
        check_replica_consistency(state, label=f"iteration {i}",
                                  group=WORLD)
        checked.append(i)

    def run(total, resume=None):
        return train_loop(
            gcfg, dcfg, TrainConfig(), sched, ds,
            LoopConfig(trial_name="ddp", main_path=root, batch_size=8,
                       sample_every=3, checkpoint_every=3, log_every=3,
                       total_iterations=total, verbose=False,
                       snapshot_sources=False),
            resume_dir=resume, batch_fn=batch_fn,
            hooks={"on_iteration": on_iteration}, device="cpu")

    trial = run(4)
    first = list(checked)
    # rank 1 is handed a path that does not exist: rank 0 alone reads
    trial = broadcast_trial(trial)
    resumed = run(7, resume=trial if rank == 0
                  else os.path.join(root, "trial_absent"))
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {"trial": trial, "resumed": resumed, "seeds": seeds,
            "batches": batches, "first": first, "checked": checked,
            "files": files}


def broadcast_trial(trial):
    from pgx_torch.parallel import broadcast_obj
    return broadcast_obj(trial)


def case_cli(inp, rank, world):
    """A family trainer with --multihost: it joins the group itself."""
    from pgx_torch.cli import conditional_proper_cifar_train as cli
    root = inp["root"] if rank == 0 else inp["root1"]
    argv = inp["argv"] + ["--output", root, "--multihost",
                          "--coordinator-address", inp["address"],
                          "--num-processes", str(world),
                          "--process-id", str(rank)]
    trial = cli.main(argv)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {"trial": trial, "files": files,
            "world": dist.get_world_size(), "backend": dist.get_backend()}


CASES = {n[len("case_"):]: f for n, f in globals().items()
         if n.startswith("case_")}


def main():
    case, rank, world, port, d = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    global WORLD
    if case != "cli":
        from pgx_torch.parallel import initialize_multihost
        initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
        WORLD = dist.group.WORLD
    else:
        inp["address"] = f"127.0.0.1:{port}"
    out = CASES[case](inp, rank, world)
    with open(os.path.join(d, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    # every rank's results are on disk before any rank leaves; then leave
    # without tearing the group down: gloo's teardown can abort (SIGABRT)
    # a rank whose peer has already closed its sockets
    dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
