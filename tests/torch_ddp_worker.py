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
from unittest import mock

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


def case_tp_step(inp, rank, world):
    """WGAN-GP iterations of the port on a (data, model) grid of the
    ``world`` ranks: the state sharded over the model axis, each rank its
    rows of the batch, the global draws handed in; the gathered state
    back, and the bytes the rank held before and after sharding."""
    from pgx_torch.augment import AdaConfig, bgc_config
    from pgx_torch.models import zoo
    from pgx_torch.parallel import tp
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import TrainConfig, make_train_step
    gcfg = zoo.conditional_correct_generator(**inp["gkw"])
    dcfg = zoo.conditional_correct_discriminator_wgangp(**inp["dkw"])
    mesh = tp.make_mesh_2d(world // inp["n_model"], inp["n_model"])
    results = {}
    for name, var in inp["variants"].items():
        tc = TrainConfig(**var["tc"])
        state = _state_from(gcfg, dcfg, tc, var["state"])
        whole_bytes = tp.resident_bytes(state)
        tp.shard_state(mesh, state)
        kw = {}
        if var["ada"]:
            kw = dict(augment_cfg=bgc_config(),
                      ada_cfg=AdaConfig(**var["ada"]))
        metrics = []
        for it in var["iterations"]:
            step = make_train_step(gcfg, dcfg, tc, step=var["step"],
                                   fading=False, apply_gp=it["apply_gp"],
                                   mesh=mesh, **kw)
            aug = (None if it["aug"] is None
                   else [ReplayDraws(a) for a in it["aug"]])
            state, m = step(
                state, torch.from_numpy(_rows(it["real"], mesh.rank, world)),
                torch.from_numpy(_rows(it["labels"], mesh.rank, world)), 1.0,
                z=torch.from_numpy(it["z"]), eps=torch.from_numpy(it["eps"]),
                aug_draws=aug)
            metrics.append({k: float(v) for k, v in m.items()})
        check_replica_consistency(state, label=name, mesh=mesh)
        results[name] = {"metrics": metrics,
                         "state": _flat_state(tp.gather_state(mesh, state)),
                         "bytes": (whole_bytes, tp.resident_bytes(state)),
                         "grid": (mesh.d, mesh.m)}
    if inp.get("forms"):
        results["forms"] = _forms(mesh, state, rank)
    return results


def _row_errors(got, want, n, m):
    """Max |got - want| over each class of this rank's rows (dim 1): the
    true image edges, the cuts between ranks, the rows between."""
    h = got.shape[1]
    out = {}
    for i in range(h):
        if (m == 0 and i == 0) or (m == n - 1 and i == h - 1):
            kind = "edge"
        elif i == 0 or i == h - 1:
            kind = "cut"
        else:
            kind = "interior"
        err = float((got[:, i] - want[:, i]).abs().max())
        out[kind] = max(out.get(kind, 0.0), err)
    return out


def _tile_ref(x, n, m, rows, fill):
    """The haloed tile of rank m cut from the whole image ``x``."""
    big, h = x.shape[1], x.shape[1] // n
    lo, hi = m * h, (m + 1) * h
    if fill == "none":
        return x[:, max(lo - rows, 0):min(hi + rows, big)]
    if fill == "zero":
        top = torch.zeros_like(x[:, :rows])
        bot = torch.zeros_like(x[:, :rows])
    else:
        top = x[:, :1].expand(-1, rows, -1, -1)
        bot = x[:, -1:].expand(-1, rows, -1, -1)
    return torch.cat([top, x, bot], dim=1)[:, lo:hi + 2 * rows]


def _split_checks(mesh, inp):
    """The row collectives and the split layers on ``mesh`` against the
    same functions of whole images (every rank holds the whole inputs):
    per check, the errors by row class (``_row_errors``) or a number."""
    from pgx_torch.core import layers as L
    from pgx_torch.models import zoo
    from pgx_torch.models.discriminator import (Discriminator,
                                                discriminator_apply)
    from pgx_torch.models.generator import Generator, generator_apply
    from pgx_torch.ops.resize import downsample2x, upsample2x
    from pgx_torch.parallel import collectives as coll
    n, m = mesh.n_model, mesh.m
    mine = lambda t: coll.split_rows(t, mesh)
    x_all = torch.from_numpy(inp["x"])
    h = x_all.shape[1] // n
    out = {}

    def rand(shape, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g, dtype=x_all.dtype)

    # -- halo_exchange: forward, backward, double backward, jvp ----------
    for fill, rows in (("zero", 1), ("edge", 1), ("none", 1), ("zero", 2)):
        name = f"halo_{fill}_{rows}"
        wts = [rand(_tile_ref(x_all, n, r, rows, fill).shape, 100 + r)
               for r in range(n)]
        t_all = rand(x_all.shape, 7)
        x = mine(x_all).requires_grad_(True)
        w = wts[m].clone().requires_grad_(True)
        y = coll.halo_exchange(x, mesh, rows, fill)
        g, = torch.autograd.grad((y * w).sum(), x, create_graph=True)
        v = rand(x.shape, 300 + m)
        gw, = torch.autograd.grad((g * v).sum(), w)
        with fwAD.dual_level():
            tan = fwAD.unpack_dual(coll.halo_exchange(
                fwAD.make_dual(x.detach(), mine(t_all)), mesh, rows,
                fill)).tangent
        xr = x_all.clone().requires_grad_(True)
        loss = sum((_tile_ref(xr, n, r, rows, fill) * wts[r]).sum()
                   for r in range(n))
        gr, = torch.autograd.grad(loss, xr)
        v_all = torch.cat([rand((x_all.shape[0], h) + x_all.shape[2:],
                                300 + r) for r in range(n)], dim=1)
        want = _tile_ref(x_all, n, m, rows, fill)
        out[name] = {
            "shape": tuple(y.shape),
            "forward": float((y - want).abs().max()),
            "backward": _row_errors(g, mine(gr), n, m),
            "double_backward": float(
                (gw - _tile_ref(v_all, n, m, rows, fill)).abs().max()),
            "jvp": float((tan - _tile_ref(t_all, n, m, rows, fill))
                         .abs().max())}

    # -- gather_rows / split_rows -----------------------------------------
    x = mine(x_all).requires_grad_(True)
    wg = rand(x_all.shape, 11)
    w = wg.clone().requires_grad_(True)
    whole = coll.gather_rows(x, mesh)
    g, = torch.autograd.grad((whole * w).sum(), x, create_graph=True)
    v = rand(x.shape, 400 + m)
    gg, = torch.autograd.grad((g * v).sum(), w)
    v_all = torch.cat([rand(x.shape, 400 + r) for r in range(n)], dim=1)
    with fwAD.dual_level():
        tan = fwAD.unpack_dual(coll.gather_rows(fwAD.make_dual(
            x.detach(), mine(wg)), mesh)).tangent
    xs = x_all.clone().requires_grad_(True)
    gs, = torch.autograd.grad((coll.split_rows(xs, mesh) * x).sum(), xs)
    out["gather"] = {
        "forward": float((whole - x_all).abs().max()),
        # every rank differentiates the same whole: n_model times the
        # gradient of its rows (the collectives' convention)
        "backward": float((g - n * mine(wg)).abs().max()),
        # the reduce-scatter's backward: the gather of the ranks'
        # cotangents, each rank's part of the shared whole's gradient
        "double_backward": float((gg - v_all).abs().max()),
        "jvp": float((tan - wg).abs().max()),
        "split_backward": float((gs - torch.cat([
            x.detach() if r == m else torch.zeros_like(x)
            for r in range(n)], dim=1)).abs().max())}

    # -- the two forms of every collective, bit for bit --------------------
    xm = mine(x_all)
    first, last = xm[:, :1], xm[:, -1:]
    up, down = (first if m > 0 else None), (last if m < n - 1 else None)
    a = coll._exchange_gloo(mesh, up, down, first)
    b = coll._exchange_p2p(mesh, up, down, first)
    forms = all((u is None and v is None) or torch.equal(u, v)
                for u, v in zip(a, b))
    with mock.patch.object(coll, "_nccl", lambda group: True):
        ga, ra = coll._gather_rows(mesh, xm), coll._reduce_scatter_rows(
            mesh, wg)
    gb, rb = coll._gather_rows(mesh, xm), coll._reduce_scatter_rows(mesh, wg)
    out["forms_bitwise"] = (forms and torch.equal(ga, gb)
                            and torch.equal(ra, rb))

    # -- a 3x3 conv (cuDNN's route and C's), upsample2x, downsample2x -----
    conv = L.EqualConv2d(x_all.shape[-1], 8, 3).to(x_all.dtype)
    with torch.no_grad():
        conv.w.copy_(rand(conv.w.shape, 21))
        conv.b.copy_(rand(conv.b.shape, 22))
    wy = rand(x_all.shape[:3] + (8,), 23)
    cases = {
        "conv3x3": lambda t, r: L._conv_step(conv, t, 1, True, 0.2,
                                             fused=False, rows=r),
        "upsample2x": lambda t, r: upsample2x(t, r),
        "downsample2x": lambda t, r: downsample2x(t)}
    for name, fn in cases.items():
        x = mine(x_all).requires_grad_(True)
        y = fn(x, mesh)
        xr = x_all.clone().requires_grad_(True)
        yr = fn(xr, None)
        wo = rand(yr.shape, 31)
        params = list(conv.parameters()) if name == "conv3x3" else []
        got = torch.autograd.grad((y * mine(wo)).sum(), [x] + params)
        want = torch.autograd.grad((yr * wo).sum(), [xr] + params)
        out[name] = {"forward": _row_errors(y, mine(yr), n, m),
                     "backward": _row_errors(got[0], mine(want[0]), n, m)}
        if params:
            # each rank's weight gradient is its rows' part: summed over
            # the model group, the whole image's
            parts = [coll.all_reduce_sum(t, mesh.model_group)
                     for t in got[1:]]
            out[name]["weights"] = max(float((p - q).abs().max())
                                       for p, q in zip(parts, want[1:]))
    # kernel C's route (its plain version here), f32 on haloed tiles
    x32 = x_all.float()
    c32 = L.EqualConv2d(x_all.shape[-1], 8, 3)
    c32.load_state_dict({k: v.float() for k, v in conv.state_dict().items()})
    y = L._conv_step(c32, mine(x32), 1, True, 0.2, fused=True, rows=mesh)
    yr = L._conv_step(c32, x32, 1, True, 0.2, fused=True)
    out["conv3x3_c"] = {"forward": _row_errors(y, mine(yr), n, m)}

    # -- G and D of the tiny pair, fading, split against whole -------------
    gcfg = zoo.conditional_correct_generator(**inp["gkw"])
    dcfg = zoo.conditional_correct_discriminator_wgangp(**inp["dkw"])
    gen = Generator.from_jax_params(gcfg, inp["g"], "cpu")
    disc = Discriminator.from_jax_params(dcfg, inp["d"], "cpu")
    z, lab = torch.from_numpy(inp["z"]), torch.from_numpy(inp["labels"])
    kw = dict(step=inp["step"], alpha=0.3, fading=True)
    img = generator_apply(gen, z, lab, rows=mesh, **kw)
    img_r = generator_apply(gen, z, lab, **kw)
    out["generator"] = _row_errors(img, mine(img_r), n, m)
    score = discriminator_apply(disc, mine(img_r), lab, rows=mesh, **kw)
    score_r = discriminator_apply(disc, img_r, lab, **kw)
    out["discriminator"] = float((score - score_r).abs().max())
    return out


def case_spatial(inp, rank, world):
    """Spatial mode on the ``world`` ranks: the row collectives and the
    split layers on the (1, world) grid and, at world 4, on the (2, 2) grid
    (``units``), and WGAN-GP iterations of the port on the (1, world) grid
    (``variants``): the state whole on every rank, each rank the rows of
    its data position and its rows of H, the global draws handed in."""
    from pgx_torch.augment import AdaConfig, bgc_config
    from pgx_torch.models import zoo
    from pgx_torch.parallel import tp
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import TrainConfig, make_train_step
    meshes = {(1, world): tp.make_mesh_2d(1, world, mode="spatial")}
    if world == 4:
        meshes[(2, 2)] = tp.make_mesh_2d(2, 2, mode="spatial")
    out = {}
    if inp.get("units"):
        out["units"] = {grid: _split_checks(mesh, inp["units"])
                        for grid, mesh in meshes.items()}
    mesh = meshes[(1, world)]
    place = tp.spatial_batch_sharding(mesh)
    out["grid"] = (mesh.n_data, mesh.n_model, mesh.d, mesh.m, mesh.mode)
    gcfg = zoo.conditional_correct_generator(**inp["gkw"])
    dcfg = zoo.conditional_correct_discriminator_wgangp(**inp["dkw"])
    for name, var in inp.get("variants", {}).items():
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
                                   mesh=mesh, **kw)
            aug = (None if it["aug"] is None
                   else [ReplayDraws(a) for a in it["aug"]])
            labels = it["labels"][place.batch_rows(len(it["labels"]))]
            state, m = step(
                state, torch.from_numpy(place(it["real"])),
                torch.from_numpy(labels), 1.0,
                z=torch.from_numpy(it["z"]), eps=torch.from_numpy(it["eps"]),
                aug_draws=aug)
            metrics.append({k: float(v) for k, v in m.items()})
        # the state is whole and the same on every rank, bit for bit
        check_replica_consistency(state, label=name, group=WORLD)
        out[name] = {"metrics": metrics, "state": _flat_state(state)}
    return out


def _error(fn, *args):
    """``fn(*args)``'s ValueError message (None when it returns)."""
    try:
        fn(*args)
    except ValueError as e:
        return str(e)
    return None


def case_tp_units(inp, rank, world):
    """The grid's layout and subgroups, its errors, the state's blocks
    gathered back, and the consistency check over the grid."""
    from pgx_torch.models import zoo
    from pgx_torch.parallel import tp
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import TrainConfig
    out = {}
    mesh = tp.make_mesh_2d(1, world)
    out["grid"] = (mesh.n_data, mesh.n_model, mesh.d, mesh.m, mesh.rank)
    out["model_group"] = dist.get_process_group_ranks(mesh.model_group)
    out["data_group"] = dist.get_process_group_ranks(mesh.data_group)
    out["for_batch"] = tp.make_mesh_2d_for_batch(8, world).shape
    out["errors"] = {
        "too_few": _error(tp.make_mesh_2d, 2, world),
        "off_the_mesh": _error(tp.make_mesh_2d, 1, 1),
        "indivisible_model": _error(tp.make_mesh_2d_for_batch, 8, 3),
        "batch": _error(tp.make_mesh_2d_for_batch, 3, world)}
    # each rank on a host of its own: one process per host
    with mock.patch("socket.gethostname", lambda: f"host{rank}"):
        out["errors"]["model_axis_spans_hosts"] = _error(tp.make_mesh_2d, 1,
                                                         world)
    gcfg = zoo.conditional_correct_generator(**inp["gkw"])
    dcfg = zoo.conditional_correct_discriminator_wgangp(**inp["dkw"])
    state = _state_from(gcfg, dcfg, TrainConfig(), inp["state"])
    whole_bytes = tp.resident_bytes(state)
    tp.shard_state(mesh, state)
    out["bytes"] = (whole_bytes, tp.resident_bytes(state))
    out["shardings"] = tp.state_shardings(state, mesh)
    out["gathered"] = _flat_state(tp.gather_state(mesh, state))
    check_replica_consistency(state, label="sharded", mesh=mesh)
    if rank == 1:
        with torch.no_grad():
            state["opt_d"]["nu"][inp["perturb"]][..., 0] += 1e-7
    try:
        check_replica_consistency(state, label="sharded", mesh=mesh)
        out["perturbed"] = None
    except AssertionError as e:
        out["perturbed"] = str(e)
    return out


def _forms(mesh, state, rank):
    """The gather and the gradient reduction of the step in both forms
    (``'gloo'``: all_reduce alone; ``'nccl'``: all_gather_into_tensor,
    reduce_scatter_tensor and the data group's all_reduce), on the
    sharded state's blocks and on gradients that differ by rank."""
    from pgx_torch.parallel import collectives as coll
    from pgx_torch.parallel import tp
    mods = (state["g"], state["d"])
    blocks = [p.data for mod in mods for n, p in mod.named_parameters()
              if n in tp.sharded_names(mod)]
    wholes = {"gloo": coll._gather_gloo(mesh, blocks),
              "nccl": coll._gather_nccl(mesh, blocks)}
    gen = torch.Generator().manual_seed(100 + rank)
    shapes = [(*p.shape[:-1], p.shape[-1] * (mesh.n_model if n in
                                              tp.sharded_names(mod) else 1))
              for mod in mods for n, p in mod.named_parameters()]
    grads = [torch.randn(sh, generator=gen, dtype=torch.float64)
             for sh in shapes]
    flags = [n in tp.sharded_names(mod) for mod in mods
             for n, _ in mod.named_parameters()]
    # the gloo form averages in place: each form on its own copies
    reduced = {"gloo": coll._reduce_gloo(mesh, [g.clone() for g in grads],
                                         flags),
               "nccl": coll._reduce_nccl(mesh, [g.clone() for g in grads],
                                         flags)}
    return {
        "gather_bitwise": all(torch.equal(a, b) for a, b in
                              zip(wholes["gloo"], wholes["nccl"])),
        "gather_blocks_bitwise": all(
            torch.equal(w[..., mesh.m * b.shape[-1]:
                          (mesh.m + 1) * b.shape[-1]], b)
            for w, b in zip(wholes["gloo"], blocks)),
        "reduce_max_rel": max(
            float((a - b).abs().max() / b.abs().max())
            for a, b in zip(reduced["gloo"], reduced["nccl"])),
        "reduce_bitwise": all(torch.equal(a, b) for a, b in
                              zip(reduced["gloo"], reduced["nccl"])),
        "reduce_shapes": [tuple(t.shape) for t in reduced["gloo"]],
        "grads": [g.numpy() for g in grads],
        "reduced": [t.numpy() for t in reduced["gloo"]]}


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


def case_tp_loop(inp, rank, world):
    """train_loop on the (1, world) grid: a run with a checkpoint and
    sample grids beside the same run at model 1 (pure data parallelism
    over the same ranks), a resume at model 2 of each, both again in
    windows of 2 iterations, and the step-indexed store stopped and
    resumed at model 2.  Rank 0 copies the model-2 trial
    before it is resumed (the caller resumes the copy at model 1)."""
    import shutil
    from pgx_torch.data.datasets import synthetic_dataset
    from pgx_torch.parallel import broadcast_obj, tp
    from pgx_torch.parallel.stats import check_replica_consistency
    from pgx_torch.train import LoopConfig, ProperSchedule, TrainConfig
    from pgx_torch.train.loop import train_loop
    gcfg, dcfg = _tiny_pair()
    root = inp["root"] if rank == 0 else inp["root1"]
    ds = synthetic_dataset(n=64, size=32, channels=3, num_classes=3, seed=0)
    sched = ProperSchedule(images_seen_per_mini_step=16, batch_size=8,
                           max_step=3, init_step=2)
    checked = []

    def run(name, total, model, resume=None, **kw):
        mesh = tp.make_mesh_2d(1, world) if model > 1 else None

        def on_iteration(i, st, state, metrics):
            if i == total - 1:
                check_replica_consistency(state, label=f"{name} {i}",
                                          mesh=mesh)
                checked.append((name, i + 1, sorted(
                    tp.sharded_names(state["g"]))[:1]))
        trial = train_loop(
            gcfg, dcfg, TrainConfig(), sched, ds,
            LoopConfig(trial_name=name, main_path=os.path.join(root, name),
                       batch_size=8, sample_every=2, checkpoint_every=2,
                       log_every=2, total_iterations=total, verbose=False,
                       snapshot_sources=False, model_parallel=model, **kw),
            resume_dir=resume,
            # the hook turns windows off: the windowed runs go without
            hooks=({} if kw.get("steps_per_call") else
                   {"on_iteration": on_iteration}),
            device="cpu")
        return broadcast_obj(trial)

    out = {"trials": {}}
    out["trials"]["tp"] = run("tp", 4, world)
    out["trials"]["dp"] = run("dp", 4, 1)
    if rank == 0:
        shutil.copytree(out["trials"]["tp"], inp["copy"])
    dist.barrier()
    run("tp", 6, world, resume=out["trials"]["tp"])
    # a model-1 checkpoint resumed at model 2
    run("dp", 6, world, resume=out["trials"]["dp"])
    # windows of 2 iterations (make_train_multi_step over the grid)
    out["trials"]["tp_window"] = run("tp_window", 4, world, steps_per_call=2)
    out["trials"]["dp_window"] = run("dp_window", 4, 1, steps_per_call=2)
    store = run("store", 2, world, checkpoint_backend="orbax")
    out["trials"]["store"] = run("store", 4, world, resume=store,
                                 checkpoint_backend="orbax")
    out["checked"] = checked
    out["files"] = sorted(os.path.relpath(os.path.join(d, f), root)
                          for d, _, fs in os.walk(root) for f in fs)
    return out


def broadcast_trial(trial):
    from pgx_torch.parallel import broadcast_obj
    return broadcast_obj(trial)


def cut_loop_config(total):
    """``loop_config_from_args`` patched to stop the run at ``total``
    iterations (a context manager)."""
    import dataclasses
    from pgx_torch.cli import common
    original = common.loop_config_from_args
    return mock.patch.object(
        common, "loop_config_from_args",
        lambda args, **kw: dataclasses.replace(original(args, **kw),
                                               total_iterations=total))


def case_cli(inp, rank, world):
    """A family trainer with --multihost: it joins the group itself
    (stopped at ``inp['total']`` iterations when given)."""
    import contextlib
    from pgx_torch.cli import conditional_proper_cifar_train as cli
    root = inp["root"] if rank == 0 else inp["root1"]
    argv = inp["argv"] + ["--output", root, "--multihost",
                          "--coordinator-address", inp["address"],
                          "--num-processes", str(world),
                          "--process-id", str(rank)]
    with (cut_loop_config(inp["total"]) if inp.get("total")
          else contextlib.nullcontext()):
        trial = cli.main(argv)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    return {"trial": trial, "files": files,
            "world": dist.get_world_size(), "backend": dist.get_backend()}


def case_cli_hosts(inp, rank, world):
    """The trainer's --multihost launch with --model-parallel when every
    rank runs on a host of its own: the grid refuses it on every rank."""
    with mock.patch("socket.gethostname", lambda: f"host{rank}"):
        try:
            case_cli(inp, rank, world)
        except ValueError as e:
            return {"error": str(e), "world": dist.get_world_size()}
    return {"error": None}


CASES = {n[len("case_"):]: f for n, f in globals().items()
         if n.startswith("case_")}


def main():
    case, rank, world, port, d = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    with open(os.path.join(d, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    global WORLD
    if not case.startswith("cli"):
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
