"""The benchmark's yardstick on the CPU: the plain reference against the
port's plain path (float32, a few channels), the model FLOP count against
``torch.utils.flop_counter``, and the roofline table against
``chip_smoke.py``'s kernel arithmetic.

    python -m pytest perfbench/tests -q
"""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import flops  # noqa: E402
from perfbench.lib import checks, inputs, program, roofline  # noqa: E402
from perfbench.lib import train as train_runner  # noqa: E402
from perfbench.reference import nets  # noqa: E402
from perfbench.reference.step import Trainer  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

CELLS = {"flagship": ("pgan128_flagship", "train_b32"),
         "recipe": ("pgan512_recipe", "train_ada_b8_k8")}


def _load(path):
    with open(ROOT / path) as f:
        return json.load(f)


def _cfg(name: str, dtype: str = "float32", stages: int = 3):
    cfg_name, mix_name = CELLS[name]
    cfg = tiny.tiny_config(_load(f"perfbench/configs/{cfg_name}.json"),
                           stages, 8)
    for net in ("generator", "discriminator"):
        cfg[net]["dtype"] = dtype
    mix = _load(f"perfbench/traffic/{mix_name}.json")
    mix.update(step=stages, batch=4, pool=8 * int(mix.get("multi_step", 1)))
    return program.effective(cfg, mix), mix


def test_nets_forward_match_the_port():
    from pgx_torch.models.discriminator import Discriminator
    from pgx_torch.models.generator import Generator
    cfg, mix = _cfg("flagship")
    gcfg, dcfg, _ = program.configs(cfg)
    g_init, d_init = inputs.make_weights(torch, cfg, 11, "cpu")
    gen, disc = Generator(gcfg), Discriminator(dcfg)
    gen.load_state_dict(g_init)
    disc.load_state_dict(d_init)
    feed = inputs.Feed(torch, "cpu", 11, cfg, mix)
    real, labels, z, _, _ = feed.batch_of(0)
    with torch.no_grad():
        want_g = gen(z, labels, step=cfg["step"])
        got_g = nets.generator(g_init, cfg["generator"], z, labels,
                               cfg["step"])
        want_d = disc(real, labels, step=cfg["step"]).reshape(-1)
        got_d = nets.discriminator(d_init, cfg["discriminator"], real,
                                   labels, cfg["step"])
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_iteration_matches_the_port(name):
    """The compared iterations (the window's call) against the reference's
    replay, in float32: every number reads round-off."""
    cfg, mix = _cfg(name, stages=3 if name == "flagship" else 4)
    feed = inputs.Feed(torch, "cpu", 12, cfg, mix)
    g_init, d_init = inputs.make_weights(torch, cfg, 12, "cpu")
    prog = train_runner._Program(torch, cfg, mix, feed, g_init, d_init,
                                 "cpu")
    prog.first_calls()
    want = train_runner._replay(torch, cfg, mix, feed, g_init, d_init,
                                nets.Prec())
    got = checks.train_numbers(prog.capture, want)
    for key, value in got.items():
        assert value < 1e-4, (key, got)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_flops_count_matches_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode
    cfg, mix = _cfg(name)
    cfg["augment"] = None        # the pipe's matrices are not model FLOPs
    feed = inputs.Feed(torch, "cpu", 13, cfg, mix)
    g_init, d_init = inputs.make_weights(torch, cfg, 13, "cpu")
    tr = Trainer(g_init, d_init, cfg)
    for apply_gp in (True, False):
        real, labels, z, eps, _ = feed.batch_of(0)
        with FlopCounterMode(display=False) as fc:
            tr.step(real, labels, z, eps, None, apply_gp=apply_gp)
        want = 2 * flops.iteration_macs(cfg, apply_gp) * real.shape[0]
        assert fc.get_total_flops() == pytest.approx(want, rel=1e-4)


def test_generate_flops_matches_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    cfg, mix = _cfg("flagship")
    g_init, _ = inputs.make_weights(torch, cfg, 14, "cpu")
    z = torch.randn(3, cfg["generator"]["z_dim"])
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        nets.generator(g_init, cfg["generator"], z,
                       torch.zeros(3, dtype=torch.long), cfg["step"])
    want = 3 * flops.generate_flops_per_image(cfg)
    assert fc.get_total_flops() == pytest.approx(want, rel=1e-9)


# chip_smoke.py's per-launch arithmetic (kernel_phase, second_order_phase,
# tangent_phase): ops and bytes of each kernel call from its shapes
def _chip_smoke_seconds(name, shape, es, wshape=None, extra=None):
    n = math.prod(shape)
    c = shape[-1]
    hbm, f32, bf16 = 3.35e12, 67e12, 989e12
    if name in ("bias_pixelnorm_lrelu", "pixel_norm_lrelu"):
        return max(6.0 * n / f32, (2 * n * es + c * es) / hbm)
    if name == "conv3x3_epilogue":
        cout = wshape[-1]
        m = n // c
        peak = bf16 if es == 2 else f32
        return max(2.0 * m * 9 * c * cout / peak,
                   (n + 9 * c * cout + cout + m * cout) * es / hbm)
    if name == "bias_pixelnorm_lrelu_bwd":
        return max(10.0 * n / f32, (3 * n * es + c * es + c * 4) / hbm)
    if name == "bias_pixelnorm_lrelu_bwd2":
        has_ddy, has_ddb, needs = extra
        full = 2 + has_ddy + needs[0] + needs[2]
        return max(30.0 * n / f32,
                   (full * n * es + c * es + c * 4 * (has_ddb + needs[1]))
                   / hbm)
    if name == "bias_pixelnorm_lrelu_jvp":
        return (3 * n * es + c * es * (1 + extra)) / hbm
    raise KeyError(name)


@pytest.mark.parametrize("es,tname", [(2, "c10::BFloat16"), (4, "float")])
def test_roofline_matches_chip_smoke(es, tname):
    x = [32, 64, 64, 256]
    cases = [
        ("bias_pixelnorm_lrelu", [x, [256]], None, None),
        ("pixel_norm_lrelu", [x], None, None),
        ("conv3x3_epilogue", [x, [3, 3, 256, 128], [128]], None, None),
        ("bias_pixelnorm_lrelu_bwd", [x, [256], x], None, None),
        ("bias_pixelnorm_lrelu_bwd2", [x, [256], x, x, []],
         ["", "", "", "", "", "", "", "[True, False, True]"],
         (1, 0, [True, False, True])),
        ("bias_pixelnorm_lrelu_jvp", [x, [256], x, [256]], None, 1),
    ]
    for name, dims, concrete, extra in cases:
        got = roofline.call_seconds(name, dims, [tname] * len(dims),
                                    concrete)
        want = _chip_smoke_seconds(name, x, es, dims[-1], extra)
        assert got == pytest.approx(want, rel=1e-12), name


def test_roofline_shear_matches_chip_smoke(monkeypatch):
    """Kernel F's bytes and operations as ``chip_smoke.fde_case`` counts
    them (run on the CPU)."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    shape = (2, 3, 64, 128)
    rng = torch.Generator().manual_seed(0)
    _, _, _, nbytes, ops = chip_smoke.fde_case(
        torch, "shift_1d", shape, {"axis": 3}, torch.bfloat16, rng)
    want = max(nbytes / roofline.HBM_BYTES_PER_S,
               ops / roofline.F32_ELEMENTWISE_OPS)
    got = roofline.call_seconds("shift_1d", [list(shape), [2, 64]],
                                ["c10::BFloat16", "float"])
    assert got == pytest.approx(want, rel=1e-12)


def test_import_check_compares_whole_top_level_names():
    from perfbench.lib import common
    assert common.forbidden_modules(
        ["pgx_torch", "pgx_torch.serve", "pgxtools", "numpy"]) == []
    assert common.forbidden_modules(
        ["pgx.models.zoo", "jaxlib.xla_client", "flax", "jax"]) == [
        "flax", "jax", "jaxlib", "pgx"]
