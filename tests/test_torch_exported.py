"""``pgx_torch.export`` and ``pgx_torch.cli.export_model`` against
``pgx.export`` on the CPU.

One tiny trial, written by pgx (``conditional_correct_generator(z_dim=8,
num_classes=3, channel=32, max_step=5)``, pgx's seeded weights, f32, the
checkpoint at iteration 6 of ``ProperSchedule(8, 4, 5, 4)``: step 5 (64px),
fading at alpha 0.5), is exported by both packages at buckets (1, 8), in
float and uint8 output: pgx lowers it to StableHLO (run on the CPU as
tests/test_export.py runs it), the port reads the same npz and exports it
with ``torch.export`` (``device="cpu"``: the kernels' ops take their plain
versions).  The manifests agree field for field but ``platforms``.
Tolerances: float output 1e-5 absolute and relative (f32 on both sides;
the convs and their sums run in other orders), uint8 output within one
level (a value that lands on a rounding edge in one package may round the
other way in the other).  The exported graph holds kernel A's, B's and
C's ops in the numbers ``chip_smoke.g_calls_per_forward`` gives (every
width here is a multiple of 8, so the routing rules send every call to the
kernels); a fresh interpreter loads the artifact with no model, layer or
training module, no pgx and no JAX.
"""

import io
import json
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from pgx import checkpoint as jckpt
from pgx import export as jexport
from pgx.models import init_generator as jinit_generator
from pgx.models import zoo as jzoo
from pgx.train import ProperSchedule, TrainConfig
from pgx.train.schedule import schedule_to_dict
from pgx_torch import export as texport
from pgx_torch.cli import export_model as cli
from pgx_torch.models import zoo as tzoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(z_dim=8, num_classes=3, channel=32, max_step=5)
BUCKETS = (1, 8)
ITERATION = 6                 # state_at(5): step 5, fading, alpha 0.5
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def trial(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trial") / "trial_exp")
    gcfg = jzoo.conditional_correct_generator(**KW)
    dcfg = jzoo.conditional_correct_discriminator_wgangp(
        feat_dim=8, num_classes=3, max_step=5)
    jckpt.save_config(root, gcfg, dcfg, TrainConfig(), extra={
        "schedule": schedule_to_dict(ProperSchedule(8, 4, 5, 4))},
        postfix="exp")
    os.makedirs(os.path.join(root, "checkpoint"))
    params = jax.device_get(jinit_generator(jax.random.PRNGKey(0), gcfg))
    jckpt.save_params(os.path.join(root, "checkpoint",
                                   jckpt.checkpoint_name(ITERATION, "g")),
                      params)
    return root


@pytest.fixture(scope="module")
def artifacts(trial, tmp_path_factory):
    """{(package, output): (path, manifest)} for float and uint8."""
    out = {}
    for output in ("float", "uint8"):
        d = tmp_path_factory.mktemp(output)
        out["pgx", output] = (str(d / "pgx"), jexport.export_trial(
            trial, str(d / "pgx"), batch_sizes=BUCKETS, output=output))
        out["port", output] = (str(d / "port"), texport.export_trial(
            trial, str(d / "port"), batch_sizes=BUCKETS, output=output,
            device="cpu"))
    return out


def _loaded(artifacts, output):
    return (jexport.load_exported(artifacts["pgx", output][0]),
            texport.load_exported(artifacts["port", output][0]))


def _inputs(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, KW["z_dim"]).astype(np.float32),
            rng.randint(0, KW["num_classes"], n).astype(np.int32))


def _assert_agree(got, want, output):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if output == "uint8":
        assert int(np.abs(got.astype(np.int16) - want.astype(np.int16))
                   .max()) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("output", ["float", "uint8"])
def test_manifest_matches_pgx(artifacts, output):
    (jpath, jman), (tpath, tman) = (artifacts["pgx", output],
                                    artifacts["port", output])
    assert tman.keys() == jman.keys()
    assert {k: v for k, v in tman.items() if k != "platforms"} == {
        k: v for k, v in jman.items() if k != "platforms"}
    assert tman["platforms"] == ["cpu"] and jman["platforms"] is None
    assert (tman["resolution"], tman["step"], tman["fading"],
            tman["alpha"]) == (64, 5, True, 0.5)
    with open(os.path.join(jpath, "manifest.json")) as f:
        jdisk = json.load(f)
    with open(os.path.join(tpath, "manifest.json")) as f:
        tdisk = json.load(f)
    jdisk.pop("platforms"), tdisk.pop("platforms")
    assert tdisk == jdisk
    assert tdisk["batch_sizes"] == list(BUCKETS)
    assert sorted(os.listdir(tpath)) == [
        "gen_b1.pt2", "gen_b8.pt2", "manifest.json"]


@pytest.mark.parametrize("output", ["float", "uint8"])
@pytest.mark.parametrize("n", [1, 8, 5, 20])
def test_generate_matches_pgx(artifacts, output, n):
    """Exact buckets (1, 8), padding (5 -> 8) and chunking (20 -> 8 + 8 +
    4 padded to 8) against pgx's loader; padded and chunked rows equal the
    port's own calls of the 8-bucket on full chunks bit for bit (other rows
    in the padding change nothing)."""
    jgen, tgen = _loaded(artifacts, output)
    z, labels = _inputs(n, seed=n)
    got = tgen.generate(z, labels)
    _assert_agree(got, jgen.generate(z, labels), output)
    if n in (5, 20):
        zx, lx = _inputs(24, seed=99)
        zx[:n], lx[:n] = z, labels
        full = np.concatenate([tgen.generate(zx[i:i + 8], lx[i:i + 8])
                               for i in range(0, 24, 8)])
        np.testing.assert_array_equal(got, full[:n])


@pytest.mark.parametrize("kw", [dict(class_id=1), dict(), dict(
    labels=[2, 0, 1, 1, 2, 0, 0])])
def test_sample_matches_pgx(artifacts, kw):
    jgen, tgen = _loaded(artifacts, "float")
    n = len(kw.get("labels", range(7)))
    _assert_agree(tgen.sample(n, seed=3, **kw), jgen.sample(n, seed=3, **kw),
                  "float")


def test_unconditional_export_and_sample_match_pgx(tmp_path):
    gcfg = jzoo.correct_generator(z_dim=8, channel=8, max_step=3)
    params = jax.device_get(jinit_generator(jax.random.PRNGKey(1), gcfg))
    tcfg = tzoo.correct_generator(z_dim=8, channel=8, max_step=3)
    manifest = {"z_dim": 8, "num_classes": 0, "conditional": False,
                "resolution": 16, "output": "float"}
    jexport.save_exported(str(tmp_path / "pgx"), jexport.export_generator(
        gcfg, params, step=3, output="float", batch_sizes=(2,)), manifest)
    texport.save_exported(str(tmp_path / "port"), texport.export_generator(
        tcfg, params, step=3, output="float", batch_sizes=(2,),
        device="cpu"), dict(manifest, platforms=["cpu"]))
    jgen = jexport.load_exported(str(tmp_path / "pgx"))
    tgen = texport.load_exported(str(tmp_path / "port"))
    _assert_agree(tgen.sample(3, seed=5), jgen.sample(3, seed=5), "float")


def test_exported_graph_holds_the_kernels_ops(artifacts):
    path = artifacts["port", "float"][0]
    with open(os.path.join(path, "gen_b8.pt2"), "rb") as f:
        program = torch.export.load(io.BytesIO(f.read()))
    ops = Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                  if n.op == "call_function"
                  and str(n.target).startswith("pgx_torch."))
    want = chip_smoke.g_calls_per_forward(tzoo.conditional_correct_generator(
        **KW), 5)
    assert want == {chip_smoke.A: 1, chip_smoke.B: 1, chip_smoke.C: 8}
    assert dict(ops) == want


def test_loading_needs_no_model_code(artifacts):
    path = artifacts["port", "uint8"][0]
    code = (
        "import json, sys\n"
        "from pgx_torch.export import load_exported\n"
        f"gen = load_exported({path!r})\n"
        "img = gen.sample(3, seed=0, class_id=1)\n"
        "assert img.shape == (3, 64, 64, 3) and img.dtype.name == 'uint8'\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in\n"
        "                        ('jax', 'pgx', 'pgx_torch'))))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    held = json.loads(out.stdout.splitlines()[-1])
    assert not [m for m in held if m.split(".")[0] in ("jax", "pgx")]
    assert not [m for m in held if m.startswith(
        ("pgx_torch.models", "pgx_torch.core", "pgx_torch.train"))]
    assert "pgx_torch.ops.kernels.conv_epilogue" in held


def test_a_cuda_artifact_needs_a_card(artifacts, trial, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "cuda")
    os.makedirs(path)
    src = artifacts["port", "float"][0]
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(dict(manifest, platforms=["cuda"]), f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.load_exported(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.export_trial(trial, str(tmp_path / "out"))


def test_cli_verify(trial, tmp_path, capsys):
    out = str(tmp_path / "cli.pgx")
    cli.main(["--trial", trial, "--out", out, "--batch-sizes", "2",
              "--output", "uint8", "--device", "cpu", "--verify"])
    printed = capsys.readouterr().out
    assert "verify: sampled (2, 64, 64, 3) uint8" in printed
    manifest = json.loads(printed[:printed.index("verify:")])
    assert manifest["platforms"] == ["cpu"]
    assert os.path.exists(os.path.join(out, "gen_b2.pt2"))
