"""The output check's own failures, and the harness's growth by files alone,
at a size a CPU test holds (``tiny``).

The control (the reference in float8 in the program's place) and each
fault a cell can have, planted under the timed path, must come out
``"correct": false`` through the rest of a run (the look for a card
skipped, ``--device cpu``).  A cell added from new files only, into a copy
of the manifest, is listed and run.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402
from perfbench.lib import common  # noqa: E402
from perfbench.tests import tiny  # noqa: E402

SEED = "3000000019"          # past 2**31: a seed need not fit 32 bits


def _run(capsys, manifest, cell, *extra):
    rc = run.main(["--workload", cell, "--seed", SEED, "--seconds", "0.5",
                   "--device", "cpu", "--manifest", str(manifest), *extra],
                  require_chip=False)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["pgan128.train", "pgan512.train_ada",
                                  "pgan128.serve"])
def test_control_comes_out_not_correct(capsys, tmp_path, cell):
    """At this size the limits are set as on the card: from the program's
    own reading (twice it; an exact number keeps 0), then the control must
    fail one of them and the program pass."""
    manifest = tiny.build(tmp_path, cells=[cell])
    rc, sound = _run(capsys, manifest, cell)
    assert rc == 0
    limits = {k: (2 * c["value"] if c["limit"] else 0)
              for k, c in sound["checks"].items()}
    path = tmp_path / "perfbench" / "limits" / f"{cell}.json"
    path.write_text(json.dumps(limits))
    rc, again = _run(capsys, manifest, cell)
    assert rc == 0 and again["correct"] is True, again["checks"]
    rc, control = _run(capsys, manifest, cell, "--control", "fp8")
    assert rc == 0 and control["correct"] is False, control["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("pgan128.train", "unchanged"), ("pgan128.train", "half_batch"),
    ("pgan128.train", "g_sign"), ("pgan128.train", "ema_unchanged"),
    ("pgan512.train_ada", "unchanged"), ("pgan512.train_ada", "half_batch"),
    ("pgan512.train_ada", "g_sign"), ("pgan512.train_ada", "ema_unchanged"),
    ("pgan128.serve", "alter_image")])
def test_faults_come_out_not_correct(capsys, tree, cell, fault):
    """Each fault the cell can have, under the cell's own limits: the
    state left unchanged, half of the batch, G's gradient negated (which
    Adam's step alone does not show), an EMA never updated, an image
    altered."""
    rc, result = _run(capsys, tree, cell, "--fault", fault)
    assert rc == 0
    assert result["correct"] is False, result["checks"]
    assert list(result)[-1] == "checks"


def test_result_line_keys(capsys, tree):
    rc, result = _run(capsys, tree, "pgan128.serve")
    assert rc == 0
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert set(result["metrics"]) == {"setup_s", "serve_img_per_s",
                                      "serve_p95_ms", "peak_mem_gib"}


def test_every_per_layer_metric_has_a_reader():
    """Each per-layer metric of the manifest loads its reader, which finds
    nothing to read in an empty run."""
    bench = common.load_json(ROOT / "BENCHMARK.json")
    for m in bench["per_layer"]:
        assert common.load_reader(m["name"])({}) is None, m["name"]


def test_a_cell_added_from_files_alone(capsys, tmp_path):
    """A throwaway configuration, mix, per-layer metric and cell: new files
    and manifest entries only."""
    manifest = tiny.build(tmp_path, cells=["pgan128.train"])
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}
    bench = json.loads(manifest.read_text())
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "pgan128_flagship.json").read_text())
    cfg["generator"]["channels"] = [8, 8]
    cfg["generator"].update(max_step=2, z_dim=8, embed_dim=8)
    cfg["discriminator"].update(stage_in=[8, 8], stage_out=[8, 8],
                                max_step=2)
    (pb / "configs" / "toy.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "train_b32.json").read_text())
    mix.update(step=2, batch=2, pool=4)
    (pb / "traffic" / "toy_b2.json").write_text(json.dumps(mix))
    (pb / "limits" / "toy.train.json").write_text(
        json.dumps({"change_gap": 1e9}))
    (pb / "metrics" / "toy_images.py").write_text(
        "def read(ctx):\n    return float(ctx['images'])\n")
    bench["configs"].append({"name": "toy", "source": "https://example.org",
                             "file": "perfbench/configs/toy.json",
                             "reduced": [], "why": "a throwaway"})
    bench["workloads"].append({"name": "toy.train", "config": "toy",
                               "traffic": "toy_b2", "chips": 1,
                               "why": "a throwaway"})
    bench["end_to_end"][1]["workloads"].append("toy.train")
    bench["per_layer"].append({"name": "toy_images", "unit": "img",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step", "moves":
                               "train_img_per_s", "workloads": ["toy.train"]})
    manifest.write_text(json.dumps(bench))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in tmp_path.rglob("*") if p.is_file()}
    changed = {k for k in before if after[k] != before[k]}
    assert changed == {Path("BENCHMARK.json")}
    cell = common.load_cell("toy.train", manifest)
    assert [m["name"] for m in cell.per_layer] == ["toy_images"]
    rc, result = _run(capsys, manifest, "toy.train")
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"setup_s", "train_img_per_s",
                                      "peak_mem_gib"}
    ctx = {"images": 6.0}
    assert common.load_reader("toy_images", pb)(ctx) == 6.0


def test_the_harness_refuses_without_its_files(tmp_path, capsys):
    """A directory with the manifest and nothing else: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    rc = run.main(["--workload", "pgan128.train", "--seed", SEED,
                   "--seconds", "1", "--device", "cpu", "--manifest",
                   str(tmp_path / "BENCHMARK.json")], require_chip=False)
    assert rc != 0
    assert capsys.readouterr().out == ""
