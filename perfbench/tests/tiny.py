"""A benchmark tree at a size a CPU test holds: the manifest's cells on
configurations cut to a few channels and stages, in a directory of its
own (``BENCHMARK.json`` with ``perfbench/`` beside it), the harness's
metric readers copied in."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _load(path):
    with open(path) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_config(cfg: dict, stages: int, width: int = 16) -> dict:
    """``cfg`` with every width cut to ``width`` and ``stages`` stages."""
    out = copy.deepcopy(cfg)
    g, d = out["generator"], out["discriminator"]
    g.update(z_dim=width, embed_dim=width, channels=[width] * stages,
             max_step=stages)
    d.update(stage_in=[width] * stages, stage_out=[width] * stages,
             max_step=stages)
    return out


def build(dst: Path, cells=None, seconds: float = 1.0) -> Path:
    """The tiny tree under ``dst``; returns its manifest."""
    bench = _load(ROOT / "BENCHMARK.json")
    if cells is not None:
        bench["workloads"] = [w for w in bench["workloads"]
                              if w["name"] in cells]
    pb = dst / "perfbench"
    shutil.copytree(HERE / "metrics", pb / "metrics")
    for c in bench["configs"]:
        cfg = _load(ROOT / c["file"])
        stages = 3 if cfg["generator"]["max_step"] <= 6 else 4
        _dump(tiny_config(cfg, stages), dst / c["file"])
    for w in bench["workloads"]:
        mix = _load(HERE / "traffic" / f"{w['traffic']}.json")
        cfg = _load(dst / next(c["file"] for c in bench["configs"]
                               if c["name"] == w["config"]))
        mix["step"] = cfg["generator"]["max_step"]
        if mix["kind"] == "train":
            mix.update(batch=4, pool=8 * int(mix.get("multi_step", 1)),
                       warmup_calls=1, trace_calls=1)
        else:
            mix.update(max_batch=8, sizes={"8": 2, "2": 1, "1": 1},
                       z_pool=64, sample=4, sample_from=6, clients=2,
                       warmup_s=0.2, trace_s=0.3)
        _dump(mix, pb / "traffic" / f"{w['traffic']}.json")
        _dump(_load(HERE / "limits" / f"{w['name']}.json"),
              pb / "limits" / f"{w['name']}.json")
    _dump(bench, dst / "BENCHMARK.json")
    return dst / "BENCHMARK.json"
