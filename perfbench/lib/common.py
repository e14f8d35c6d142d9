"""What every run shares: the manifest and a cell's files, seeds, the
device checks, the import check and the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = HERE.parent                                  # the checkout
GIB = float(1 << 30)
FORBIDDEN = ("jax", "jaxlib", "flax", "pgx")


class RunError(RuntimeError):
    """A run that must end without a result line."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its configuration, traffic mix,
    limits and the metrics it reports."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path = HERE


def _applies(metric: dict, cell: str, reported: Optional[List[str]] = None
             ) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, manifest: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of another manifest,
    whose ``perfbench/`` beside it holds the files): its configuration
    file, ``traffic/<mix>.json`` and ``limits/<cell>.json``."""
    manifest = Path(manifest or ROOT / "BENCHMARK.json")
    root = manifest.parent / "perfbench"
    bench = load_json(manifest)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in {manifest.name}: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(manifest.parent / configs[w["config"]]["file"])
    mix = load_json(root / "traffic" / f"{w['traffic']}.json")
    limits = load_json(root / "limits" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), cfg, mix, limits, e2e, per_layer,
                root)


def load_reader(name: str, root: Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``, the per-layer metric's reader."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of a run (SplitMix64 over the run's
    seed and the stream's keys): any whole ``seed`` gives the same streams
    on every machine."""
    x = int(seed) & ((1 << 64) - 1)
    for k in keys + (0x5EED,):
        x = (x + 0x9E3779B97F4A7C15 + int(k)) & ((1 << 64) - 1)
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
        x = z ^ (z >> 31)
    return x >> 1


def check_devices(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} here")


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole: ``pgx_torch``
    is not ``pgx``."""
    tops = {m.split(".", 1)[0] for m in list(names or sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def device_info(torch, chips: int, peak_bytes: int) -> dict:
    if torch.cuda.is_available():
        kind, platform = torch.cuda.get_device_name(0), "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def emit_result(result: dict, checks: Dict[str, dict],
                others: Optional[Dict[str, float]] = None) -> None:
    """The numbers computed and not compared (``others``), then the checks,
    on standard error, the checks the last lines there; then the result
    line, the checks last in it, as the last line of standard output."""
    for name, v in (others or {}).items():
        print(f"number {name} = {v!r} (not compared)", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "checks": checks}), flush=True)


def judged(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    """Each compared number beside its limit; a number missing or not
    finite is judged as failing."""
    out = {}
    for name, limit in limits.items():
        v = values.get(name)
        ok = v is not None and math.isfinite(v) and v <= limit
        out[name] = {"value": v, "limit": limit, "ok": ok}
    return out
