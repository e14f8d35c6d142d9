"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a workload of ``BENCHMARK.json``; its configuration, traffic
mix, limits and per-layer metric readers are files under ``perfbench/``
found by name.  The run makes its weights and inputs from ``--seed``, warms
up every shape it will use (set-up), measures for ``--seconds``, checks
what the timed path produced against the plain reference and prints one
JSON line.  ``--trace 1`` adds two profiled segments after the window and
reports the per-layer metrics in place of the end-to-end ones.

Options for the control and the planted faults (not used by a measured
run): ``--control fp8`` puts the reference in float8 in the program's
place; ``--fault NAME`` breaks the timed path (``unchanged``,
``half_batch``, ``g_sign``, ``ema_unchanged``, ``alter_image``);
``--manifest`` reads another ``BENCHMARK.json``; ``--device cpu`` runs on
the CPU at a test's size.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(_var, str(ROOT / "build" / _sub))

from perfbench.lib import common  # noqa: E402

FAULTS = ("unchanged", "half_batch", "g_sign", "ema_unchanged",
          "alter_image")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    ap.add_argument("--manifest", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _metrics(cell, out, trace: bool) -> dict:
    if not trace:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        return {k: {"value": v, "unit": units[k]}
                for k, v in out["e2e"].items()
                if k in units and v is not None}
    got = {}
    for m in cell.per_layer:
        value = common.load_reader(m["name"], cell.root)(out["ctx"])
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def result_of(torch, cell, args, out) -> tuple:
    """(result line without its checks, checks)."""
    checks = common.judged(out["numbers"] or {}, cell.limits)
    failed = int(out.get("failed", 0))
    correct = all(c["ok"] for c in checks.values()) and failed == 0
    device = common.device_info(torch, cell.chips, out["peak"])
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": failed, "metrics": {}, "device": device}
    if args.control:
        return result, checks
    result["metrics"] = _metrics(cell, out, bool(args.trace))
    summary = out.get("summary")
    if args.trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    return result, checks


def main(argv=None, require_chip: bool = True) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    try:
        cell = common.load_cell(args.workload, args.manifest)
        import torch
        if require_chip:
            common.check_devices(torch, cell.chips)
        kind = cell.mix["kind"]
        if kind == "train":
            from perfbench.lib import train as runner
        elif kind == "serve":
            from perfbench.lib import serve as runner
        else:
            raise common.RunError(f"no runner for traffic kind {kind!r}")
        out = runner.run(torch, cell, args, T_START, args.device)
    except (common.RunError, OSError, ImportError) as exc:
        # no card, a file of the benchmark missing, or no program to run
        print(f"perfbench: {exc}", file=sys.stderr)
        return 2
    found = common.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}: the benchmark runs the "
              f"port alone", file=sys.stderr)
        return 3
    result, checks = result_of(torch, cell, args, out)
    others = {k: v for k, v in (out["numbers"] or {}).items()
              if k not in checks}
    common.emit_result(result, checks, others)
    return 0


if __name__ == "__main__":
    sys.exit(main())
