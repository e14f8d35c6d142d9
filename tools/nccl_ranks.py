"""chip_smoke.py's phase 11 (``ddp``) and phase 12 (``tp``) rank work over
NCCL, one rank per card, on a machine with two or more cards:

    python3 tools/nccl_ranks.py [ddp] [tp]

Builds the kernel library, then for each phase starts two ranks (rank r on
``cuda:r``, NCCL over ``tcp://127.0.0.1``) that run ``ddp_rank_work`` /
``tp_rank_work`` unchanged: the step's collectives take their NCCL forms
(``all_reduce``; ``all_gather_into_tensor`` and ``reduce_scatter_tensor``).
Prints one JSON line per phase with both ranks' reports, then the cards'
names and power limits.  chip_smoke.py itself stays a one-card script."""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pgx_torch.ops.kernels import build  # noqa: E402

WORLD = 2


def rank_main(argv):
    rank, port, root, work = int(argv[0]), int(argv[1]), argv[2], argv[3]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    build.load_library()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=WORLD, rank=rank,
                            device_id=torch.device("cuda", rank))
    fn = {"ddp": cs.ddp_rank_work, "tp": cs.tp_rank_work}[work]
    report = fn(torch, rank, WORLD, root)
    with open(os.path.join(root, f"{work}{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)


def main():
    t0 = time.monotonic()
    build.load_library()
    cs.emit({"phase": "build", "seconds": time.monotonic() - t0,
             "cards": torch.cuda.device_count()})
    for work in sys.argv[1:] or ["ddp", "tp"]:
        root = tempfile.mkdtemp(prefix=f"nccl_{work}_")
        port = cs.free_port()
        t1 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             str(port), root, work], env={**os.environ, "PYTHONPATH": HERE})
            for r in range(WORLD)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
            reports = []
            for r in range(WORLD):
                path = os.path.join(root, f"{work}{r}.json")
                reports.append(json.load(open(path))
                               if os.path.exists(path) else None)
                # the recorded kernel calls are chip_smoke.py's to hold
                (reports[-1] or {}).pop("recorded_calls", None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(root, ignore_errors=True)
        cs.emit({"phase": f"nccl_{work}", "rcs": rcs,
                 "seconds": time.monotonic() - t1, "ranks": reports})
        cs.require(rcs == [0] * WORLD, f"{work} ranks {rcs}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
