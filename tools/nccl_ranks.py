"""chip_smoke.py's phase 11 (``ddp``) and phase 12 (``tp``, ``spatial``)
rank work over NCCL, one rank per card, on a machine with two or more
cards:

    python3 tools/nccl_ranks.py [--world N] [ddp] [tp] [spatial]

Builds the kernel library, then for each phase starts ``N`` ranks (2 by
default; rank r on ``cuda:r``, NCCL over ``tcp://127.0.0.1``) that run
chip_smoke.py's rank work unchanged, the step's collectives in their NCCL
forms (``all_reduce``; ``all_gather_into_tensor`` and
``reduce_scatter_tensor``; the halo exchange's ``batch_isend_irecv``):

* ``ddp``: ``ddp_rank_work`` at world N;
* ``tp``: ``tp_rank_work`` on the channel-sharded grid, (1, 2) at world 2
  and (N / 2, 2) at larger worlds (the (2, 2) grid at world 4), without
  its spatial part;
* ``spatial``: ``spatial_rank_work`` on the (1, N) spatial grid.

Prints one JSON line per phase with every rank's report, then the cards'
names and power limits.  chip_smoke.py itself stays a one-card script."""
import functools
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

PHASES = ("ddp", "tp", "spatial")


def rank_work(work: str, world: int):
    """The chip_smoke.py rank function of a phase at ``world`` ranks."""
    if work == "ddp":
        return cs.ddp_rank_work
    if work == "tp":
        return functools.partial(cs.tp_rank_work, n_model=2, spatial=False)
    return cs.spatial_rank_work


def rank_main(argv):
    rank, world, port, root, work = (int(argv[0]), int(argv[1]),
                                     int(argv[2]), argv[3], argv[4])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(rank)
    build.load_library()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            device_id=torch.device("cuda", rank))
    report = rank_work(work, world)(torch, rank, world, root)
    with open(os.path.join(root, f"{work}{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    sys.stdout.flush()
    os._exit(0)


def main(argv):
    world = 2
    if argv[:1] == ["--world"]:
        world, argv = int(argv[1]), argv[2:]
    works = argv or list(PHASES)
    cs.require(set(works) <= set(PHASES), f"phases {works}: {PHASES}")
    cs.require(torch.cuda.device_count() >= world,
               f"world {world} needs {world} cards, "
               f"{torch.cuda.device_count()} here")
    t0 = time.monotonic()
    build.load_library()
    cs.emit({"phase": "build", "seconds": time.monotonic() - t0,
             "cards": torch.cuda.device_count(), "world": world})
    for work in works:
        root = tempfile.mkdtemp(prefix=f"nccl_{work}_")
        port = cs.free_port()
        t1 = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             str(world), str(port), root, work],
            env={**os.environ, "PYTHONPATH": HERE})
            for r in range(world)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
            reports = []
            for r in range(world):
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
        cs.emit({"phase": f"nccl_{work}", "world": world, "rcs": rcs,
                 "seconds": time.monotonic() - t1, "ranks": reports})
        cs.require(rcs == [0] * world, f"{work} ranks {rcs}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main(sys.argv[1:])
