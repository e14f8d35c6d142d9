"""Serve a trained generator over HTTP with dynamic batching, on a CUDA
device (counterpart of ``pgx/cli/serve.py``; design in pgx_torch/serve.py).

    python -m pgx_torch.cli.serve --trial trial_xxx/ --port 8080
    curl 'localhost:8080/generate?num=16&class=3&seed=0' > grid.png
    curl 'localhost:8080/stats'

``--watch 30`` polls the trial for newer checkpoints every 30s and swaps
them in live — point it at a trial that is still training.  ``--device cpu``
runs the plain PyTorch versions of the kernels on the CPU.  ``--spans
PATH`` records every request's spans and writes them to PATH at exit.
"""

from __future__ import annotations

import argparse

from pgx_torch.serve import GeneratorService, make_http_server
from pgx_torch.utils import trace


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--trial", required=True, help="trial directory")
    p.add_argument("--checkpoint", type=int, default=None,
                   help="pin a specific iteration (default: latest, "
                        "reloadable with --watch)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--max-batch", type=int, default=64,
                   help="device batch ceiling (requests coalesce up to it)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="batching window: how long a request waits for "
                        "companions before dispatch")
    p.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                   help="poll interval for hot checkpoint reload (0 = off)")
    p.add_argument("--data-parallel", type=int, default=1, metavar="N",
                   help="devices to shard each batch over (only 1 is "
                        "supported so far)")
    p.add_argument("--warmup", default="min", choices=["none", "min", "all"],
                   help="run bucket sizes before serving: 'min' = batch-1 "
                        "+ batch-max, 'all' = every power-of-two bucket, "
                        "'none' = lazy")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda)")
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="record every request's spans (queue, batch, fetch, "
                        "request) and write them to PATH at exit as a "
                        "Chrome trace (pgx_torch.utils.trace)")
    args = p.parse_args(argv)
    with trace.recording_to(args.spans):
        serve(args)


def serve(args) -> None:
    service = GeneratorService(args.trial, checkpoint=args.checkpoint,
                               max_batch=args.max_batch,
                               max_wait_ms=args.max_wait_ms,
                               watch_interval_s=args.watch,
                               data_parallel=args.data_parallel,
                               device=args.device)
    if args.warmup != "none":
        print("warming up (batch buckets)...")
        service.warmup("all" if args.warmup == "all" else (1, None))
    st = service.stats()
    server = make_http_server(service, args.host, args.port)
    print(f"serving {args.trial} (iteration {st['iteration']}, "
          f"{st['resolution']}px) on http://{args.host}:{server.server_port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
