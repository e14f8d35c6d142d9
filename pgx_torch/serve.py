"""Production serving for trained generators (counterpart of ``pgx/serve.py``).

The deployed artifact is the EMA generator's forward
(``pgx_torch.train.wgan.make_eval_generate``) on one CUDA device, through
the port's CUDA kernels.  Serving it well is mostly a batching problem:

- **Dynamic batching**: concurrent requests are coalesced into one device
  batch (up to ``max_batch`` images, waiting at most ``max_wait_ms`` for
  stragglers), padded to a power-of-two bucket so the set of batch shapes
  the device sees stays small.
- **Hot checkpoint reload**: a watcher polls the trial's checkpoint
  directory and atomically swaps in newer EMA params (re-deriving the
  growth state from the trial schedule) — serve *during* training.
- **HTTP front end** (stdlib only): ``GET /healthz``, ``GET /stats``,
  ``GET|POST /generate`` returning a PNG grid or an ``.npz`` of raw
  samples.

- **Data-parallel serving**: ``data_parallel=n`` replicates the
  generator on ``cuda:0`` .. ``cuda:n-1``; each bucket is padded to a
  multiple of n, split into n row chunks that are enqueued on their devices
  without waiting, and gathered on the first (``pgx``'s batch-sharded
  mesh, laid out as one process over n devices).
"""

from __future__ import annotations

import json
import threading
import time
import queue
from concurrent.futures import Future
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.models.generator import Generator
from pgx_torch.parallel import mesh as pmesh
from pgx_torch.train.schedule import ScheduleState, schedule_from_dict
from pgx_torch.train.wgan import make_eval_generate
from pgx_torch.utils import resolve_device
from pgx_torch.utils.png import encode_png, make_grid


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch.
    Oversized requests (a direct ``submit`` larger than max_batch) still
    land on a power-of-two bucket so the set of batch shapes stays bounded
    — never an exact ragged size."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    if n > max_batch:
        while b < n:
            b *= 2
        return b
    return min(b, max_batch)


@dataclass
class _Request:
    z: np.ndarray                      # (n, z_dim) float32
    labels: Optional[np.ndarray]       # (n,) int32 or None
    future: Future


class GeneratorService:
    """Batched, hot-reloadable sampling service over a trial checkpoint.

    Loads the trial (config JSON -> generator config, schedule -> growth
    state at the checkpoint iteration, EMA ``*_g.model`` params) and serves
    ``generate_images`` through a single batcher thread that owns all
    device dispatch.  ``device`` defaults to ``cuda`` and raises when no
    card is present; pass ``device="cpu"`` to run the plain versions.
    """

    def __init__(self, trial_dir: str, checkpoint: Optional[int] = None,
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 watch_interval_s: float = 0.0, output: str = "uint8",
                 fetch_threads: int = 4, data_parallel: int = 1,
                 device="cuda"):
        self.device = resolve_device(device)
        self._setup_mesh(data_parallel)
        self.trial_dir = trial_dir
        # serving defaults to on-device uint8 quantization: the host fetch
        # is 4x smaller per batch and PNG/npz encoding needs uint8 anyway
        self.output = output

        cfg = ckpt.load_config(trial_dir)
        self.gcfg = ckpt.generator_config_from_dict(cfg)
        self.schedule = schedule_from_dict(cfg["schedule"])
        self.conditional = self.gcfg.conditioning != "none"

        self._lock = threading.Lock()        # guards params/state/stats
        self._pinned = checkpoint is not None
        self._load(checkpoint)
        self._start(max_batch, max_wait_ms, watch_interval_s, fetch_threads)

    @classmethod
    def from_params(cls, gcfg, params, *, step: int, alpha: float = 1.0,
                    fading: bool = False, max_batch: int = 64,
                    max_wait_ms: float = 5.0, output: str = "uint8",
                    fetch_threads: int = 4, data_parallel: int = 1,
                    device="cuda") -> "GeneratorService":
        """Serve an in-memory ``pgx``-layout params tree (nested dicts of
        numpy arrays) directly: no trial dir, no reload."""
        svc = cls.__new__(cls)
        svc.device = resolve_device(device)
        svc._setup_mesh(data_parallel)
        svc.trial_dir = None
        svc.output = output
        svc.gcfg = gcfg
        svc.schedule = None
        svc.conditional = gcfg.conditioning != "none"
        svc._lock = threading.Lock()
        svc._pinned = True
        svc.params = svc._place_params(
            Generator.from_jax_params(gcfg, params, svc.device))
        svc.iteration = 0
        svc.state = ScheduleState(step=step, alpha=float(alpha),
                                  fading=fading,
                                  resolution=gcfg.resolution(step),
                                  final=not fading)
        svc._gen = make_eval_generate(gcfg, step=step, fading=fading,
                                      output=output)
        svc._gen_key = (step, fading)
        svc._start(max_batch, max_wait_ms, 0.0, fetch_threads)
        return svc

    def _start(self, max_batch, max_wait_ms, watch_interval_s,
               fetch_threads) -> None:
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._closed = False

        self._stats = {"requests": 0, "images": 0, "batches": 0,
                       "batched_images": 0, "reloads": 0}
        self._latencies = []                 # last N request latencies (s)

        # Dispatch/fetch pipeline: the batcher thread only coalesces and
        # launches (uploads, kernels and the result's copy back are all
        # queued on the device without waiting); a small pool waits for each
        # batch's copy, so one batch's fetch overlaps the next one's compute.  The semaphore bounds
        # in-flight batches so a slow client can't queue unbounded device
        # work.
        from concurrent.futures import ThreadPoolExecutor
        self._resolver = ThreadPoolExecutor(
            max_workers=max(1, int(fetch_threads)),
            thread_name_prefix="pgx-serve-fetch")
        self._inflight = threading.Semaphore(2 * max(1, int(fetch_threads)))

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="pgx-serve-batcher",
                                         daemon=True)
        self._batcher.start()

        self._stop = threading.Event()
        self._watcher = None
        if watch_interval_s > 0:
            self._watcher = threading.Thread(
                target=self._watch_loop, args=(float(watch_interval_s),),
                name="pgx-serve-watcher", daemon=True)
            self._watcher.start()

    # -- device placement ------------------------------------------------

    def _setup_mesh(self, data_parallel: int) -> None:
        """``data_parallel > 1``: a mesh over the first ``data_parallel``
        devices of the service's type; ``ValueError`` when fewer exist."""
        self._mesh = None
        n = int(data_parallel or 1)
        if n > 1:
            devices = pmesh.local_devices(self.device)
            if len(devices) < n:
                raise ValueError(
                    f"data_parallel={n} but only {len(devices)} devices")
            self._mesh = pmesh.make_mesh(devices[:n])
            self.device = self._mesh.device

    def _place_params(self, gen: Generator):
        """The generator, or with a mesh its replicas (one per device)."""
        if self._mesh is not None:
            return pmesh.replicate(self._mesh, gen)
        return gen

    # -- checkpoint / growth state -------------------------------------

    def _load(self, checkpoint: Optional[int]) -> None:
        _, params, iteration, st = ckpt.load_generator_state(
            self.trial_dir, self.schedule, checkpoint)
        gen = self._place_params(
            Generator.from_jax_params(self.gcfg, params, self.device))
        with self._lock:
            self.params = gen
            self.iteration = iteration
            self.state = st
            # the sampling function depends on the growth structure
            # (step / fading); alpha is a call argument
            if (not hasattr(self, "_gen_key")
                    or self._gen_key != (st.step, st.fading)):
                self._gen = make_eval_generate(self.gcfg, step=st.step,
                                               fading=st.fading,
                                               output=self.output)
                self._gen_key = (st.step, st.fading)

    def maybe_reload(self) -> bool:
        """Swap in a newer checkpoint if one appeared; True if reloaded."""
        if self._pinned:
            return False
        latest = ckpt.latest_checkpoint(self.trial_dir, "g")
        if latest is None:
            return False
        it = ckpt.checkpoint_iteration(latest)
        if it <= self.iteration:
            return False
        self._load(it)
        with self._lock:
            self._stats["reloads"] += 1
        return True

    def _watch_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.maybe_reload()
            except (OSError, ValueError, KeyError, RuntimeError):
                pass                        # transient partial writes

    # -- batching core ---------------------------------------------------

    def warmup(self, sizes=(1, None)) -> None:
        """Run bucket sizes up front (None = max_batch; sizes='all' = every
        power-of-two bucket), so the first client request of each size
        pays no first-use cost (kernel build, cuDNN algorithm search)."""
        if sizes == "all":
            sizes, n = [], 1
            while n < self.max_batch:
                sizes.append(n)
                n *= 2
            sizes.append(self.max_batch)
        for s in sizes:
            n = self.max_batch if s is None else int(s)
            self.generate_images(n, seed=0)

    def _batch_loop(self) -> None:
        held = None                # request that didn't fit the last batch
        while True:
            req = held if held is not None else self._queue.get()
            held = None
            if req is None:
                self._drain_closed()
                return
            batch = [req]
            total = req.z.shape[0]
            deadline = time.monotonic() + self.max_wait_s
            while total < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_batch(batch, total)
                    self._drain_closed()
                    return
                if total + nxt.z.shape[0] > self.max_batch:
                    held = nxt     # would overflow the bucket ceiling:
                    break          # give it its own batch next round
                batch.append(nxt)
                total += nxt.z.shape[0]
            self._run_batch(batch, total)

    def _drain_closed(self) -> None:
        """Fail any request that raced close(): their futures must resolve
        promptly, not hang until the caller's timeout."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.future.set_exception(RuntimeError("service closed"))

    def _run_batch(self, batch, total: int) -> None:
        t0 = time.monotonic()
        padded = _bucket(total, self.max_batch)
        if self._mesh is not None:     # a multiple of the mesh's devices
            dp = len(self._mesh.devices)
            padded = ((max(padded, dp) + dp - 1) // dp) * dp
        z = np.concatenate([r.z for r in batch])
        if padded > total:
            z = np.concatenate(
                [z, np.zeros((padded - total,) + z.shape[1:], z.dtype)])
        labels = None
        if self.conditional:
            parts = [r.labels for r in batch]
            if padded > total:
                parts.append(np.zeros(padded - total, np.int32))
            labels = np.concatenate(parts)
        with self._lock:
            gen, params, alpha = self._gen, self.params, self.state.alpha
        self._inflight.acquire()           # bound queued device work
        try:
            z_dev = self._upload(z)
            lab_dev = self._upload(labels) if labels is not None else None
            if self._mesh is None:
                out = gen(params, z_dev, lab_dev, float(alpha))
            else:
                out = pmesh.data_parallel_apply(
                    self._mesh, lambda g, zc, lc: gen(g, zc, lc,
                                                      float(alpha)),
                    params, z_dev, lab_dev)
            fetched = self._start_fetch(out)
        except Exception as exc:           # launch-time failure
            self._inflight.release()
            for r in batch:
                r.future.set_exception(exc)
            return
        # hand the pending copy to the fetch pool; the batcher is
        # immediately free to coalesce + launch the next batch
        try:
            self._resolver.submit(self._resolve, fetched, batch, total, t0)
        except RuntimeError:
            # close() abandoned the join and shut the fetch pool: resolve
            # inline so these futures still complete instead of hanging
            self._resolve(fetched, batch, total, t0)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        # from pinned memory the copy is queued, not waited for: a pageable
        # copy would block the batcher until the previous batch finished
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_fetch(self, out: torch.Tensor):
        """Queue the device->host copy right behind the batch's kernels and
        return ``(host tensor, event)``: the fetch thread then waits for
        this batch alone, not for batches launched after it."""
        if out.dtype == torch.bfloat16:       # numpy has no bf16
            out = out.float()
        if self.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _resolve(self, fetched, batch, total: int, t0: float) -> None:
        try:
            try:
                host, done = fetched
                if done is None:
                    images = host.numpy()[:total]
                else:
                    done.synchronize()
                    # copy out, so the pinned buffer goes back to the
                    # allocator's cache instead of living on in the results
                    images = host.numpy()[:total].copy()
            except Exception as exc:       # device faults surface here
                for r in batch:
                    r.future.set_exception(exc)
                return
            dt = time.monotonic() - t0
            # count the batch before any client sees its result, so stats
            # read after a result always include the batch that made it
            with self._lock:
                self._stats["batches"] += 1
                self._stats["batched_images"] += total
                self._latencies.append(dt)
                del self._latencies[:-512]
            lo = 0
            for r in batch:
                n = r.z.shape[0]
                r.future.set_result(images[lo:lo + n])
                lo += n
        finally:
            self._inflight.release()

    # -- public API --------------------------------------------------------

    def submit(self, z: np.ndarray,
               labels: Optional[np.ndarray] = None) -> Future:
        """Enqueue one request; the future resolves to (n, H, W, C) images —
        uint8 in [0, 255] by default, float32 in [-1, 1] with
        ``output='float'``."""
        z = np.asarray(z, np.float32)
        # validate per-request: one malformed request must fail alone, not
        # poison the coalesced batch it would ride in
        if z.ndim != 2 or z.shape[1] != self.gcfg.z_dim:
            raise ValueError(
                f"z must be (n, {self.gcfg.z_dim}), got {z.shape}")
        if z.shape[0] < 1:
            raise ValueError("z must contain at least one latent")
        if self.conditional:
            if labels is None:
                raise ValueError("conditional model requires labels")
            labels = np.asarray(labels, np.int32)
            if labels.shape != (z.shape[0],):
                raise ValueError(f"labels must have shape ({z.shape[0]},), "
                                 f"got {labels.shape}")
            if labels.size and (labels.min() < 0
                                or labels.max() >= self.gcfg.num_classes):
                raise ValueError(
                    f"labels must be in [0, {self.gcfg.num_classes})")
        fut = Future()
        # the closed-check and the put must be atomic with close() (which
        # flips _closed and enqueues the sentinel under the same lock) —
        # otherwise a request can slip in after the batcher drained and its
        # future would never resolve
        with self._lock:
            if self._closed:
                raise RuntimeError("service closed")
            self._stats["requests"] += 1
            self._stats["images"] += z.shape[0]
            self._queue.put(_Request(z,
                                     labels if self.conditional else None,
                                     fut))
        return fut

    def generate_images(self, num: int, labels=None, class_id=None,
                        seed: Optional[int] = None,
                        timeout: float = 120.0,
                        return_labels: bool = False) -> np.ndarray:
        """Synchronous convenience: sample `num` images (chunked to
        max_batch), returning (num, H, W, C) in the service's output
        dtype (uint8 by default).  With ``return_labels=True`` returns
        ``(images, labels)`` where ``labels`` are the class ids actually
        used (the service draws them when the caller didn't — the only
        way a client can know the classes of unconditional-looking
        conditional samples)."""
        if num < 1:
            raise ValueError(f"num must be >= 1, got {num}")
        rng = (np.random.RandomState(seed) if seed is not None
               else np.random.RandomState())
        z = rng.randn(num, self.gcfg.z_dim).astype(np.float32)
        if self.conditional:
            if labels is not None:
                labels = np.asarray(labels, np.int32)
                if labels.shape != (num,):
                    raise ValueError(f"labels must have shape ({num},)")
            elif class_id is not None:
                labels = np.full(num, int(class_id), np.int32)
            else:
                labels = rng.randint(
                    0, self.gcfg.num_classes, num).astype(np.int32)
        futs = []
        for lo in range(0, num, self.max_batch):
            hi = min(lo + self.max_batch, num)
            futs.append(self.submit(
                z[lo:hi], labels[lo:hi] if labels is not None else None))
        images = np.concatenate([f.result(timeout=timeout) for f in futs])
        if return_labels:
            return images, labels
        return images

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            lats = sorted(self._latencies)
        s["mean_batch_fill"] = (s["batched_images"] / s["batches"]
                                if s["batches"] else 0.0)
        if lats:
            s["latency_p50_ms"] = 1e3 * lats[len(lats) // 2]
            s["latency_p95_ms"] = 1e3 * lats[min(len(lats) - 1,
                                                 int(len(lats) * 0.95))]
        s.update(iteration=self.iteration, step=self.state.step,
                 resolution=self.state.resolution,
                 alpha=float(self.state.alpha),
                 conditional=self.conditional)
        return s

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._queue.put(None)
        self._stop.set()
        self._batcher.join(timeout=10)
        self._resolver.shutdown(wait=True)
        if self._watcher is not None:
            self._watcher.join(timeout=10)


# -----------------------------------------------------------------------
# HTTP front end
# -----------------------------------------------------------------------

def _npz_bytes(images: np.ndarray, labels=None) -> bytes:
    import io
    buf = io.BytesIO()
    payload = {"images": images}
    if labels is not None:
        payload["labels"] = labels
    np.savez(buf, **payload)
    return buf.getvalue()


def make_http_server(service: GeneratorService, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind an HTTP server over `service` (not yet serving; call
    serve_forever(), or run it in a thread — handlers are thread-safe
    because all device work funnels through the batcher)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):      # quiet by default
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse
            u = urlparse(self.path)
            if u.path == "/healthz":
                return self._json({"ok": True, **service.stats()})
            if u.path == "/stats":
                return self._json(service.stats())
            if u.path == "/generate":
                q = {k: v[-1] for k, v in parse_qs(u.query).items()}
                return self._generate(q)
            self._json({"error": f"unknown path {u.path}"}, 404)

        def do_POST(self):
            if self.path.split("?")[0] != "/generate":
                return self._json({"error": "unknown path"}, 404)
            n = int(self.headers.get("Content-Length", 0))
            try:
                q = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                return self._json({"error": "bad JSON body"}, 400)
            if not isinstance(q, dict):
                return self._json({"error": "JSON body must be an object"},
                                  400)
            self._generate(q)

        def _generate(self, q: dict):
            try:
                num = int(q.get("num", 1))
                if not 1 <= num <= 4096:
                    raise ValueError("num must be in [1, 4096]")
                labels = q.get("labels")
                if labels is not None and not isinstance(labels, list):
                    labels = [int(x) for x in str(labels).split(",")]
                # return_labels: the service may draw/derive the labels
                # itself (class= or random), so the npz must carry the
                # ones actually used, not the raw query value
                fmt = str(q.get("format", "png"))
                if fmt not in ("png", "npz"):
                    raise ValueError(f"unknown format {fmt!r}")
                nrow = int(q.get("nrow", min(num, 10)))
                if nrow < 1:
                    raise ValueError("nrow must be >= 1")
                images, labels = service.generate_images(
                    num, labels=labels,
                    class_id=q.get("class"),
                    seed=int(q["seed"]) if "seed" in q else None,
                    return_labels=True)
            except Exception as exc:
                return self._json({"error": str(exc)}, 400)
            if fmt == "npz":
                return self._bytes(_npz_bytes(images, labels),
                                   "application/octet-stream")
            return self._bytes(encode_png(make_grid(images, nrow=nrow)),
                               "image/png")

    return ThreadingHTTPServer((host, port), Handler)
