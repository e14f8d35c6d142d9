"""``torch.export`` model export: freeze a trained generator into a
code-free deployment artifact (counterpart of ``pgx/export.py``).

pgx lowers the jitted EMA generator, its parameters baked in, to versioned
StableHLO per batch bucket.  The port exports the same computation, that of
``pgx_torch.train.wgan.make_eval_generate`` (``generator_apply`` at the
checkpoint's step, fading and alpha, then the on-device uint8 quantization
when ``output='uint8'``), with ``torch.export`` under ``torch.no_grad``.
The hand-written kernels are ``torch.library`` ops
(``torch.ops.pgx_torch.*``), so each one is a node of the exported graph and
launches its kernel when the program runs on the card.

An export is a directory:

    manifest.json     {z_dim, num_classes, resolution, step, ...} (pgx's)
    gen_b{N}.pt2      one ``torch.export.save`` program per batch bucket N,
                      the weights inside it

``load_exported(path)`` needs this module, torch and the op registrations
(``pgx_torch.ops.kernels``), no model code: requests are padded to the
smallest bucket that holds them, and larger ones are chunked through the
largest bucket, as pgx's loader does.  A program exported for ``cuda`` runs
on the card only; one exported for ``cpu`` runs the kernels' plain versions.

    python -m pgx_torch.cli.export_model --trial trial_x/ --out model.pgx/
    gen = pgx_torch.export.load_exported("model.pgx/")
    images = gen.sample(100, seed=0, class_id=3)
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pgx_torch.utils import resolve_device

FORMAT_VERSION = 1


def _bucket_sizes(batch_sizes: Sequence[int]) -> list:
    sizes = sorted(set(int(b) for b in batch_sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive, got {batch_sizes}")
    return sizes


class _Sampling(torch.nn.Module):
    """The traced module: ``forward(z[, labels])`` -> images, the generator
    a submodule (its weights go into the program's state)."""

    def __init__(self, gen, fn, alpha: float):
        super().__init__()
        self.gen = gen
        self.fn = fn
        self.alpha = alpha

    def forward(self, z, labels=None):
        return self.fn(self.gen, z, labels, self.alpha)


def export_generator(gcfg, params, *, step: int, fading: bool = False,
                     alpha: float = 1.0, output: str = "uint8",
                     batch_sizes: Sequence[int] = (1, 8, 64),
                     device: str = "cuda") -> Dict[int, bytes]:
    """Serialize the generator forward (params inside) per batch bucket.

    ``params`` is a generator params tree in pgx's layout (nested dicts of
    arrays, as ``pgx_torch.checkpoint.load_params`` returns).  Returns
    {batch_size: ``torch.export.save`` bytes}; ``device`` is where the
    program runs (``cuda`` unless the caller asks for ``cpu``)."""
    from pgx_torch.models.generator import Generator
    from pgx_torch.train.wgan import eval_forward

    dev = resolve_device(device)
    gen = Generator.from_jax_params(gcfg, params, dev)
    module = _Sampling(gen, eval_forward(gcfg, step=step, fading=fading,
                                         output=output), float(alpha))
    conditional = gcfg.conditioning != "none"
    blobs: Dict[int, bytes] = {}
    for bs in _bucket_sizes(batch_sizes):
        args = [torch.zeros(bs, gcfg.z_dim, dtype=torch.float32, device=dev)]
        if conditional:
            args.append(torch.zeros(bs, dtype=torch.int32, device=dev))
        with torch.no_grad():
            program = torch.export.export(module, tuple(args), strict=False)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[bs] = buf.getvalue()
    return blobs


def save_exported(out_dir: str, blobs: Dict[int, bytes],
                  manifest: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    manifest = dict(manifest, format_version=FORMAT_VERSION,
                    batch_sizes=sorted(blobs))
    for bs, blob in blobs.items():
        with open(os.path.join(out_dir, f"gen_b{bs}.pt2"), "wb") as f:
            f.write(blob)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    return out_dir


def _output_shape(blob: bytes) -> tuple:
    """The exported program's output shape, from its graph."""
    import pgx_torch.ops.kernels  # noqa: F401  (the ops' registrations)
    program = torch.export.load(io.BytesIO(blob))
    out = next(n for n in program.graph.nodes if n.op == "output")
    return tuple(out.args[0][0].meta["val"].shape)


def export_trial(trial_dir: str, out_dir: str, *,
                 checkpoint: Optional[int] = None,
                 output: str = "uint8",
                 batch_sizes: Sequence[int] = (1, 8, 64),
                 device: str = "cuda") -> dict:
    """Export a trial's (EMA) generator checkpoint; returns the manifest."""
    from pgx_torch import checkpoint as ckpt
    from pgx_torch.train.schedule import schedule_from_dict

    cfg = ckpt.load_config(trial_dir)
    gcfg = ckpt.generator_config_from_dict(cfg)
    schedule = schedule_from_dict(cfg["schedule"])

    gpath, params, iteration, st = ckpt.load_generator_state(
        trial_dir, schedule, checkpoint)

    blobs = export_generator(gcfg, params, step=st.step, fading=st.fading,
                             alpha=float(st.alpha), output=output,
                             batch_sizes=batch_sizes, device=device)

    # resolution from the exported output's shape: family-agnostic
    out_shape = _output_shape(next(iter(blobs.values())))
    manifest = {
        "z_dim": int(gcfg.z_dim),
        "num_classes": int(getattr(gcfg, "num_classes", 0) or 0),
        "conditional": gcfg.conditioning != "none",
        "resolution": int(out_shape[1]),
        "channels": int(out_shape[3]),
        "output": output,
        "step": int(st.step),
        "fading": bool(st.fading),
        "alpha": float(st.alpha),
        "source_trial": os.path.abspath(trial_dir),
        "source_checkpoint": int(iteration),
        "platforms": [resolve_device(device).type],
    }
    save_exported(out_dir, blobs, manifest)
    return manifest


class ExportedGenerator:
    """Loaded export: pads requests to the bucket grid, chunks past it.

    A ``torch.export`` consumer: no pgx_torch model code, configs or
    checkpoints are touched after export time.  The programs run on the
    manifest's platform (``cuda`` raises without a card).  A bf16 model's
    float output comes back as float32 (numpy has no bfloat16)."""

    def __init__(self, path: str):
        import pgx_torch.ops.kernels  # noqa: F401  (the ops' registrations)
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"export format {self.manifest['format_version']} is newer "
                f"than this loader ({FORMAT_VERSION})")
        self.device = resolve_device(
            (self.manifest.get("platforms") or ["cuda"])[0])
        self.path = path
        self._fns: Dict[int, object] = {}
        for bs in self.manifest["batch_sizes"]:
            program = torch.export.load(os.path.join(path, f"gen_b{bs}.pt2"))
            self._fns[bs] = program.module()
        self.buckets = sorted(self._fns)
        self.z_dim = self.manifest["z_dim"]
        self.conditional = self.manifest["conditional"]
        self.resolution = self.manifest["resolution"]

    def _call_bucket(self, z: np.ndarray, labels) -> np.ndarray:
        n = len(z)
        bs = next((b for b in self.buckets if b >= n), self.buckets[-1])
        pad = bs - n
        if pad:
            z = np.concatenate([z, np.zeros((pad, self.z_dim), np.float32)])
            if labels is not None:
                labels = np.concatenate([labels,
                                         np.zeros((pad,), np.int32)])
        args = [torch.from_numpy(z).to(self.device)]
        if self.conditional:
            args.append(torch.from_numpy(labels).to(self.device))
        with torch.inference_mode():
            out = self._fns[bs](*args)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()[:n]

    def generate(self, z: np.ndarray,
                 labels: Optional[np.ndarray] = None) -> np.ndarray:
        """Images for explicit latents (+ labels when conditional)."""
        z = np.ascontiguousarray(z, np.float32)
        if z.ndim != 2 or z.shape[1] != self.z_dim:
            raise ValueError(f"z must be (n, {self.z_dim}), got {z.shape}")
        if len(z) == 0:
            raise ValueError("z must contain at least one latent")
        if self.conditional:
            if labels is None:
                raise ValueError("conditional export needs labels")
            labels = np.ascontiguousarray(labels, np.int32)
        top = self.buckets[-1]
        outs = [self._call_bucket(
                    z[i:i + top],
                    labels[i:i + top] if labels is not None else None)
                for i in range(0, len(z), top)]
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def sample(self, num: int, seed: int = 0, labels=None,
               class_id: Optional[int] = None) -> np.ndarray:
        """Sample ``num`` images from N(0, 1) latents."""
        rng = np.random.RandomState(seed)
        z = rng.randn(num, self.z_dim).astype(np.float32)
        if self.conditional:
            if labels is not None:
                labels = np.asarray(labels, np.int32)
            elif class_id is not None:
                labels = np.full((num,), class_id, np.int32)
            else:
                labels = rng.randint(
                    0, max(self.manifest["num_classes"], 1),
                    num).astype(np.int32)
        return self.generate(z, labels)


def load_exported(path: str) -> ExportedGenerator:
    return ExportedGenerator(path)
