"""The checkpoint sweep and the in-training FID (counterpart of
``pgx/eval/sweep.py``).

For every ``{iter}_g.model`` of a trial: the growth state (step, alpha)
from the iteration through the trial's schedule, N samples in batches from
the EMA generator (``make_eval_generate``, so kernels A, B and C on a
CUDA device), FID against real statistics, appended to an incremental
``fid_score.json`` that skips names already scored.  Entries the
in-training FID (``TrainingFid``) wrote are scored again: their baseline
(per stage resolution, class-balanced) is not the sweep's.  File names and
JSON shapes are ``pgx``'s, so a trial scored by one package is read by the
other.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from pgx_torch import checkpoint as ckpt
from pgx_torch.data.datasets import _balanced_subset_indices
from pgx_torch.eval.fid import (calculate_activation_statistics,
                                calculate_frechet_distance, get_activations,
                                make_extractor)
from pgx_torch.eval.kid import kid_from_activations
from pgx_torch.models.generator import Generator
from pgx_torch.train.wgan import make_eval_generate


def _load_scores(trial_dir: str, filename: str) -> dict:
    path = os.path.join(trial_dir, filename)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _append_score(trial_dir: str, filename: str, name: str, score) -> None:
    scores = _load_scores(trial_dir, filename)
    scores[name] = score
    with open(os.path.join(trial_dir, filename), "w") as f:
        json.dump(scores, f, indent=2)


def load_fid_scores(trial_dir: str) -> dict:
    return _load_scores(trial_dir, "fid_score.json")


def append_fid_score(trial_dir: str, name: str, score: float) -> None:
    _append_score(trial_dir, "fid_score.json", name, score)


def load_kid_scores(trial_dir: str) -> dict:
    """The incremental ``kid_score.json``: {checkpoint: [mean, std]}."""
    return _load_scores(trial_dir, "kid_score.json")


def append_kid_score(trial_dir: str, name: str, mean: float,
                     std: float) -> None:
    _append_score(trial_dir, "kid_score.json", name, [mean, std])


def load_fid_meta(trial_dir: str) -> dict:
    """Names whose ``fid_score.json`` entries came from the in-training FID
    (per stage resolution, class-balanced real baseline): not comparable
    to a sweep's, so ``sweep_trial`` scores them again."""
    return _load_scores(trial_dir, "fid_score_meta.json")


def _unmark_in_training(trial_dir: str, name: str) -> None:
    meta = load_fid_meta(trial_dir)
    if name in meta:
        del meta[name]
        with open(os.path.join(trial_dir, "fid_score_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)


def generate_samples(generator: Generator, gcfg, *, step: int, alpha: float,
                     fading: bool, num_samples: int, batch_size: int = 50,
                     seed: int = 0, num_classes: int = 0,
                     gen: Optional[Callable] = None) -> np.ndarray:
    """Batched samples of ``generator`` (on its device) as float32 NHWC
    numpy, before the squash (FID's preprocessing applies the quirk).  z
    from ``RandomState(seed).randn`` as float32 and class-balanced labels
    (shuffled round robin, like the real side's subsets), so on the same
    parameters the samples are ``pgx``'s.  ``gen``: a cached
    ``make_eval_generate`` function for (step, fading)."""
    if gen is None:
        gen = make_eval_generate(gcfg, step=step, fading=fading)
    device = next(generator.parameters()).device
    rng = np.random.RandomState(seed)
    if num_classes:
        labels = np.tile(np.arange(num_classes),
                         num_samples // num_classes + 1)[:num_samples]
        labels = rng.permutation(labels)
    alpha = float(np.float32(alpha))       # pgx hands its step an f32
    outs = []
    done = 0
    while done < num_samples:
        b = min(batch_size, num_samples - done)
        z = torch.from_numpy(rng.randn(b, gcfg.z_dim).astype(np.float32))
        lab = (torch.from_numpy(labels[done:done + b]).to(device)
               if num_classes else None)
        img = gen(generator, z.to(device), lab, alpha)
        outs.append(img.float().cpu().numpy())
        done += b
    return np.concatenate(outs)


def sweep_trial(trial_dir: str, schedule, real_data: np.ndarray,
                num_samples: int = 2000, batch_size: int = 50,
                extractor: Optional[Callable] = None,
                verbose: bool = True, kid: bool = False,
                kid_subset_size: int = 1000,
                kid_subsets: int = 100, device="cuda") -> dict:
    """Score every unscored G checkpoint of a trial against ``real_data``,
    the generator on ``device``.  ``kid=True`` also scores KID from the
    same activations into ``kid_score.json``; a checkpoint already
    FID-scored gets its missing KID without a new FID."""
    cfg = ckpt.load_config(trial_dir)
    gcfg, _, _ = ckpt.configs_from_dict(cfg)
    if extractor is None:
        extractor = make_extractor(device=device)

    # the real activations only when some checkpoint needs them: a fully
    # scored trial pays no Inception pass
    real = {}

    def _real():
        if not real:
            acts = get_activations(real_data, extractor, batch_size)
            real["acts"] = acts
            real["mu"] = np.mean(acts, axis=0)
            real["sig"] = np.cov(acts, rowvar=False)
        return real

    scores = load_fid_scores(trial_dir)
    kid_scores = load_kid_scores(trial_dir) if kid else {}
    in_training = load_fid_meta(trial_dir)
    for path in ckpt.list_checkpoints(trial_dir, "g"):
        name = os.path.basename(path)
        rescore = name in in_training
        if (name in scores and not rescore
                and (not kid or name in kid_scores)):
            continue
        _, params, _, st = ckpt.load_generator_state(
            trial_dir, schedule, path=path)
        samples = generate_samples(
            Generator.from_jax_params(gcfg, params, device), gcfg,
            step=st.step, alpha=st.alpha, fading=st.fading,
            num_samples=num_samples, batch_size=batch_size,
            num_classes=gcfg.num_classes if gcfg.conditioning != "none"
            else 0)
        gen_acts = get_activations(samples, extractor, batch_size)
        msg = f"{name}: step={st.step} alpha={st.alpha:.2f}"
        if name not in scores or rescore:
            r = _real()
            mu_g, sig_g = (np.mean(gen_acts, axis=0),
                           np.cov(gen_acts, rowvar=False))
            fid = calculate_frechet_distance(mu_g, sig_g, r["mu"], r["sig"])
            scores[name] = fid
            append_fid_score(trial_dir, name, fid)
            msg += f" FID={fid:.2f}" + (" (re-scored)" if rescore else "")
        if kid and (name not in kid_scores or rescore):
            k_mean, k_std = kid_from_activations(
                _real()["acts"], gen_acts, subset_size=kid_subset_size,
                num_subsets=kid_subsets)
            kid_scores[name] = [k_mean, k_std]
            append_kid_score(trial_dir, name, k_mean, k_std)
            msg += f" KID={k_mean:.5f}+-{k_std:.5f}"
        if rescore:
            _unmark_in_training(trial_dir, name)
        if verbose:
            print(msg, flush=True)
    # in-training scores at iterations without a checkpoint file cannot be
    # scored again: they stay marked, and best-of must leave them out
    leftover = [n for n in load_fid_meta(trial_dir) if n in scores]
    if leftover and verbose:
        print(f"note: {len(leftover)} in-training score(s) have no "
              f"checkpoint file and keep their per-stage baseline: "
              f"{leftover}", flush=True)
    return scores


def precompute_real_statistics(dataset, sizes, out_dir: str,
                               samples_per_size: int = 10000,
                               extractor: Optional[Callable] = None,
                               batch_size: int = 50, seed: int = 0,
                               prefix: str = "") -> None:
    """Real (mu, sigma) per resolution over a class-balanced subset (when
    the dataset has labels), saved as ``{prefix}{size}_stats.npz``."""
    if extractor is None:
        extractor = make_extractor()
    os.makedirs(out_dir, exist_ok=True)
    labels = getattr(dataset, "labels", None)
    ncls = int(getattr(dataset, "num_classes", 0) or 0)
    for size in sizes:
        images = dataset.at_resolution(size)
        idx = _balanced_subset_indices(
            labels, ncls, min(samples_per_size, len(images)), seed,
            total=len(images))
        mu, sigma = calculate_activation_statistics(images[idx], extractor,
                                                    batch_size)
        with open(os.path.join(out_dir, f"{prefix}{size}_stats.npz"),
                  "wb") as f:
            np.savez(f, mu=mu, sigma=sigma)


def load_real_statistics(out_dir: str, size: int, prefix: str = ""):
    """(mu, sigma) of ``precompute_real_statistics``."""
    with np.load(os.path.join(out_dir, f"{prefix}{size}_stats.npz")) as d:
        return d["mu"], d["sigma"]


class TrainingFid:
    """FID of the EMA generator during a run, appended to the trial's
    ``fid_score.json`` under the sweep's ``{iter}_g.model`` keys and
    marked in ``fid_score_meta.json`` as in-training (its real baseline is
    per stage resolution and class-balanced, so a later sweep scores it
    again).  Real statistics per resolution over a fixed class-balanced
    subset, computed once and cached; needs a dataset with per-resolution
    arrays (``at_resolution``)."""

    def __init__(self, dataset, gcfg, num_samples: int = 1024,
                 batch_size: int = 50, extractor: Optional[Callable] = None,
                 max_real: int = 2048, seed: int = 0,
                 gen_cache: Optional[dict] = None):
        if not hasattr(dataset, "at_resolution"):
            raise TypeError(
                "in-training FID needs an array-backed dataset with "
                "per-resolution caches; for folder/WikiArt pipelines run "
                "pgx_torch.cli.fid_sweep post-hoc")
        if extractor is None:
            extractor = make_extractor()
        self.dataset = dataset
        self.gcfg = gcfg
        self.num_samples = int(num_samples)
        self.batch_size = int(batch_size)
        self.extractor = extractor
        self.max_real = int(max_real)
        self.seed = int(seed)
        self._real_stats = {}          # resolution -> (mu, sigma)
        # (step, fading) -> sampling function; the loop passes its grid
        # cache, so a stage's function is made once for both
        self._gen_cache = gen_cache if gen_cache is not None else {}

    def real_stats(self, resolution: int):
        if resolution not in self._real_stats:
            sub = self.dataset.subset(self.max_real, seed=self.seed)
            data = sub.at_resolution(resolution)
            self._real_stats[resolution] = calculate_activation_statistics(
                data, self.extractor, self.batch_size)
        return self._real_stats[resolution]

    def score(self, trial_dir: Optional[str], iteration: int,
              generator: Generator, st) -> float:
        """FID of ``generator`` at growth state ``st``; appended to the
        trial's ``fid_score.json`` when ``trial_dir`` is given."""
        gkey = (st.step, st.fading)
        if gkey not in self._gen_cache:
            self._gen_cache[gkey] = make_eval_generate(
                self.gcfg, step=st.step, fading=st.fading)
        conditional = self.gcfg.conditioning != "none"
        samples = generate_samples(
            generator, self.gcfg, step=st.step, alpha=float(st.alpha),
            fading=st.fading, num_samples=self.num_samples,
            batch_size=self.batch_size, seed=self.seed,
            num_classes=self.gcfg.num_classes if conditional else 0,
            gen=self._gen_cache[gkey])
        mu_g, sig_g = calculate_activation_statistics(
            samples, self.extractor, self.batch_size)
        mu_r, sig_r = self.real_stats(st.resolution)
        fid = calculate_frechet_distance(mu_g, sig_g, mu_r, sig_r)
        if trial_dir is not None:
            name = ckpt.checkpoint_name(iteration, "g")
            append_fid_score(trial_dir, name, fid)
            _append_score(trial_dir, "fid_score_meta.json", name,
                          "in-training")
        return float(fid)
