"""Adaptive augmentation probability controller (counterpart of
``pgx/augment/adaptive.py``).

Accumulate sign(D(real)) over at least ``interval_batches`` batches, compare
the mean sign r_t against ``ada_target`` and nudge ``p`` by
(batch_size / ada_length) per accumulated sample, clamped to [0, 1].

The state is three 0-d float32 tensors inside the train state; the update
is branch-free tensor code, so it runs on the device without a host
synchronization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from pgx_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class AdaConfig:
    ada_target: float = 0.6
    ada_length: int = 500_000
    interval_batches: int = 4     # update once per >= 4 accumulated batches


def init_ada_state(prev_p: float = 0.0,
                   device="cuda") -> Dict[str, torch.Tensor]:
    """The controller's state at probability ``prev_p``, on the card unless
    the caller asks for ``device='cpu'``."""
    device = resolve_device(device)
    return {
        "p": torch.tensor(prev_p, dtype=torch.float32, device=device),
        "sign_sum": torch.zeros((), dtype=torch.float32, device=device),
        "count": torch.zeros((), dtype=torch.float32, device=device),
    }


@torch.no_grad()
def ada_update(state: Dict[str, torch.Tensor], real_logits: torch.Tensor,
               cfg: AdaConfig, batch_size: int) -> Dict[str, torch.Tensor]:
    """One accumulation step; adjusts p when enough batches are gathered.
    Returns a new state dict."""
    f32 = torch.float32
    for key, leaf in state.items():
        if leaf.device != real_logits.device:
            raise ValueError(
                f"ada_update: state[{key!r}] is on {leaf.device}, the logits "
                f"on {real_logits.device}")
    sign_sum = (state["sign_sum"]
                + torch.sum(torch.sign(real_logits)).to(f32))
    count = state["count"] + float(real_logits.shape[0])

    trigger = count > (batch_size * cfg.interval_batches - 1)
    r_t = sign_sum / torch.clamp_min(count, 1.0)
    one = torch.ones((), dtype=f32, device=count.device)
    direction = torch.where(r_t > cfg.ada_target, one, -one)
    step = batch_size / cfg.ada_length
    new_p = torch.clamp(state["p"] + direction * step * count, 0.0, 1.0)
    zero = torch.zeros_like(one)
    return {
        "p": torch.where(trigger, new_p, state["p"]),
        "sign_sum": torch.where(trigger, zero, sign_sum),
        "count": torch.where(trigger, zero, count),
    }
