"""The numbers that decide ``correct``: what the timed path produced set
against the plain reference on the same inputs.

Training (the first iterations the set-up drives through the window's own
call and feed):

* ``loss_gap``: the gaps of the D step's total loss and of G's loss, step
  by step (or summed over a window of k iterations where the call returns
  sums), added up over the sum of the reference's magnitudes;
* ``grad_gap.g``, ``grad_gap.d``: per net, the first gradient as the
  optimizer got it (Adam's first moment after one step, divided by
  1 - beta1): the largest gap between the program's and the reference's
  norm of a leaf, over the reference's norm of that leaf or of the median
  leaf of the net, whichever is larger;
* ``grad_diff.g``, ``grad_diff.d``: the same first gradients by the norm
  of the difference, over the same scale, of the median leaf: a gap of
  norms does not see a gradient taken over half of the batch (its norm is
  close to the whole batch's), and the worst leaf of a deep net in bfloat16
  reads near the control at 512px where the median leaf stays apart;
* ``change_gap``: the worst leaf's gap of norms of the parameters' change
  over the first three iterations, as ``grad_gap``, over the leaves the
  reference's first gradient moves (a leaf whose gradient is under a
  thousandth of the median leaf's moves under Adam by round-off alone);
* ``ema_gap``: the same for the generator's EMA, its change over the
  first three iterations, over the leaves G's first gradient moves;
* ``ada_count_gap``: the rows the ADA controller has counted after the
  first iteration, program against reference (exact).

A cell's ``limits/<cell>.json`` names the numbers it compares.

Serving: ``image_gap``, the largest mean absolute difference of an image,
in 8-bit levels, between a returned image and the reference's of the same
request, over a sample of the finished requests; ``missing``, the sampled
requests that never came back.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Set

MOVED = 1e-3       # a leaf moves if its first gradient is above this share
                   # of the median leaf's


def _norms(leaves) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gap(prog: dict, ref: dict, only: Optional[Set[str]] = None
             ) -> float:
    """The worst leaf's gap of norms, relative to the larger of the
    reference leaf's norm and the median leaf's."""
    rp, rr = _norms(prog), _norms(ref)
    if rp.keys() != rr.keys():
        return float("inf")
    med = statistics.median(rr.values())
    worst = 0.0
    for k in rr:
        if only is not None and k not in only:
            continue
        scale = max(rr[k], med)
        if scale > 0:
            worst = max(worst, abs(rp[k] - rr[k]) / scale)
    return worst


def leaf_diff(prog: dict, ref: dict) -> float:
    """The median leaf's norm of the difference, relative to the larger of
    that leaf's reference norm and the median leaf's, over the leaves the
    reference's gradient reaches."""
    if prog.keys() != ref.keys():
        return float("inf")
    rr = _norms(ref)
    med = statistics.median(rr.values())
    rel = [float((prog[k].double() - ref[k].double()).norm()) / max(v, med)
           for k, v in rr.items() if v > 0]
    return statistics.median(rel) if rel else float("inf")


def moved(grads: dict) -> Set[str]:
    n = _norms(grads)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= MOVED * med}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (a list of dicts),
    ``ada_count`` (the controller's count after the first iteration), and
    per net (``g``, ``d``): ``grad`` (leaf -> first gradient), ``init`` and
    ``after`` (leaf -> parameters before and after the compared
    iterations), and ``ema`` (``init`` and ``after`` of G's EMA)."""
    gap = size = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        for key in ("d_total", "g_loss"):
            gap += abs(p[key] - r[key])
            size += abs(r[key])
    loss = (gap / size if size > 0 and len(prog["losses"])
            == len(ref["losses"]) else float("inf"))
    out = {"loss_gap": loss,
           "ada_count_gap": abs(prog["ada_count"] - ref["ada_count"])}
    def change_of(net, keep):
        dp = {k: prog[net]["after"][k] - prog[net]["init"][k]
              for k in prog[net]["after"]}
        dr = {k: ref[net]["after"][k] - ref[net]["init"][k]
              for k in ref[net]["after"]}
        return leaf_gap(dp, dr, keep)

    change = 0.0
    for net in ("g", "d"):
        out[f"grad_gap.{net}"] = leaf_gap(prog[net]["grad"],
                                          ref[net]["grad"])
        out[f"grad_diff.{net}"] = leaf_diff(prog[net]["grad"],
                                            ref[net]["grad"])
        change = max(change, change_of(net, moved(ref[net]["grad"])))
    out["change_gap"] = change
    out["ema_gap"] = change_of("ema", moved(ref["g"]["grad"]))
    return out


def image_numbers(torch, got: Dict[int, object], want: Dict[int, object],
                  sampled: List[int]) -> Dict[str, float]:
    """``got`` and ``want`` map a request's index to its images (uint8,
    N x H x W x C)."""
    worst, missing = 0.0, 0
    for i in sampled:
        if i not in got:
            missing += 1
            continue
        g = torch.as_tensor(got[i]).to(torch.float32)
        w = torch.as_tensor(want[i]).to(torch.float32)
        if g.shape != w.shape:
            worst = float("inf")
            continue
        per_image = (g - w).abs().flatten(1).mean(1)
        worst = max(worst, float(per_image.max()))
    return {"image_gap": worst, "missing": float(missing)}
