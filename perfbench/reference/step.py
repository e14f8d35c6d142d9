"""One WGAN-GP iteration of the conditional Progressive GAN, with two Adam
optimizers, the generator's EMA and, optionally, the ADA pipe and its
controller, in plain PyTorch (Gulrajani et al. 2017; Karras et al. 2018,
2020), over the parameter dicts of ``nets``.

  D loss  = -(E[D(real)] - drift E[D(real)^2]) + E[D(fake)]
            + lam E[(||grad_x D(x_hat)||_2 - 1)^2],
            x_hat = eps real + (1 - eps) fake (fake detached),
            lam = lambda_gp * gp_every, the penalty every gp_every-th
            iteration (lazy regularization), by double backward
  G loss  = -E[D(G(z))] with the same z and the updated D; with
            ``fused_g`` the D step's own pass scores G against the
            pre-update D: G's gradient is minus that pass's gradient.
  Adam    : beta1, beta2, eps outside the square root, bias-corrected on
            one step count per optimizer; a parameter off the graph sees a
            zero gradient.
  EMA     : ema = decay ema + (1 - decay) g after every G update.

With an augmentation policy every image D sees is augmented: the reals
once, the D step's fakes and the G step's fakes each from their own draw
source.  The controller accumulates sign(D(real)) and, once at least
``interval_batches`` batches are in, moves p by ``batch / ada_length`` per
accumulated sample towards the target, clamped to [0, 1].
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from perfbench.reference import augment as aug
from perfbench.reference import nets


def _adam_init(params):
    return {"count": 0, "mu": {k: torch.zeros_like(v) for k, v in
                               params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


class Trainer:
    """The reference's train state and its step.  ``g`` and ``d`` are
    float32 copies of the parameters it starts from."""

    def __init__(self, g: nets.Params, d: nets.Params, cfg: dict, *,
                 prec: nets.Prec = nets.Prec(), ada_p: float = 0.0):
        self.cfg, self.prec = cfg, prec
        self.tr = cfg["train"]
        self.g = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in g.items()}
        self.d = {k: v.detach().float().clone().requires_grad_(True)
                  for k, v in d.items()}
        self.ema = {k: v.detach().float().clone() for k, v in g.items()}
        self.opt_g, self.opt_d = _adam_init(self.g), _adam_init(self.d)
        self.ada = {"p": float(ada_p), "sign_sum": 0.0, "count": 0.0}
        self.iteration = 0

    # -- pieces ---------------------------------------------------------
    def _adam(self, params, grads, opt):
        tr = self.tr
        opt["count"] += 1
        bc1 = 1.0 - tr["beta1"] ** opt["count"]
        bc2 = 1.0 - tr["beta2"] ** opt["count"]
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                mu = opt["mu"][k].mul_(tr["beta1"]).add_(
                    g, alpha=1.0 - tr["beta1"])
                nu = opt["nu"][k].mul_(tr["beta2"]).addcmul_(
                    g, g, value=1.0 - tr["beta2"])
                p.sub_(tr["learning_rate"] * (mu / bc1)
                       / (torch.sqrt(nu / bc2) + tr["adam_eps"]))

    @staticmethod
    def _grads(loss, params: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        names = list(params)
        gs = torch.autograd.grad(loss, [params[k] for k in names],
                                 allow_unused=True)
        return {k: torch.zeros_like(params[k]) if g is None else g
                for k, g in zip(names, gs)}

    def _ada_update(self, real_scores, batch: int):
        a, ac = self.ada, self.cfg["augment"]["ada"]
        a["sign_sum"] += float(torch.sign(real_scores).sum())
        a["count"] += float(real_scores.shape[0])
        if a["count"] > batch * ac["interval_batches"] - 1:
            r_t = a["sign_sum"] / max(a["count"], 1.0)
            direction = 1.0 if r_t > ac["ada_target"] else -1.0
            a["p"] = min(max(a["p"] + direction * batch / ac["ada_length"]
                             * a["count"], 0.0), 1.0)
            a["sign_sum"] = a["count"] = 0.0

    # -- the iteration ------------------------------------------------------
    def step(self, real, labels, z, eps, draws: Optional[List] = None,
             apply_gp: bool = True) -> Dict[str, float]:
        """One iteration on NHWC ``real`` in [-1, 1]; ``draws`` are the
        three draw sources (reals, the D step's fakes, the G step's fakes)
        when the configuration augments.  Returns the step's losses."""
        cfg, tr, prec = self.cfg, self.tr, self.prec
        gcfg, dcfg, step = cfg["generator"], cfg["discriminator"], cfg["step"]
        pipe_cfg = (cfg["augment"]["pipe"] if cfg.get("augment") else None)
        fused = bool(tr["fused_g"])
        lam = tr["lambda_gp"] * tr["gp_every"]
        bsz = real.shape[0]
        real, eps = real.float(), eps.float()

        p_now = self.ada["p"]     # every pipe of the iteration applies it

        def augment(src, img):
            if pipe_cfg is None:
                return img
            return aug.bgc_pipe(src, img, pipe_cfg, p_now, prec.q)

        def D(img):
            return nets.discriminator(self.d, dcfg, img, labels, step, prec)

        def G():
            return nets.generator(self.g, gcfg, z, labels, step, prec)

        with torch.no_grad():
            real = augment(draws and draws[0], real)
        if fused:
            fake = augment(draws and draws[1], G())
        else:
            with torch.no_grad():
                fake = augment(draws and draws[1], G())
        real_scores, fake_scores = D(real), D(fake)
        gp = torch.zeros((), device=real.device)
        if apply_gp:
            x_hat = (eps * real + (1 - eps) * fake.detach()).requires_grad_(
                True)
            gx, = torch.autograd.grad(D(x_hat).sum(), x_hat,
                                      create_graph=True)
            norms = torch.sqrt(torch.sum(gx * gx, dim=(1, 2, 3)))
            gp = lam * torch.mean((norms - 1.0) ** 2)
        real_drifted = (real_scores.mean()
                        - tr["drift"] * torch.mean(real_scores ** 2))
        loss = -real_drifted + fake_scores.mean() + gp
        out = {k: float(v.detach()) for k, v in (
            ("d_total", loss), ("grad_penalty", gp),
            ("real_score", real_scores.mean()),
            ("fake_score", fake_scores.mean()))}
        if fused:
            # one joint pass: D's gradient and, negated, G's
            both = self._grads(loss, {**{"d." + k: v for k, v in
                                         self.d.items()},
                                      **{"g." + k: v for k, v in
                                         self.g.items()}})
            d_grads = {k: both["d." + k] for k in self.d}
            g_grads = {k: -both["g." + k] for k in self.g}
        else:
            d_grads, g_grads = self._grads(loss, self.d), None
        del loss, gp, fake
        self._adam(self.d, d_grads, self.opt_d)
        if pipe_cfg is not None and cfg["augment"].get("ada"):
            self._ada_update(real_scores.detach(), bsz)
        out["ada_count"] = self.ada["count"]
        if fused:
            out["g_loss"] = -out["fake_score"]
        else:
            g_loss = -D(augment(draws and draws[2], G())).mean()
            out["g_loss"] = float(g_loss.detach())
            g_grads = self._grads(g_loss, self.g)
            del g_loss
        self._adam(self.g, g_grads, self.opt_g)
        with torch.no_grad():
            decay = tr["ema_decay"]
            for k, v in self.ema.items():
                v.mul_(decay).add_(self.g[k], alpha=1.0 - decay)
        self.iteration += 1
        return out
