"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the pool of synthetic real images with their labels, and each
iteration's draws (z, the penalty's eps, the augmentation draws).

Everything is made on the device from ``torch.Generator``s seeded by
``common.sub_seed``: the weights in one call per net, the pool in one
call, and each iteration's draws from generators seeded by the iteration's
index, so the reference replays any iteration by its index alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

from perfbench.lib.common import sub_seed
from perfbench.reference import nets

WEIGHTS, POOL, DRAWS = 1, 2, 3


def make_params(torch, shapes: Dict[str, tuple], seed: int, stream: int,
                device) -> Dict[str, torch.Tensor]:
    """float32 parameters of the given shapes: N(0, 1) weights from one
    draw, zero biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, WEIGHTS, stream))
    sizes = {k: int(torch.Size(s).numel()) for k, (s, init) in
             shapes.items() if init == "normal"}
    flat = torch.randn(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for k, (shape, init) in shapes.items():
        if init == "normal":
            out[k] = flat[at:at + sizes[k]].view(shape).clone()
            at += sizes[k]
        else:
            out[k] = torch.zeros(shape, device=device)
    return out


def make_weights(torch, cfg: dict, seed: int, device):
    """(G's, D's) parameters of the configuration."""
    return (make_params(torch, nets.g_param_shapes(cfg["generator"]), seed,
                        0, device),
            make_params(torch, nets.d_param_shapes(cfg["discriminator"]),
                        seed, 1, device))


class Draws:
    """A draw source over one generator: float32 ``uniform`` and
    ``normal`` of the shapes the caller asks for, on the device."""

    def __init__(self, torch, gen):
        self.torch, self.gen = torch, gen

    def uniform(self, shape):
        return self.torch.rand(tuple(shape), generator=self.gen,
                               device=self.gen.device)

    def normal(self, shape):
        return self.torch.randn(tuple(shape), generator=self.gen,
                                device=self.gen.device)


class Feed:
    """The training traffic: iteration ``i`` takes rows ``[i B, (i + 1) B)``
    (mod the pool) of the pool of synthetic reals and labels, and draws z
    (N(0, 1)), eps (U[0, 1)) and three augmentation sources from
    generators seeded by ``(seed, i)``."""

    def __init__(self, torch, device, seed: int, cfg: dict, mix: dict):
        self.torch, self.seed = torch, seed
        self.batch = int(mix["batch"])
        self.z_dim = cfg["generator"]["z_dim"]
        n = int(mix["pool"])
        if n % self.batch:
            raise ValueError(f"pool {n} is not a multiple of the batch "
                             f"{self.batch}")
        res = 4 * 2 ** (int(mix["step"]) - 1)
        gen = torch.Generator(device=device)
        gen.manual_seed(sub_seed(seed, POOL))
        # smooth images in [-1, 1]: 8x8 noise, bilinear to the resolution
        low = torch.randn(n, 3, 8, 8, generator=gen, device=device)
        img = torch.nn.functional.interpolate(low, size=(res, res),
                                              mode="bilinear",
                                              align_corners=False)
        self.reals = img.clamp_(-1.0, 1.0).permute(0, 2, 3, 1).contiguous()
        del low, img
        self.labels = torch.randint(0, cfg["generator"]["num_classes"], (n,),
                                    generator=gen, device=device)
        self.gens = [torch.Generator(device=device) for _ in range(4)]

    def rows(self, i: int):
        """Iteration ``i``'s reals and labels."""
        at = (i * self.batch) % self.reals.shape[0]
        return (self.reals[at:at + self.batch],
                self.labels[at:at + self.batch])

    def draws(self, i: int) -> Tuple:
        """Iteration ``i``'s z, eps and three augmentation draw sources."""
        torch = self.torch
        for s, g in enumerate(self.gens):
            g.manual_seed(sub_seed(self.seed, DRAWS, i, s))
        z = torch.randn(self.batch, self.z_dim, generator=self.gens[0],
                        device=self.gens[0].device)
        eps = torch.rand(self.batch, 1, 1, 1, generator=self.gens[0],
                         device=self.gens[0].device)
        return z, eps, [Draws(torch, g) for g in self.gens[1:]]

    def batch_of(self, i: int) -> Tuple:
        real, labels = self.rows(i)
        z, eps, aug = self.draws(i)
        return real, labels, z, eps, aug
