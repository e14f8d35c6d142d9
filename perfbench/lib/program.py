"""The system under test, built through its normal entry points from a
configuration: ``pgx_torch``'s models, train state, train step (one
iteration or a window of k) and ``GeneratorService``."""

from __future__ import annotations

from typing import Optional


def effective(cfg: dict, mix: dict) -> dict:
    """The configuration as a cell runs it: at the mix's stage.  Every
    other setting is the configuration file's own."""
    return {**cfg, "step": int(mix["step"])}


def configs(cfg: dict):
    """The program's (GeneratorConfig, DiscriminatorConfig, TrainConfig)."""
    from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig
    from pgx_torch.train.wgan import TrainConfig
    g = dict(cfg["generator"], channels=tuple(cfg["generator"]["channels"]))
    d = dict(cfg["discriminator"],
             stage_in=tuple(cfg["discriminator"]["stage_in"]),
             stage_out=tuple(cfg["discriminator"]["stage_out"]))
    return GeneratorConfig(**g), DiscriminatorConfig(**d), TrainConfig(
        **cfg["train"])


def augment_configs(cfg: dict):
    """(AugmentConfig, AdaConfig or None), or (None, None)."""
    aug = cfg.get("augment")
    if not aug:
        return None, None
    from pgx_torch.augment import AdaConfig, AugmentConfig
    pipe = dict(aug["pipe"])
    pipe["imgfilter_bands"] = tuple(pipe.get("imgfilter_bands",
                                             (1.0, 1.0, 1.0, 1.0)))
    ada = AdaConfig(**aug["ada"]) if aug.get("ada") else None
    return AugmentConfig(**pipe), ada


def train_state(torch, cfg: dict, g_init: dict, d_init: dict, device,
                ada_p0: float = 0.0) -> dict:
    """The program's train state holding copies of the given weights."""
    from pgx_torch.augment import init_ada_state
    from pgx_torch.models.discriminator import Discriminator
    from pgx_torch.models.generator import Generator
    from pgx_torch.train import wgan
    gcfg, dcfg, _ = configs(cfg)
    with torch.device(device):
        g = Generator(gcfg, trainable=True)
        d = Discriminator(dcfg)
        g_ema = Generator(gcfg)
    g.load_state_dict(g_init, strict=True)
    d.load_state_dict(d_init, strict=True)
    g_ema.load_state_dict(g_init, strict=True)
    state = wgan._build_state(g, d, g_ema)
    state["ada"] = init_ada_state(ada_p0, device)
    return state


def train_call(cfg: dict, k: int):
    """The window's entry: ``make_train_step`` (k == 1) or
    ``make_train_multi_step`` (a window of k iterations)."""
    from pgx_torch.train import wgan
    gcfg, dcfg, tc = configs(cfg)
    augment_cfg, ada_cfg = augment_configs(cfg)
    kw = dict(step=cfg["step"], fading=False, augment_cfg=augment_cfg,
              ada_cfg=ada_cfg)
    if k == 1:
        return wgan.make_train_step(gcfg, dcfg, tc, **kw)
    return wgan.make_train_multi_step(gcfg, dcfg, tc, k=k, **kw)


def service(torch, cfg: dict, g_init: dict, mix: dict,
            device: Optional[str] = None):
    """``GeneratorService.from_params`` over the given G weights (the
    service takes a host tree: the weights are made on the device and
    copied to the host once)."""
    from pgx_torch.serve import GeneratorService
    gcfg, _, _ = configs(cfg)
    tree: dict = {}
    for name, t in g_init.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().cpu().numpy()
    kw = dict(step=cfg["step"], max_batch=int(mix["max_batch"]),
              output=mix.get("output", "uint8"))
    if "max_wait_ms" in mix:
        kw["max_wait_ms"] = float(mix["max_wait_ms"])
    if device is not None:
        kw["device"] = device
    return GeneratorService.from_params(gcfg, tree, **kw)
