"""Import reference PyTorch checkpoints (counterpart of
``pgx/checkpoint/torch_import.py``).

The reference saves raw ``state_dict``s as ``{iter}_g.model`` /
``{iter}_d.model`` and its FID sweeps consume them.  This module turns
those state dicts into parameter trees in ``pgx``'s layout and key names
(nested dicts of numpy arrays, which ``Generator.from_jax_params`` and
``pgx_torch.checkpoint.save_params`` take): torch OIHW conv weights ->
HWIO, IOHW transposed convs -> HWOI, transposed linear weights, and the
``weight_orig`` equalized-LR key resolved by the layer's static scale.  So
reference-trained models can be swept (``pgx_torch.cli.fid_sweep``) and
sampled by the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from pgx_torch.models import zoo
from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig

Params = Dict[str, Any]


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _hwio(x) -> np.ndarray:
    return np.ascontiguousarray(_t(x).transpose(2, 3, 1, 0))


def conv_from(sd: Dict[str, Any], prefix: str) -> Params:
    """EqualConv2d: torch OIHW -> HWIO."""
    return {"w": _hwio(sd[prefix + ".conv.weight_orig"]),
            "b": _t(sd[prefix + ".conv.bias"])}


def convt_from(sd: Dict[str, Any], prefix: str) -> Params:
    """EqualConvTranspose2d: torch IOHW -> HWOI."""
    return {"w": _hwio(sd[prefix + ".conv.weight_orig"]),
            "b": _t(sd[prefix + ".conv.bias"])}


def linear_from(sd: Dict[str, Any], prefix: str) -> Params:
    return {"w": np.ascontiguousarray(_t(sd[prefix + ".linear.weight_orig"]).T),
            "b": _t(sd[prefix + ".linear.bias"])}


def embed_from(sd: Dict[str, Any], prefix: str,
               equalized: bool = False) -> Params:
    key = prefix + (".embed.weight_orig" if equalized else ".weight")
    return {"w": _t(sd[key])}


def block_from(sd: Dict[str, Any], prefix: str, pixel_norm: bool = True,
               single: bool = False) -> Params:
    """ConvBlock / MnistConvBlock: the Sequential's conv indices depend on
    whether PixelNorm layers are interleaved."""
    if single:
        return {"conv1": conv_from(sd, prefix + ".conv.0")}
    second = 3 if pixel_norm else 2
    return {"conv1": conv_from(sd, prefix + ".conv.0"),
            "conv2": conv_from(sd, prefix + f".conv.{second}")}


def generator_params_from_state_dict(sd: Dict[str, Any],
                                     cfg: GeneratorConfig) -> Params:
    """Any reference generator state dict as a params tree."""
    params: Params = {"blocks": {}, "to_rgb": {}}
    if cfg.conditioning != "none":
        params["embedding"] = embed_from(sd, "embedding",
                                         equalized=cfg.equal_embed)
    if cfg.arch == "proper":
        params["input"] = convt_from(sd, "progression_4.0")
        params["blocks"]["4"] = {"conv1": conv_from(sd, "progression_4.3")}
    else:
        params["input"] = convt_from(sd, "input_layer.0")
        params["blocks"]["4"] = block_from(
            sd, "progression_4", pixel_norm=cfg.pixel_norm,
            single=cfg.block_type == "single")
    for k in range(1, cfg.num_stages):
        res = 4 * 2 ** k
        params["blocks"][str(res)] = block_from(
            sd, f"progression_{res}", pixel_norm=cfg.pixel_norm,
            single=cfg.block_type == "single")
    first_rgb = 0 if cfg.arch == "proper" else 1
    for k in range(first_rgb, cfg.num_stages):
        res = 4 * 2 ** k
        params["to_rgb"][str(res)] = conv_from(sd, f"to_rgb_{res}")
    return params


def discriminator_params_from_state_dict(sd: Dict[str, Any],
                                         cfg: DiscriminatorConfig) -> Params:
    """Any reference discriminator state dict as a params tree.  Both
    reference loop conventions index progression/from_rgb so that list
    index i is stage k = num_stages - 1 - i."""
    n = cfg.num_stages
    params: Params = {"blocks": {}, "from_rgb": {}}
    for k in range(n):
        i = n - 1 - k
        res = str(4 * 2 ** k)
        params["blocks"][res] = block_from(
            sd, f"progression.{i}", pixel_norm=True,
            single=(cfg.block_type == "single" and k > 0))
        params["from_rgb"][res] = conv_from(sd, f"from_rgb.{i}")
    if cfg.conditioning == "label_plane":
        params["embeddings"] = {}
        for k in range(n):
            i = n - 1 - k
            params["embeddings"][str(4 * 2 ** k)] = embed_from(
                sd, f"embeddings.{i}", equalized=cfg.equal_embed)
    elif cfg.conditioning == "projection":
        params["embedding"] = embed_from(sd, "embedding")
    params["linear"] = linear_from(sd, "linear")
    return params


# ---------------------------------------------------------------------------
# Reference model families -> zoo configs
# ---------------------------------------------------------------------------

def _gc(ref_cfg: Dict[str, Any]) -> Dict[str, Any]:
    return dict(ref_cfg.get("generator", {}))


def _dc(ref_cfg: Dict[str, Any]) -> Dict[str, Any]:
    return dict(ref_cfg.get("discriminator", {}))


def _legacy(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    ms = int(ref_cfg.get("max_step", 6))
    return (zoo.legacy_generator(
                z_dim=g.get("input_code_dim", 128),
                channel=g.get("in_channel", 128),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", True), max_step=ms),
            zoo.legacy_discriminator(feat_dim=d.get("feat_dim", 128),
                                     max_step=ms))


def _cond_legacy(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    ms = int(ref_cfg.get("max_step", 6))
    return (zoo.conditional_generator(
                z_dim=g.get("input_code_dim", 128),
                num_classes=num_classes, channel=g.get("in_channel", 128),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", True), max_step=ms),
            zoo.conditional_discriminator_wgangp(
                feat_dim=d.get("feat_dim", 128), num_classes=num_classes,
                max_step=ms))


def _proper(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    ms = int(ref_cfg.get("max_step", 4))
    return (zoo.correct_generator(
                z_dim=g.get("input_code_dim", 512),
                channel=g.get("in_channel", 512),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", False), max_step=ms),
            zoo.correct_discriminator(feat_dim=d.get("feat_dim", 512),
                                      max_step=ms))


def _cond_proper(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    ms = int(ref_cfg.get("max_step", 4))
    return (zoo.conditional_correct_generator(
                z_dim=g.get("input_code_dim", 512),
                num_classes=num_classes, channel=g.get("in_channel", 512),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", False),
                do_equal_embed=g.get("do_equal_embed", False), max_step=ms),
            zoo.conditional_correct_discriminator_wgangp(
                feat_dim=d.get("feat_dim", 512), num_classes=num_classes,
                do_equal_embed=d.get("do_equal_embed", False), max_step=ms))


def _cond_proper_ada(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    ms = int(ref_cfg.get("max_step", 4))
    return (zoo.conditional_correct_generator_ada(
                z_dim=g.get("input_code_dim", 512),
                num_classes=num_classes, channel=g.get("in_channel", 512),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", False), max_step=ms),
            zoo.conditional_correct_discriminator_ada(
                feat_dim=d.get("feat_dim", 512), num_classes=num_classes,
                max_step=ms))


def _mnist(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    return (zoo.mnist_generator(
                z_dim=g.get("input_code_dim", 128),
                channel=g.get("in_channel", 64),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", True),
                use_mnist_conv_blocks=g.get("use_mnist_conv_blocks", True)),
            zoo.mnist_discriminator(
                feat_dim=d.get("feat_dim", 64),
                use_mnist_conv_blocks=d.get("use_mnist_conv_blocks", True)))


def _cond_mnist(ref_cfg, num_classes):
    g, d = _gc(ref_cfg), _dc(ref_cfg)
    return (zoo.mnist_conditional_generator(
                z_dim=g.get("input_code_dim", 128),
                num_classes=num_classes, channel=g.get("in_channel", 64),
                pixel_norm=g.get("pixel_norm", True),
                tanh=g.get("tanh", True),
                use_mnist_conv_blocks=g.get("use_mnist_conv_blocks", True)),
            zoo.mnist_conditional_discriminator_wgangp(
                feat_dim=d.get("feat_dim", 64), num_classes=num_classes,
                use_mnist_conv_blocks=d.get("use_mnist_conv_blocks", True)))


FAMILIES: Dict[str, Callable[[Dict[str, Any], int],
                             Tuple[GeneratorConfig, DiscriminatorConfig]]] = {
    "legacy": _legacy,                      # train.py / cifar_train.py
    "conditional_legacy": _cond_legacy,     # conditional_cifar10_wgan_train
    "proper": _proper,                      # proper_cifar_train.py
    "conditional_proper": _cond_proper,     # conditional_proper_{cifar,wikiart}
    "conditional_proper_ada": _cond_proper_ada,
    "mnist": _mnist,                        # mnist_train.py
    "conditional_mnist": _cond_mnist,       # conditional_mnist_wgan_train.py
}


def infer_ref_config(g_sd: Dict[str, Any],
                     d_sd: Dict[str, Any] = None) -> Dict[str, Any]:
    """The reference config JSON's fields as far as a generator state
    dict's shapes give them, for single-file imports without a
    ``train_config_*.json``.  pixel_norm and tanh are not in the shapes
    (each family has its default)."""
    gen: Dict[str, Any] = {}
    embed_dim = 0
    for key in ("embedding.weight", "embedding.embed.weight_orig"):
        if key in g_sd:
            embed_dim = int(g_sd[key].shape[1])
    for key in ("progression_4.0.conv.weight_orig",
                "input_layer.0.conv.weight_orig"):
        if key in g_sd:
            w = g_sd[key]                       # torch IOHW for transpose
            gen["input_code_dim"] = int(w.shape[0]) - embed_dim
            gen["in_channel"] = int(w.shape[1])
            break
    if "progression_4.conv.0.conv.weight_orig" in g_sd:
        gen["use_mnist_conv_blocks"] = (
            "progression_4.conv.3.conv.weight_orig" not in g_sd
            and "progression_4.conv.2.conv.weight_orig" not in g_sd)
    cfg: Dict[str, Any] = {"generator": gen}
    if d_sd is not None and "linear.linear.weight_orig" in d_sd:
        cfg["discriminator"] = {
            "feat_dim": int(d_sd["linear.linear.weight_orig"].shape[1]),
            "use_mnist_conv_blocks": gen.get("use_mnist_conv_blocks", False),
        }
    return cfg


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return sd


def import_checkpoint_pair(g_path, d_path, gcfg: GeneratorConfig,
                           dcfg: DiscriminatorConfig
                           ) -> Tuple[Params, Params]:
    """Read torch ``.model`` files and return ``(g_params, d_params)``
    (None for a path not given)."""
    g_params = generator_params_from_state_dict(
        load_torch_state_dict(g_path), gcfg) if g_path else None
    d_params = discriminator_params_from_state_dict(
        load_torch_state_dict(d_path), dcfg) if d_path else None
    return g_params, d_params
