"""Export parameter trees to reference PyTorch state dicts (counterpart of
``pgx/checkpoint/torch_export.py``).

The inverse of ``pgx_torch.checkpoint.torch_import``: trees in ``pgx``'s
layout are laid out again as the exact ``state_dict`` schema of the
reference's model classes (HWIO -> OIHW conv weights, HWOI -> IOHW
transposed convs, transposed linear weights, the ``weight_orig``
equalized-LR key names), so a model trained by either package loads into
the reference's code with a strict ``load_state_dict``.

The reference's MNIST discriminator keeps two dead blocks whose parameters
are in its state dicts but in no forward; the trees do not carry them, so
the exporter writes zero tensors of their shapes for strict loading.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from pgx_torch.models.config import DiscriminatorConfig, GeneratorConfig

Params = Dict[str, Any]
StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    """Contiguous float32 numpy: the reference is f32."""
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32))


def conv_to(p: Params, prefix: str, sd: StateDict) -> None:
    """EqualConv2d: HWIO -> torch OIHW (+ the EqualLR weight_orig key)."""
    sd[prefix + ".conv.weight_orig"] = np.ascontiguousarray(
        _a(p["w"]).transpose(3, 2, 0, 1))
    sd[prefix + ".conv.bias"] = _a(p["b"])


def convt_to(p: Params, prefix: str, sd: StateDict) -> None:
    """EqualConvTranspose2d: HWOI -> torch IOHW."""
    sd[prefix + ".conv.weight_orig"] = np.ascontiguousarray(
        _a(p["w"]).transpose(3, 2, 0, 1))
    sd[prefix + ".conv.bias"] = _a(p["b"])


def linear_to(p: Params, prefix: str, sd: StateDict) -> None:
    sd[prefix + ".linear.weight_orig"] = np.ascontiguousarray(_a(p["w"]).T)
    sd[prefix + ".linear.bias"] = _a(p["b"])


def embed_to(p: Params, prefix: str, equalized: bool,
             sd: StateDict) -> None:
    key = prefix + (".embed.weight_orig" if equalized else ".weight")
    sd[key] = _a(p["w"])


def block_to(p: Params, prefix: str, pixel_norm: bool, single: bool,
             sd: StateDict) -> None:
    """Inverse of ``torch_import.block_from``."""
    conv_to(p["conv1"], prefix + ".conv.0", sd)
    if not single:
        conv_to(p["conv2"], prefix + f".conv.{3 if pixel_norm else 2}", sd)


def generator_state_dict_from_params(params: Params,
                                     cfg: GeneratorConfig) -> StateDict:
    """Any generator params tree as its reference state dict."""
    sd: StateDict = {}
    if cfg.conditioning != "none":
        embed_to(params["embedding"], "embedding", cfg.equal_embed, sd)
    single = cfg.block_type == "single"
    if cfg.arch == "proper":
        convt_to(params["input"], "progression_4.0", sd)
        # the proper 4x4 block pixel-norms unconditionally: the fixed .3
        conv_to(params["blocks"]["4"]["conv1"], "progression_4.3", sd)
    else:
        convt_to(params["input"], "input_layer.0", sd)
        block_to(params["blocks"]["4"], "progression_4", cfg.pixel_norm,
                 single, sd)
    for k in range(1, cfg.num_stages):
        res = 4 * 2 ** k
        block_to(params["blocks"][str(res)], f"progression_{res}",
                 cfg.pixel_norm, single, sd)
    first_rgb = 0 if cfg.arch == "proper" else 1
    for k in range(first_rgb, cfg.num_stages):
        res = 4 * 2 ** k
        conv_to(params["to_rgb"][str(res)], f"to_rgb_{res}", sd)
    return sd


def _is_mnist_discriminator(cfg: DiscriminatorConfig) -> bool:
    """The one reference D class with dead blocks: the grayscale 4-stage
    unconditional mnist_pggan.Discriminator."""
    return (cfg.arch == "legacy" and cfg.img_channels == 1
            and cfg.conditioning == "none" and cfg.num_stages == 4)


def discriminator_state_dict_from_params(
        params: Params, cfg: DiscriminatorConfig,
        dead_mnist_blocks: Optional[bool] = None) -> StateDict:
    """Any discriminator params tree as its reference state dict (list
    index i is stage k = num_stages - 1 - i)."""
    n = cfg.num_stages
    sd: StateDict = {}
    for k in range(n):
        i = n - 1 - k
        res = str(4 * 2 ** k)
        block_to(params["blocks"][res], f"progression.{i}", True,
                 cfg.block_type == "single" and k > 0, sd)
        conv_to(params["from_rgb"][res], f"from_rgb.{i}", sd)
    if cfg.conditioning == "label_plane":
        for k in range(n):
            i = n - 1 - k
            embed_to(params["embeddings"][str(4 * 2 ** k)],
                     f"embeddings.{i}", cfg.equal_embed, sd)
    elif cfg.conditioning == "projection":
        embed_to(params["embedding"], "embedding", False, sd)
    linear_to(params["linear"], "linear", sd)

    if dead_mnist_blocks is None:
        dead_mnist_blocks = _is_mnist_discriminator(cfg)
    if dead_mnist_blocks:
        feat = int(cfg.stage_out[0])
        for name, ksize in (("mnist_progression_0", 3),
                            ("mnist_progression_1", 4)):
            sd[f"{name}.conv.0.conv.weight_orig"] = np.zeros(
                (feat, feat + 1, ksize, ksize), np.float32)
            sd[f"{name}.conv.0.conv.bias"] = np.zeros((feat,), np.float32)
    return sd


# ---------------------------------------------------------------------------
# zoo configs -> reference model families / config JSON
# ---------------------------------------------------------------------------

def infer_family(gcfg: GeneratorConfig, dcfg: DiscriminatorConfig) -> str:
    """The reference family (a ``torch_import.FAMILIES`` key) of a config
    pair: the inverse of the importer's dispatch."""
    if gcfg.arch == "proper":
        if gcfg.conditioning == "none":
            return "proper"
        if dcfg.conditioning == "projection":
            return "conditional_proper_ada"
        return "conditional_proper"
    mnist = gcfg.img_channels == 1 and gcfg.num_stages == 4
    if gcfg.conditioning == "none":
        return "mnist" if mnist else "legacy"
    return "conditional_mnist" if mnist else "conditional_legacy"


def reference_config_from_configs(gcfg: GeneratorConfig,
                                  dcfg: DiscriminatorConfig,
                                  family: Optional[str] = None
                                  ) -> Dict[str, Any]:
    """The ``generator`` / ``discriminator`` sections of the reference's
    ``train_config_*.json``: exactly the constructor arguments each
    family's classes take."""
    family = family or infer_family(gcfg, dcfg)
    gen: Dict[str, Any] = {"input_code_dim": gcfg.z_dim,
                           "in_channel": gcfg.channels[0],
                           "pixel_norm": gcfg.pixel_norm,
                           "tanh": gcfg.tanh}
    dis: Dict[str, Any] = {"feat_dim": int(dcfg.stage_out[0])}
    if family in ("mnist", "conditional_mnist"):
        gen["use_mnist_conv_blocks"] = gcfg.block_type == "single"
        dis["use_mnist_conv_blocks"] = dcfg.block_type == "single"
    else:
        gen["max_step"] = gcfg.max_step
    if gcfg.conditioning != "none":
        gen["num_of_classes"] = gcfg.num_classes
        dis["num_of_classes"] = dcfg.num_classes
    if family == "conditional_proper":
        gen["do_equal_embed"] = gcfg.equal_embed
        dis["do_equal_embed"] = dcfg.equal_embed
    return {"generator": gen, "discriminator": dis,
            "max_step": gcfg.max_step}


def save_torch_checkpoint(sd: StateDict, path: str) -> None:
    """Write a state dict as a reference ``.model`` file (torch.save)."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)


def export_checkpoint_pair(g_params: Optional[Params],
                           d_params: Optional[Params],
                           gcfg: GeneratorConfig, dcfg: DiscriminatorConfig,
                           g_path: Optional[str] = None,
                           d_path: Optional[str] = None) -> None:
    """Write params trees as reference ``.model`` files."""
    if g_params is not None and g_path:
        save_torch_checkpoint(
            generator_state_dict_from_params(g_params, gcfg), g_path)
    if d_params is not None and d_path:
        save_torch_checkpoint(
            discriminator_state_dict_from_params(d_params, dcfg), d_path)
