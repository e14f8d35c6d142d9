"""FID (counterpart of ``pgx/eval/fid.py``): the reference's measurement
chain, quirks included.

* float generator outputs are squashed ``tanh(x) + 1`` then scaled by
  127.5 and truncated to uint8, in numpy on the host as ``pgx`` does it (a
  device ``tanh`` can differ by an ulp and flip a truncated byte);
* PIL's bilinear resize to 299x299, then ``/255``, ImageNet normalisation
  and pytorch_fid's ``2x - 1``.  On the CPU the resize is
  ``pgx_torch.data.datasets._resize_batch`` (PIL's fixed point in numpy)
  and the float chain numpy's; on a CUDA device the same fixed-point sums
  run as torch integer ops and the float chain is a lookup in a 256 x 3
  table that numpy computed with the host chain's operations, so both
  give the host path's bytes and floats exactly;
* InceptionV3 pool3 activations (2048 wide), batched;
* the Frechet distance with scipy's ``sqrtm`` and the eps-diagonal
  fallback for singular products (``sqrtm`` called without pgx's
  ``disp=False``, which scipy 1.18 removed: the same matrix).

The feature extractor is pluggable: ``make_extractor`` (the port's
InceptionV3 on a device, official weights when a file is given, random
weights otherwise), or any callable taking an NHWC float32 tensor
``(N, 299, 299, 3)`` on its ``device`` attribute's device (the CPU when it
has none) and returning ``(N, D)`` features.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pgx_torch.data.datasets import _PRECISION_BITS, _bilinear_taps, \
    _resize_batch
from pgx_torch.eval.inception import build_inception, init_inception
from pgx_torch.utils import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
SIZE = 299


def to_uint8_quirk(x: np.ndarray) -> np.ndarray:
    """The reference's float -> uint8 squash: ``tanh(x) + 1`` then
    ``* 127.5``, truncated.  Any float dtype takes the float32 path."""
    if x.dtype.kind == "f":
        x = np.tanh(np.asarray(x, np.float32)) + 1.0
        x = x * 127.5
        return x.astype(np.uint8)
    return x


def _float_chain(u8: np.ndarray) -> np.ndarray:
    """uint8 RGB -> pytorch_fid's input, in float32 as ``pgx`` computes
    it: ``/255``, ImageNet normalisation, ``2x - 1``."""
    out = np.asarray(u8, np.float32) / 255.0
    out = (out - IMAGENET_MEAN) / IMAGENET_STD
    return out * 2.0 - 1.0


# every (byte, channel) through the float chain: the device path's lookup
_TABLE = _float_chain(np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3,
                                axis=1))


def _rgb_uint8(images: np.ndarray) -> np.ndarray:
    """A batch (NHWC, NCHW float as the reference feeds, or NHW grey) as
    uint8 NHWC RGB: the quirk, then the layout ``pgx`` gives each item
    before PIL."""
    x = to_uint8_quirk(np.asarray(images))
    if x.dtype != np.uint8:
        raise TypeError(f"images must be float or uint8, got {x.dtype}")
    if (x.ndim == 4 and x.shape[1] in (1, 3)
            and x.shape[-1] not in (1, 3)):
        x = np.transpose(x, (0, 2, 3, 1))          # NCHW items -> NHWC
    if x.ndim == 3:
        x = x[..., None]
    if x.ndim != 4 or x.shape[-1] not in (1, 3):
        raise ValueError(f"images of shape {images.shape}: want RGB or grey")
    if x.shape[-1] == 1:
        x = np.repeat(x, 3, axis=-1)
    return np.ascontiguousarray(x)


def resize_uint8(x: torch.Tensor, size: int = SIZE) -> torch.Tensor:
    """PIL's BILINEAR resize of uint8 NHWC ``x`` to ``size`` x ``size`` as
    torch integer ops on ``x``'s device: the taps of ``_bilinear_taps``
    gathered along W then H, multiplied and summed in int64 (255 * 2^22 *
    taps overflows int32) with the half-unit rounding offset, shifted and
    clipped to uint8 after each pass.  The integer sums of
    ``_resize_batch``, so the bytes are PIL's."""
    for axis in (2, 1):                   # the horizontal pass first
        if x.shape[axis] == size:
            continue
        index, weight = _bilinear_taps(x.shape[axis], size)
        index = torch.from_numpy(index).to(x.device)
        weight = torch.from_numpy(weight).to(x.device)
        bshape = [1, 1, 1, 1]
        bshape[axis] = size
        shape = list(x.shape)
        shape[axis] = size
        acc = torch.full(shape, 1 << (_PRECISION_BITS - 1), dtype=torch.int64,
                         device=x.device)
        for k in range(index.shape[1]):
            acc += (torch.index_select(x, axis, index[:, k]).to(torch.int64)
                    * weight[:, k].reshape(bshape))
        x = torch.clamp(acc >> _PRECISION_BITS, 0, 255).to(torch.uint8)
    return x


def preprocess(images: np.ndarray, device="cpu") -> torch.Tensor:
    """Images (uint8 or float NHWC, NCHW float items, grey) -> float32 NHWC
    ``(N, 299, 299, 3)`` on ``device``, ready for the Inception forward.
    The CPU takes the numpy path; a CUDA device resizes and normalises on
    the device, with the same bytes and floats."""
    u8 = _rgb_uint8(images)
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.from_numpy(_float_chain(_resize_batch(u8, SIZE)))
    return _preprocess_tensor(torch.from_numpy(u8).to(dev))


def _preprocess_tensor(u8: torch.Tensor) -> torch.Tensor:
    """The device path on uint8 NHWC RGB: ``resize_uint8``, then each byte
    through the float chain by lookup."""
    x = resize_uint8(u8, SIZE).to(torch.int64)
    table = torch.from_numpy(_TABLE).to(x.device).flatten()
    return table[x * 3 + torch.arange(3, device=x.device)]


class _Extractor:
    """Pool3 features of a preprocessed NHWC batch on ``device``: f32
    convs with TF32 off for the call (cuDNN and cuBLAS allow it by default,
    which moves the features by ~1e-3 relative), the caller's flags
    restored after."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    def __call__(self, batch) -> np.ndarray:
        x = torch.as_tensor(batch, dtype=torch.float32).to(self.device)
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                feats = self.model(x.permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last))
            return feats.cpu().numpy()
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags


def make_extractor(params=None, *, generator: Optional[torch.Generator] = None,
                   device="cuda", mesh=None) -> Callable:
    """Pool3 feature extractor on ``device``: ``(N, 299, 299, 3)`` float32
    (tensor or numpy) -> ``(N, 2048)`` float32 numpy.  ``params``: a state
    dict in torchvision's names (``load_torch_weights``,
    ``inception_from_jax_params``); random weights from ``generator``
    (``init_inception``) when None.  ``mesh`` (data parallelism) is not
    ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "make_extractor(mesh=...): data parallelism is not ported yet "
            "(ROADMAP.md §1 item 5)")
    dev = resolve_device(device)
    if params is None:
        params = init_inception(generator)
    return _Extractor(build_inception(params, device=dev), dev)


def get_activations(data: np.ndarray, extractor: Callable,
                    batch_size: int = 50) -> np.ndarray:
    """Batched pool3 activations, float64 ``(N, D)``."""
    n = len(data)
    if n == 0:
        raise ValueError("no images to extract activations from")
    device = getattr(extractor, "device", "cpu")
    out = None
    for start in range(0, n, batch_size):
        batch = preprocess(data[start:start + batch_size], device)
        acts = np.asarray(extractor(batch))
        if out is None:
            out = np.empty((n, acts.shape[-1]), np.float64)
        out[start:start + len(acts)] = acts
    return out


def calculate_activation_statistics(
        data: np.ndarray, extractor: Callable,
        batch_size: int = 50) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of the pool3 activations."""
    act = get_activations(data, extractor, batch_size)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """Frechet distance with the reference's fallback for a singular
    product (an eps diagonal) and its check on the imaginary part."""
    from scipy import linalg

    mu1 = np.atleast_1d(mu1)
    mu2 = np.atleast_1d(mu2)
    sigma1 = np.atleast_2d(sigma1)
    sigma2 = np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different shapes: {mu1.shape}, "
                         f"{mu2.shape}, {sigma1.shape}, {sigma2.shape}")

    diff = mu1 - mu2
    # pgx passes disp=False and drops the error estimate; the matrix is the
    # same without it, and scipy 1.18 removed the argument
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_fid_given_data(data_1: np.ndarray, data_2: np.ndarray,
                             extractor: Optional[Callable] = None,
                             batch_size: int = 50) -> float:
    """FID of two in-memory image sets (random-weight extractor on the card
    when none is given)."""
    if extractor is None:
        extractor = make_extractor()
    m1, s1 = calculate_activation_statistics(data_1, extractor, batch_size)
    m2, s2 = calculate_activation_statistics(data_2, extractor, batch_size)
    return calculate_frechet_distance(m1, s1, m2, s2)
