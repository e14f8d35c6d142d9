"""upfirdn2d — pad / upsample (zero-stuff) / FIR filter / downsample, NHWC.

Counterpart of ``pgx/ops/upfirdn2d.py``.  The filter convention is the
reference's: the default performs a true convolution (the filter is flipped
before correlation); ``flip_filter=True`` correlates with the filter as
given.  Filters are host constants (numpy, a sequence, or a CPU tensor),
shaped ``(fh, fw)`` or ``(fw,)`` for separable application; they are never
differentiated.

Dispatch: a 1-D (separable) filter of at most ``MAX_TAPS`` (64) taps with
``up`` and ``down`` in {1, 2} goes to kernel D
(``pgx_torch.ops.kernels.upfirdn2d``): a CUDA tensor launches it or raises,
a CPU tensor takes its plain version.  A 2-D filter, a longer one, or other
factors, takes the grouped-convolution formulation below, which pgx also
computes outside its kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from pgx_torch.ops.kernels.upfirdn2d import MAX_TAPS, upfirdn2d_separable

FilterLike = Union[np.ndarray, torch.Tensor, Sequence[float], None]


def _filter_array(f: FilterLike) -> np.ndarray:
    """The filter as a float32 numpy array; ``None`` is the 1x1 identity."""
    if f is None:
        return np.ones((1, 1), np.float32)
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    return np.asarray(f, np.float32)


def setup_filter(f: FilterLike, normalize: bool = True,
                 flip_filter: bool = False, gain: float = 1.0,
                 separable: Optional[bool] = None) -> torch.Tensor:
    """Prepare a FIR filter: a float32 CPU tensor of shape ``(fh, fw)``, or
    ``(fw,)`` when separable (a 1-D input of 8 or more taps by default)."""
    if f is None:
        f = 1.0
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f, np.float64)
    assert f.ndim in (0, 1, 2)
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = f.ndim == 1 and f.size >= 8
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = np.flip(f, axis=tuple(range(f.ndim)))
    f = f * gain ** (f.ndim / 2)
    return torch.from_numpy(np.ascontiguousarray(f, np.float32))


def _parse_padding(padding) -> Tuple[int, int, int, int]:
    if isinstance(padding, int):
        return padding, padding, padding, padding
    padding = list(padding)
    if len(padding) == 2:
        px, py = padding
        return px, px, py, py
    px0, px1, py0, py1 = padding
    return px0, px1, py0, py1


def _zero_stuff(x: torch.Tensor, up: int) -> torch.Tensor:
    """NCHW ``x`` with ``up - 1`` zeros after every sample of H and W."""
    if up == 1:
        return x
    b, c, h, w = x.shape
    y = x.new_zeros(b, c, h, up, w, up)
    y[:, :, :, 0, :, 0] = x
    return y.reshape(b, c, h * up, w * up)


def _pad_or_crop(x: torch.Tensor, px0: int, px1: int, py0: int,
                 py1: int) -> torch.Tensor:
    x = F.pad(x, (max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)))
    return x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0),
             max(-px0, 0):x.shape[3] - max(-px1, 0)]


def upfirdn2d(x: torch.Tensor, f: FilterLike, up: int = 1, down: int = 1,
              padding=0, flip_filter: bool = False,
              gain: float = 1.0) -> torch.Tensor:
    """Fused pad -> upsample(up) -> FIR filter -> downsample(down), NHWC,
    including negative padding (crop)."""
    f = _filter_array(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    if (f.ndim == 1 and up in (1, 2) and down in (1, 2)
            and f.shape[0] <= MAX_TAPS):
        # the gain is split evenly over the two passes, in f32 as pgx does
        taps = f * np.float32(np.sqrt(gain))
        return upfirdn2d_separable(x, taps.tolist(), up, down,
                                   (px0, px1, py0, py1), flip_filter)

    if f.ndim == 1:
        taps = f * np.float32(np.sqrt(gain))
        kernels = [taps.reshape(-1, 1), taps.reshape(1, -1)]
    else:
        kernels = [f * np.float32(gain)]
    c = x.shape[-1]
    y = _pad_or_crop(_zero_stuff(x.permute(0, 3, 1, 2), up),
                     px0, px1, py0, py1)
    for k in kernels:
        if not flip_filter:
            k = k[::-1, ::-1]
        w = torch.from_numpy(k.copy()).to(
            device=x.device, dtype=x.dtype)
        y = F.conv2d(y, w[None, None].expand(c, 1, *w.shape), groups=c)
    return y[:, :, ::down, ::down].permute(0, 2, 3, 1).contiguous()


def _filter_hw(f: np.ndarray) -> Tuple[int, int]:
    return (f.shape[0], f.shape[0]) if f.ndim == 1 else f.shape


def filter2d(x: torch.Tensor, f: FilterLike, padding=0,
             flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Same-resolution filtering."""
    f = _filter_array(f)
    fh, fw = _filter_hw(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    px0 += fw // 2
    px1 += (fw - 1) // 2
    py0 += fh // 2
    py1 += (fh - 1) // 2
    return upfirdn2d(x, f, padding=(px0, px1, py0, py1),
                     flip_filter=flip_filter, gain=gain)


def upsample2d(x: torch.Tensor, f: FilterLike, up: int = 2, padding=0,
               flip_filter: bool = False, gain: float = 1.0) -> torch.Tensor:
    """Upsample with FIR smoothing."""
    f = _filter_array(f)
    fh, fw = _filter_hw(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    px0 = px0 * up + (fw + up - 1) // 2
    px1 = px1 * up + (fw - up) // 2
    py0 = py0 * up + (fh + up - 1) // 2
    py1 = py1 * up + (fh - up) // 2
    return upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1),
                     flip_filter=flip_filter, gain=gain * up * up)


def downsample2d(x: torch.Tensor, f: FilterLike, down: int = 2, padding=0,
                 flip_filter: bool = False,
                 gain: float = 1.0) -> torch.Tensor:
    """Downsample with FIR anti-aliasing."""
    f = _filter_array(f)
    fh, fw = _filter_hw(f)
    px0, px1, py0, py1 = _parse_padding(padding)
    px0 += (fw - down + 1) // 2
    px1 += (fw - down) // 2
    py0 += (fh - down + 1) // 2
    py1 += (fh - down) // 2
    return upfirdn2d(x, f, down=down, padding=(px0, px1, py0, py1),
                     flip_filter=flip_filter, gain=gain)
