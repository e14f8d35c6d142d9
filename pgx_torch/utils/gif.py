"""Training-evolution GIF maker (counterpart of ``pgx/utils/gif.py``,
numpy + PIL; a copy kept here so that the port imports nothing of
``pgx``; mirrors create_gif_proper_progan.py).

For each periodic sample grid PNG in a trial dir: re-derive (step, alpha)
from the sample's iteration index via the growth schedule (the reference
re-implements the proper-schedule arithmetic inline, :23-43 — here the
schedule object provides it), slice the grid into cells, nearest-resize each
to a uniform cell size, recompose, and append an info panel showing
step/resolution text plus an alpha progress bar (:79-129).  Output via PIL's
GIF writer (the reference used imageio + pygifsicle).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def sample_iteration(path: str) -> int:
    """Leading iteration index of a sample PNG ('000123.png' -> 123)."""
    return int(os.path.basename(path).split(".")[0])


def slice_grid(data: np.ndarray, im_size: int, rows: int, cols: int,
               padding: int = 2) -> List[np.ndarray]:
    """Cut a sample-grid PNG back into its cells (reference :46-57)."""
    cells = []
    for r in range(rows):
        y0 = padding * (r + 1) + r * im_size
        for c in range(cols):
            x0 = padding * (c + 1) + c * im_size
            cells.append(data[y0:y0 + im_size, x0:x0 + im_size])
    return cells


def nearest_resize(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor upscale to (size, size) (reference uses NEAREST so
    low-res stages stay visibly blocky)."""
    from PIL import Image
    im = Image.fromarray(img).resize((size, size), Image.NEAREST)
    return np.asarray(im)


def compose_frame(cells: List[np.ndarray], rows: int, cols: int,
                  cell_size: int, padding: int, step: int, alpha: float,
                  resolution: int) -> np.ndarray:
    """Grid of resized cells + info panel with step text and alpha bar."""
    from PIL import Image, ImageDraw

    grid_h = cell_size * rows + padding * (rows + 1)
    grid_w = cell_size * cols + padding * (cols + 1)
    panel_h = 40
    frame = np.zeros((grid_h + panel_h, grid_w, 3), np.uint8)
    for idx, cell in enumerate(cells):
        r, c = divmod(idx, cols)
        y0 = padding * (r + 1) + r * cell_size
        x0 = padding * (c + 1) + c * cell_size
        resized = nearest_resize(cell, cell_size)
        if resized.ndim == 2:
            resized = resized[:, :, None].repeat(3, axis=-1)
        frame[y0:y0 + cell_size, x0:x0 + cell_size] = resized[..., :3]

    im = Image.fromarray(frame)
    draw = ImageDraw.Draw(im)
    draw.text((6, grid_h + 4),
              f"step {step}  {resolution}x{resolution}", fill=(255, 255, 255))
    bar_w = grid_w - 140
    x0, y0 = 130, grid_h + 22
    draw.rectangle([x0, y0, x0 + bar_w, y0 + 10], outline=(255, 255, 255))
    draw.rectangle([x0, y0, x0 + int(bar_w * min(alpha, 1.0)), y0 + 10],
                   fill=(255, 255, 255))
    draw.text((6, grid_h + 18), "alpha", fill=(255, 255, 255))
    return np.asarray(im)


def build_training_gif(trial_dir: str, schedule, out_path: Optional[str] = None,
                       rows: int = 5, cols: int = 10, cell_size: int = 100,
                       padding: int = 2, frame_ms: int = 200,
                       max_frames: Optional[int] = None) -> str:
    """Assemble the evolution GIF from trial_dir/sample/*.png."""
    from PIL import Image

    sample_dir = os.path.join(trial_dir, "sample")
    paths = sorted(
        (os.path.join(sample_dir, n) for n in os.listdir(sample_dir)
         if n.endswith(".png")), key=sample_iteration)
    if max_frames:
        paths = paths[:max_frames]
    if not paths:
        raise FileNotFoundError(f"no sample PNGs in {sample_dir}")

    frames = []
    for path in paths:
        it = sample_iteration(path)
        st = schedule.state_at(max(it - 1, 0))
        data = np.asarray(Image.open(path).convert("RGB"))
        # cell size of this PNG derives from its width: cols cells + padding
        im_size = (data.shape[1] - padding * (cols + 1)) // cols
        cells = slice_grid(data, im_size, rows, cols, padding)
        frames.append(Image.fromarray(compose_frame(
            cells, rows, cols, cell_size, padding, st.step, st.alpha,
            st.resolution)))

    out_path = out_path or os.path.join(trial_dir, "training_evolution.gif")
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=frame_ms, loop=0)
    return out_path
