"""The training loop's card cases: the device prefetcher and a short loop
through the kernels.  They skip without a CUDA device; on the card they run
without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_loop_gpu.py
"""

import glob
import os

import numpy as np
import pytest
import torch

from pgx_torch.data import DevicePrefetcher, synthetic_dataset
from pgx_torch.data.pipeline import array_batches
from pgx_torch.models import zoo
from pgx_torch.ops.kernels import build
from pgx_torch.train import ProperSchedule, TrainConfig
from pgx_torch.train.loop import LoopConfig, train_loop


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_prefetcher_yields_the_stream_under_a_running_step(cuda):
    """50 batches, each read by work queued behind a long matmul chain on
    the current stream, then copied: the copies equal the numpy stream, so
    no pinned buffer was refilled and no device block reused while the
    step still read it."""
    ds = synthetic_dataset(96, 32, 3, 10, seed=2)
    want = array_batches(ds, 32, 32, seed=5)
    pf = DevicePrefetcher(array_batches(ds, 32, 32, seed=5), cuda, depth=2)
    heavy = torch.randn(2048, 2048, device=cuda)
    copies = []
    try:
        for _ in range(50):
            imgs, labels = next(pf)
            assert imgs.device.type == "cuda" and labels.device.type == "cuda"
            acc = heavy
            for _ in range(4):
                acc = acc @ heavy           # keeps the stream busy
            copies.append((imgs * 1.0 + 0.0 * acc[0, 0], labels.clone()))
            del imgs, labels, acc
        torch.cuda.synchronize()
    finally:
        pf.close()
    assert not pf._thread.is_alive()
    for k, (imgs, labels) in enumerate(copies):
        wi, wl = next(want)
        np.testing.assert_array_equal(imgs.cpu().numpy(), wi,
                                      err_msg=f"batch {k}")
        np.testing.assert_array_equal(labels.cpu().numpy(), wl)
    assert pf.wait_s >= 0.0


@pytest.mark.gpu
def test_gpu_short_loop_goes_through_the_kernels(cuda, tmp_path):
    gcfg = zoo.conditional_correct_generator(z_dim=8, channel=8,
                                             num_classes=3, max_step=3)
    dcfg = zoo.conditional_correct_discriminator_wgangp(
        feat_dim=8, num_classes=3, max_step=3)
    build.reset_launch_counts()
    trial = train_loop(gcfg, dcfg, TrainConfig(),
                       ProperSchedule(8, 4, 3, 2),
                       synthetic_dataset(16, 32, 3, 3),
                       LoopConfig(main_path=str(tmp_path), batch_size=4,
                                  total_iterations=4, sample_every=2,
                                  checkpoint_every=2, log_every=2,
                                  verbose=False, snapshot_sources=False),
                       device=cuda)
    counts = build.launch_counts()
    for name in ("bias_pixelnorm_lrelu", "pixel_norm_lrelu",
                 "conv3x3_epilogue", "conv3x3_epilogue_r",
                 "bias_pixelnorm_lrelu_bwd", "bias_pixelnorm_lrelu_bwd2"):
        assert counts[name] > 0, (name, counts)
    rows = open(glob.glob(os.path.join(trial, "train_log_*"))[0]).read()
    values = [float(v) for r in rows.splitlines()[1:] for v in r.split(",")]
    assert len(values) == 10 and np.isfinite(values).all()
    state = torch.load(os.path.join(trial, "checkpoint", "004_state.pt"),
                       weights_only=True)
    assert state["iteration"] == 4
