"""The benchmark's plain reference: the conditional Progressive GAN, its
WGAN-GP step with Adam and the EMA, and the ADA 'bgc' pipe with the shear
warp, written in plain PyTorch from the published method.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands both sides the same weights and inputs, and the
reference works everything else out again.  It runs in float32 with TF32
off (``float32_exact``); ``quant.fp8`` puts the matrix products' operands
through float8 e4m3 for the control.
"""

import contextlib

import torch


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN's convolutions and cuBLAS's matrix products."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
