"""pgx_torch — the PyTorch/CUDA port of pgx for NVIDIA Hopper.

The package mirrors ``pgx``'s module tree.  It imports torch and numpy and
nothing of JAX or of ``pgx``.  Public tensors are NHWC, as in ``pgx``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
hot work goes through hand-written CUDA kernels (``pgx_torch.ops.kernels``)
whose plain PyTorch versions serve CPU tensors and the tests.

Ported so far: the serving path (``GeneratorService`` in
``pgx_torch.serve`` over the EMA generator's forward), the WGAN-GP training
iteration (``pgx_torch.train.make_train_step``) and the loop around it
(``pgx_torch.train.train_loop``: growth stages, sample grids, checkpoints,
resume), the checkpoint protocol (``pgx_torch.checkpoint``), the data path
(``pgx_torch.data``: datasets, batch streams, the device prefetcher), the
ADA augmentation pipeline and its controller (``pgx_torch.augment``), the
ops layer (``pgx_torch.ops``), evaluation (``pgx_torch.eval``: InceptionV3
FID and KID, the checkpoint sweep, the in-training FID), the reference
``.model`` import and export (``pgx_torch.checkpoint.torch_import``,
``torch_export``), the exported generator (``pgx_torch.export``: a
``torch.export`` program per batch bucket, the kernels as
``torch.ops.pgx_torch`` nodes), the step-indexed store of the full state
(``pgx_torch.checkpoint.step_store``), the host utilities
(``pgx_torch.utils``), data parallelism (``pgx_torch.parallel``: one
process per rank, the collectives GSPMD places in ``pgx``), model
parallelism (``pgx_torch.parallel.tp``: a (data, model) grid of ranks, the
train state sharded over its model axis or the images split over H across
it), the C++ host runtime of the data path (``pgx_torch.native``, built at
first use) and every CLI of ``pgx/cli`` under ``pgx_torch.cli``.
"""
