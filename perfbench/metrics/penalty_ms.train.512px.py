"""penalty_ms.train.512px (ms): ``penalty_ms.train``'s reading in the
cells that report ``train_img_per_s.512px``, over every iteration of the
window (the lazy penalty runs in a ``gp_every``-th of them)."""

from perfbench.lib import spans


def read(ctx):
    return spans.per_iteration_ms(ctx, "train.penalty")
