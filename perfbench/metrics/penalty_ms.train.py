"""penalty_ms.train (ms): the device ms an iteration of the gradient
penalty's forward part (``train.penalty`` spans: D on x_hat, the input
gradient and its norms; the jvp form whole), over every iteration, in the
cells that report ``train_img_per_s``.  The reverse form's second-order
backward lies in ``train.d_step``.  Under ``d_concat`` D's forward on
x_hat runs in the joint pass outside the span, which then holds the input
gradient and its norms alone (the committed cells run without it)."""

from perfbench.lib import spans


def read(ctx):
    return spans.per_iteration_ms(ctx, "train.penalty")
