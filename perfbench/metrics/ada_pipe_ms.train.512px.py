"""ada_pipe_ms.train.512px (ms): the device ms an iteration of the ADA
pipe's forward applications (``train.ada_pipe`` spans: the reals, the D
step's fakes and, unfused, the G step's), in the cells that report
``train_img_per_s.512px``.  The backward through the fakes' pipe lies in
``train.d_step`` and ``train.g_step``."""

from perfbench.lib import spans


def read(ctx):
    return spans.per_iteration_ms(ctx, "train.ada_pipe")
