"""serve_queue_wait_ms (ms): the median time a request waits from
``submit`` to the start of its batch (``serve.queue`` spans: the batching
window, then the batcher held by its bound on batches in flight, which the
device's backlog fills, and launching earlier batches), over the requests
of the timing segment (``perfbench.lib.spans``)."""

from perfbench.lib import spans


def read(ctx):
    return spans.median_ms(ctx, "serve.queue")
