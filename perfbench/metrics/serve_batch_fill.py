"""serve_batch_fill (%): the batcher's images per device batch over its
``max_batch``, from ``GeneratorService.stats()``'s ``batched_images`` and
``batches`` counted over the window."""


def read(ctx):
    fill = ctx.get("batch_fill")
    return None if fill is None else 100.0 * fill
