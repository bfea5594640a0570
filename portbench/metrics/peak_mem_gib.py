"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated()`` over the whole
process, set-up included, read when the window has closed, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] else None
