"""torch.cuda.max_memory_allocated() over the window, in GiB."""


def read(ctx):
    if ctx["peak_bytes"] <= 0:
        return None
    return ctx["peak_bytes"] / 2 ** 30
