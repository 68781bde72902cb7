"""Process start to the window's start: imports, the card, the weights
made and loaded, the kernels built or loaded, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
