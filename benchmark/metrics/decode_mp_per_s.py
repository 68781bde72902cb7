"""Output megapixels of every frame finished in the window, over the
whole window (host clock, the window ends when the last frame is done)."""


def read(ctx):
    if ctx["kind"] != "decode" or ctx["window_s"] <= 0:
        return None
    return ctx["megapixels"] / ctx["window_s"]
