"""Output megapixels of every x4 request finished in the window, over the
whole window (host clock, the window ends when the last request is
done)."""


def read(ctx):
    if ctx["kind"] != "upscale" or ctx["window_s"] <= 0:
        return None
    return ctx["megapixels"] / ctx["window_s"]
