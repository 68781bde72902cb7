"""The share of the traced span in which no operation ran on the device,
in percent, in the decode cells."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "decode" or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
