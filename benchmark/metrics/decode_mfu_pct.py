"""The model's operations for the items finished in the traced span
over the span's time, as a share of the bf16 dense peak (989 TFLOP/s),
in percent, in the decode cells.  The work is counted from the
configuration's shapes (``benchmark/harness/work.py``)."""

from benchmark.harness.work import PEAK_FLOPS, total_flops


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "decode" or tr is None or not tr["items"]:
        return None
    flops = tr["items"] * total_flops(ctx["work"])
    return 100.0 * flops / tr["window_s"] / PEAK_FLOPS
