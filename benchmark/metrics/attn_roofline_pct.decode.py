"""The least time the card could take for the model's attn work of the
items finished in the traced span (its operations over 989 TFLOP/s or
its bytes over 3.35 TB/s, the larger) over the device time of the
kernels that ``benchmark/kernels/*.json`` put in the ``attn`` class, in
percent, in the decode cells."""

from benchmark.harness.work import bound_s, scaled


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "decode" or tr is None or not tr["items"]:
        return None
    entry = ctx["work"].get("attn")
    class_s = tr["class_s"].get("attn", 0.0)
    if entry is None or class_s <= 0:
        return None
    least, _ = bound_s(scaled({"attn": entry}, tr["items"])["attn"])
    return 100.0 * least / class_s
