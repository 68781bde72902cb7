"""The 95th percentile (nearest rank), over every request due in the
window, of the time from when it was due to when its response was ready;
a request that failed or never came counts as infinitely late."""

import math


def read(ctx):
    lat = ctx["latencies_ms"]
    if ctx["kind"] != "serve" or not lat:
        return None
    s = sorted(lat)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
