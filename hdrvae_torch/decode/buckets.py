"""The shape-bucket policy of arbitrary-resolution serving, as
``hdrvae/decode/buckets.py``.

``hdr_decode(pad_to=policy.snap_hw(h, w))`` zero-pads a latent up to its
bucket and crops the output; the pad region is kept out of every GroupNorm
statistic, the mid attention's softmax and every conv halo
(``models.layers.PadMask``), so the bucketed decode equals the unpadded one
to float noise.  This module picks the buckets: a small set of edges fitted
to an observed or expected size distribution (a dynamic programme over the
pooled edge marginal that minimizes the padded pixels), and the snap of
every request to its bucket.  numpy and bisect only.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, Tuple

import numpy as np

__all__ = ["BucketPolicy", "plan_buckets"]


@dataclasses.dataclass(frozen=True)
class BucketPolicy:
    """Ascending latent-edge bucket sizes.  ``snap`` rounds a size up to
    its bucket; sizes beyond the largest bucket round up to a multiple of
    ``overflow_multiple``."""

    edges: Tuple[int, ...]
    overflow_multiple: int = 64

    def __post_init__(self):
        if not self.edges or list(self.edges) != sorted(set(self.edges)):
            raise ValueError(f"edges must be ascending+unique: "
                             f"{self.edges}")

    def snap(self, n: int) -> int:
        i = bisect.bisect_left(self.edges, n)
        if i < len(self.edges):
            return self.edges[i]
        m = self.overflow_multiple
        return -(-n // m) * m

    def snap_hw(self, h: int, w: int) -> Tuple[int, int]:
        return self.snap(h), self.snap(w)

    @property
    def max_compiled_shapes(self) -> int:
        """Distinct (h, w) bucket shapes the edges give."""
        return len(self.edges) ** 2


def plan_buckets(sizes: Iterable[Tuple[int, int]], max_buckets: int = 4,
                 multiple: int = 8) -> BucketPolicy:
    """Fit a :class:`BucketPolicy` to a workload.

    ``sizes``: observed or expected latent (h, w) pairs.  Both edges pool
    into one 1-D marginal (buckets apply per axis); a partition over the
    distinct candidate edges (rounded up to ``multiple``) picks at most
    ``max_buckets`` bucket tops minimizing the padded-pixel sum ``count *
    (bucket - size)``.  Sizes beyond the largest bucket snap to multiples
    of ``multiple * 8``.
    """
    flat = [s for hw in sizes for s in hw]
    if not flat:
        raise ValueError("no sizes given")
    counts: Dict[int, int] = {}
    for s in flat:
        r = -(-s // multiple) * multiple
        counts[r] = counts.get(r, 0) + 1
    vals = sorted(counts)
    k = min(max_buckets, len(vals))
    n = len(vals)
    cnt = np.asarray([counts[v] for v in vals], np.int64)
    varr = np.asarray(vals, np.int64)

    # cost[i, j]: every size in vals[i..j] served by the bucket vals[j]
    cost = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(i, n):
            cost[i, j] = int((cnt[i:j + 1] * (varr[j]
                                              - varr[i:j + 1])).sum())

    inf = np.iinfo(np.int64).max
    dp = np.full((k + 1, n), inf, np.int64)
    choice = np.zeros((k + 1, n), np.int32)
    for j in range(n):
        dp[1, j] = cost[0, j]
    for kk in range(2, k + 1):
        for j in range(kk - 1, n):
            for i in range(kk - 2, j):
                c = dp[kk - 1, i] + cost[i + 1, j]
                if c < dp[kk, j]:
                    dp[kk, j] = c
                    choice[kk, j] = i
    # the best bucket count <= k whose last bucket is the largest size
    best_k = min(range(1, k + 1), key=lambda kk: dp[kk, n - 1])
    edges = []
    j = n - 1
    for kk in range(best_k, 0, -1):
        edges.append(int(varr[j]))
        j = int(choice[kk, j])
    return BucketPolicy(edges=tuple(sorted(edges)),
                        overflow_multiple=multiple * 8)
