"""The open-loop arrival schedule, made from the seed.

Every seed gets the same set of arrival gaps and the same number of
requests of each shape, in another order: the gaps are the quantiles of
the exponential distribution at the mix's rate (Poisson arrivals), the
shape counts are the mix's weights rounded by largest remainder, and the
seed shuffles both.  So seeds differ in order only, never in the
amount of work.

At four fifths of the knee the 95th percentile swung by a third between
orders, while two runs of one order agreed within a few percent.  So a
traffic file may fix the order with a ``schedule_seed`` of its own:
every run then meets the same arrivals, bursts included, and the run's
seed draws the latents, the weights and the sample checked.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.harness.models import SCHEDULE, stream_seed


@dataclasses.dataclass(frozen=True)
class Request:
    due_s: float              # from the window's start
    shape: Tuple[int, int]    # latent (h, w)
    slot: int                 # which latent of the shape's pool


def shape_counts(mix: Sequence[Dict], n: int) -> List[int]:
    """Requests of each mix entry out of n, by the largest remainder."""
    w = np.asarray([float(e["weight"]) for e in mix])
    exact = w / w.sum() * n
    counts = np.floor(exact).astype(int)
    order = np.argsort(-(exact - counts), kind="stable")
    for i in order[:n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def schedule(rate_per_s: float, seconds: float, mix: Sequence[Dict],
             pool_per_shape: int, seed: int) -> List[Request]:
    """The requests due in a window of ``seconds`` at ``rate_per_s``, in
    order of their due time.  The gaps are scaled so that the last
    request is due at the window's end: n / rate seconds of arrivals
    over the window."""
    n = max(1, int(round(rate_per_s * seconds)))
    rng = np.random.default_rng(stream_seed(seed, SCHEDULE))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate_per_s
    gaps *= seconds / gaps.sum()
    shapes = [tuple(int(v) for v in e["latent_hw"])
              for e, c in zip(mix, shape_counts(mix, n)) for _ in range(c)]
    gaps = gaps[rng.permutation(n)]
    shapes = [shapes[i] for i in rng.permutation(n)]
    slots = rng.integers(0, pool_per_shape, n)
    due = np.cumsum(gaps)
    return [Request(float(d), s, int(k))
            for d, s, k in zip(due, shapes, slots)]
