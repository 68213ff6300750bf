"""The one traffic generator: a mix file (traffic/<name>.json) and a seed in,
the run's requests out, as many as the run reads.

A mix names its loop ("closed": `clients` clients, each sending its next
request when its last finishes; "open": arrivals at the cell's `rate`
requests per second), the engine's `slots`, the decode block size
`block_steps`, and the distributions of prompt and output lengths
({"dist": "uniform", "min", "max"} or {"dist": "lognormal", "median",
"sigma", "min", "max"}: clipped). Arrivals are "poisson".

Every seed gets the same sizes in another order: requests come in strata
of `strata` requests, and within a stratum the prompt lengths, the output
lengths and the gaps between arrivals are the distribution's quantiles at
(j + 0.5) / strata (the gaps scaled so that their mean is 1 / rate), each
list shuffled by the seed. So a window holds nearly the same work
whatever the seed, and the seed changes the order and the token ids. Each
stratum is drawn from a generator of its own, so the first n requests are
the same however many the run goes on to read. A closed loop's first
`clients` requests (the ones that fill the engine before the window
opens) keep (j + 0.5) / clients of their output lengths, in shuffled
order, and at least STAGGER_MIN, so that finishes are spread over the
window from its start.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import statistics
from typing import Iterator, Optional

import numpy as np

from . import weights

# the fewest output tokens a staggered first request keeps
STAGGER_MIN = 16


@dataclasses.dataclass
class Req:
    uid: int
    prompt: np.ndarray          # int32 token ids
    max_new: int
    due: Optional[float] = None   # seconds after the window opens (open)


def quantile(dist: dict, q: np.ndarray) -> np.ndarray:
    """The distribution's quantiles at q, clipped, as whole numbers."""
    if dist["dist"] == "uniform":
        lo, hi = dist["min"], dist["max"]
        return np.minimum(lo + np.floor(q * (hi - lo + 1)), hi).astype(int)
    if dist["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(p)) for p in q])
        v = np.round(dist["median"] * np.exp(dist["sigma"] * z))
        return np.clip(v, dist["min"], dist["max"]).astype(int)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def stream(mix: dict, seed: int, vocab: int,
           rate: Optional[float] = None) -> Iterator[Req]:
    """The run's requests, in the order they are sent, without end."""
    k = mix["strata"]
    q = (np.arange(k) + 0.5) / k
    plens = quantile(mix["prompt"], q)
    olens = quantile(mix["output"], q)
    if mix["loop"] == "open":
        if not rate or rate <= 0:
            raise ValueError("an open loop needs the cell's rate")
        if mix.get("arrival", "poisson") != "poisson":
            raise ValueError(f"unknown arrival process {mix['arrival']!r}")
        gaps = -np.log1p(-q)
        gaps = gaps / gaps.mean() / rate
        frac = []
    else:
        c = mix["clients"]
        frac = np.random.default_rng(weights.sub_seed(
            seed, weights.TRAFFIC, weights.STAGGER)).permutation(
                (np.arange(c) + 0.5) / c)
    due, uid = 0.0, 0
    for j in itertools.count():
        rng = np.random.default_rng(weights.sub_seed(seed, weights.TRAFFIC,
                                                     weights.STRATUM, j))
        plen, olen = rng.permutation(plens), rng.permutation(olens)
        gap = rng.permutation(gaps) if mix["loop"] == "open" else None
        for i in range(k):
            new = int(olen[i])
            if uid < len(frac):
                new = max(STAGGER_MIN, math.ceil(frac[uid] * new))
            if gap is not None:
                due += float(gap[i])
            prompt = rng.integers(0, vocab, size=int(plen[i]), dtype=np.int32)
            yield Req(uid=uid, prompt=prompt, max_new=new,
                      due=due if gap is not None else None)
            uid += 1


def requests(mix: dict, seed: int, vocab: int, n: int,
             rate: Optional[float] = None) -> list[Req]:
    """The run's first n requests."""
    return list(itertools.islice(stream(mix, seed, vocab, rate), n))
