"""The one generator of requests. A traffic mix is a data file
(``traffic/<name>.json``) of parameters; this module turns it and the run's
seed into requests, so every seed gives the same sizes and the same number
of steps, drawn anew. How the requests are sent is the mix's kind's
(``kinds/<kind>.py``).

Every random stream of a run hangs off ``sub_seed(seed, tag)``: the weights,
each request's x_T or noise generators, the handles, the inversion's noise
and the rows the check compares.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List

import numpy as np


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed for the stream ``tag`` of the run ``seed``."""
    text = ":".join(str(t) for t in (seed,) + tag).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


@dataclasses.dataclass
class Request:
    index: int
    seed: int  # the request's own draws (x_T, or step noise)
    sources: np.ndarray = None  # with handles_per_shape: [shapes, handles, 3]
    targets: np.ndarray = None


class Traffic:
    """Requests ``request(i)`` from the mix ``params``
    (``traffic/<name>.json``) and the run's seed."""

    def __init__(self, params: dict, seed: int):
        self.p, self.seed = params, seed

    def request(self, i: int) -> Request:
        req = Request(i, sub_seed(self.seed, "request", i))
        if "handles_per_shape" in self.p:
            req.sources, req.targets = self.handles(np.random.default_rng(sub_seed(self.seed, "handles", i)))
        return req

    def handles(self, rng: np.random.Generator):
        """Per shape ``handles_per_shape`` pairs: a source uniform in the
        box [-source_box, source_box]^3, a target in a uniform direction at
        a distance uniform in [shift_min, shift_max]."""
        p = self.p
        shape = (p["shapes"], p["handles_per_shape"], 3)
        src = rng.uniform(-p["source_box"], p["source_box"], shape)
        d = rng.normal(size=shape)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dist = rng.uniform(p["shift_min"], p["shift_max"], shape[:2] + (1,))
        return src.astype(np.float32), (src + d * dist).astype(np.float32)

    def check_picks(self, completed: int, per_request: int, count: int) -> List[tuple]:
        """``count`` (request, row) pairs the check compares, drawn from the
        seed among the completed requests. The rows of a request are cut
        into ``count`` equal stretches and each pick takes a row of its
        own stretch (two picks: one from each half of the batch); the last
        request is always among them."""
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        count = min(count, completed * per_request)
        stretches = np.array_split(np.arange(per_request), min(count, per_request))
        order = rng.permutation(len(stretches))
        picks = []
        for k in range(count):
            rows = stretches[order[k % len(stretches)]]
            while True:
                r = completed - 1 if k == 0 else int(rng.integers(completed))
                pick = (r, int(rows[rng.integers(len(rows))]))
                if pick not in picks:
                    picks.append(pick)
                    break
        return sorted(picks)
