"""The one traffic generator: reads a mix's parameters and yields
requests.

A mix (``traffic/<name>.json``) lists tenants.  Each has a ``priority``
(WLBVT weight), optional ``dma_priority`` (DWRR weight), a KV quota in
slots, whether it is a ``victim`` (its time to first token is judged),
an ``arrival`` process (``{"kind": "closed", "outstanding": n}``: n
requests in flight, the next sent when one ends; or ``{"kind":
"poisson", "rate_per_s": r}``: open loop, due on a schedule whatever the
system does), and the ``prompt`` and ``output`` length distributions
(``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``
or ``{"dist": "uniform", "min": a, "max": b}``).  ``warmup_s`` is how
long the traffic runs before the measured window opens.

Every seed gets the same work: each tenant's lengths are drawn in
blocks of ``pool`` (default 64), each block the distribution's ``pool``
mid-quantiles in a shuffled order, and its open-loop gaps likewise from
the exponential's quantiles.  The shuffles are one fixed order for every
seed, so that a short window's transient does not depend on which
lengths come first; the prompts' token ids come from the seed.  An open-loop
``arrival`` may give ``start_s``: its schedule starts that many seconds
after the traffic (default 0).
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import List, Optional

import numpy as np

POOL = 64          # default block of quantiles per tenant and distribution
FIXED_ORDER = 20261018   # the lengths' and gaps' shuffles, every seed


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n mid-quantiles (i + 0.5) / n of a length distribution, as
    whole numbers within its clip."""
    u = (np.arange(n) + 0.5) / n
    lo, hi = dist["min"], dist["max"]
    if dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif dist["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


class _Shuffled:
    """Draws from a fixed pool, each pass in a new order from ``rng``."""

    def __init__(self, pool: np.ndarray, rng: np.random.Generator):
        self.pool, self.rng, self.order, self.i = pool, rng, None, 0

    def next(self):
        if self.order is None or self.i == len(self.order):
            self.order, self.i = self.rng.permutation(self.pool), 0
        self.i += 1
        return self.order[self.i - 1]


@dataclasses.dataclass
class Item:
    tenant: int
    due: float             # seconds after the traffic starts
    prompt: np.ndarray     # (P,) int32 token ids
    max_new_tokens: int


class Traffic:
    """Requests of one mix for one seed.  ``arrivals(until)`` gives the
    open-loop requests due by ``until`` (seconds from the start), in due
    order; ``closed(tenant, at)`` the next request of a closed-loop
    tenant, due at ``at``."""

    def __init__(self, mix: dict, seed: int, vocab: int, max_len: int):
        self.tenants = mix["tenants"]
        root = np.random.SeedSequence(seed % (1 << 63))
        streams = root.spawn(len(self.tenants))
        self.vocab = vocab
        self._rng = []
        self._prompt, self._output, self._gaps = [], [], []
        for i, (t, ss) in enumerate(zip(self.tenants, streams)):
            self._rng.append(np.random.default_rng(ss))
            rng = np.random.default_rng(FIXED_ORDER + i)
            n = int(t.get("pool", POOL))
            p, o = quantiles(t["prompt"], n), quantiles(t["output"], n)
            if int(p.max() + o.max()) > max_len:
                raise ValueError(f"tenant {t['name']}: prompt + output up to "
                                 f"{int(p.max() + o.max())} > max_len "
                                 f"{max_len}")
            self._prompt.append(_Shuffled(p, rng))
            self._output.append(_Shuffled(o, rng))
            a = t["arrival"]
            if a["kind"] == "poisson":
                u = (np.arange(n) + 0.5) / n
                gaps = -np.log1p(-u) / a["rate_per_s"]
                self._gaps.append(_Shuffled(gaps, rng))
            elif a["kind"] == "closed":
                self._gaps.append(None)
            else:
                raise ValueError(f"unknown arrival kind {a['kind']!r}")
        self._next_due = [t["arrival"].get("start_s", 0.0) + g.next()
                          if g is not None else math.inf
                          for t, g in zip(self.tenants, self._gaps)]

    def victim(self, tenant: int) -> bool:
        return bool(self.tenants[tenant].get("victim", False))

    def _item(self, tenant: int, due: float) -> Item:
        n = int(self._prompt[tenant].next())
        prompt = self._rng[tenant].integers(1, self.vocab, size=n,
                                            dtype=np.int64).astype(np.int32)
        return Item(tenant, due, prompt, int(self._output[tenant].next()))

    def initial(self) -> List[Item]:
        """The closed-loop tenants' first requests, due at 0."""
        return [self._item(i, 0.0)
                for i, t in enumerate(self.tenants)
                if t["arrival"]["kind"] == "closed"
                for _ in range(t["arrival"]["outstanding"])]

    def arrivals(self, until: float) -> List[Item]:
        out = []
        for i, g in enumerate(self._gaps):
            while g is not None and self._next_due[i] <= until:
                out.append(self._item(i, self._next_due[i]))
                self._next_due[i] += g.next()
        out.sort(key=lambda it: it.due)
        return out

    def closed(self, tenant: int, at: float) -> Optional[Item]:
        if self.tenants[tenant]["arrival"]["kind"] != "closed":
            return None
        return self._item(tenant, at)
