"""Fairness and completion-time accounting (paper §7.2 metrics)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def jain_fairness(x) -> float:
    """Jain's index [36]: (Σx)² / (n·Σx²); 1 = perfectly fair, 1/n = one
    tenant starves the rest."""
    x = np.asarray(x, np.float64)
    x = x[np.isfinite(x)]
    if x.size == 0 or np.all(x == 0):
        return 1.0
    return float(x.sum() ** 2 / (x.size * np.square(x).sum()))


def weighted_jain(x, weights) -> float:
    """Priority-adjusted fairness: normalize service by weight first."""
    x = np.asarray(x, np.float64)
    w = np.asarray(weights, np.float64)
    return jain_fairness(x / np.maximum(w, 1e-12))


@dataclasses.dataclass
class TimeAveragedJain:
    """Time-averaged fairness over a run (paper Figs. 12-13 bottom panes)."""
    acc: float = 0.0
    t: float = 0.0

    def update(self, shares, dt: float, weights=None) -> None:
        j = (weighted_jain(shares, weights) if weights is not None
             else jain_fairness(shares))
        self.acc += j * dt
        self.t += dt

    @property
    def value(self) -> float:
        return self.acc / self.t if self.t > 0 else 1.0


@dataclasses.dataclass
class FCTTracker:
    """Flow completion times + per-kernel completion distribution."""
    start: Dict[int, float] = dataclasses.field(default_factory=dict)
    fct: Dict[int, float] = dataclasses.field(default_factory=dict)
    kernel_times: Dict[int, List[float]] = dataclasses.field(
        default_factory=dict)

    def flow_started(self, tenant: int, now: float) -> None:
        self.start.setdefault(tenant, now)

    def flow_finished(self, tenant: int, now: float) -> None:
        if tenant in self.start:
            self.fct[tenant] = now - self.start[tenant]

    def kernel_done(self, tenant: int, elapsed: float) -> None:
        self.kernel_times.setdefault(tenant, []).append(elapsed)

    def percentile(self, tenant: int, q: float) -> float:
        ts = self.kernel_times.get(tenant, [])
        return float(np.percentile(ts, q)) if ts else 0.0
