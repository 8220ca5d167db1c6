"""Global QoS tier: the fleet-level control loop above per-NIC AIMD.

Reads the latest per-NIC ``BusFrame`` (one per engine, distinguished
by ``frame.nic``) off a shared MetricsBus subscription and decides two
kinds of action per tick (every ``GlobalQoSSpec.interval_epochs``
co-sim epochs):

  * a per-tenant base-weight boost vector (``gboost``) — the fleet
    engine multiplies it into every NIC's scheduler *base* rows, and
    each NIC's local AIMD controller keeps layering its own boost on
    top at its next qos tick (global sets the floor, local the fine
    trim);
  * migration plans ``(tenant, src_nic, dst_nic)`` — move the worst
    SLO violator off the most-loaded NIC onto the least-loaded one.

Only drift-free signals are read (p99, queue_mean): both sim datapaths
publish bit-identical values for those, so fleet decisions — and hence
the whole fleet RunReport — stay byte-identical across event and
batched engines (pinned in tests/test_torch_fleet.py).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.fleet.spec import GlobalQoSSpec


class GlobalQoS:
    def __init__(self, cfg: GlobalQoSSpec, *, num_tenants: int,
                 num_nics: int, p99_targets) -> None:
        self.cfg = cfg
        self.T = int(num_tenants)
        self.N = int(num_nics)
        self.targets = np.asarray(p99_targets, np.float64)
        self.gboost = np.ones(self.T, np.float64)
        self._last_migrated = np.full(self.T, -(10 ** 9), np.int64)
        self.migrations_planned = 0
        self.weight_actions = 0

    def tick(self, epoch: int, frames: Dict[int, object],
             placement: List[int]) -> Tuple[List[Tuple[int, int, int]], bool]:
        """One control decision. ``frames`` maps nic index -> latest
        BusFrame (NICs that have not published yet are simply absent).
        Returns ``(migration_plans, gboost_changed)``."""
        load = np.zeros(self.N, np.float64)
        p99 = np.zeros(self.T, np.float64)
        have = np.zeros(self.T, bool)
        for k in range(self.N):
            f = frames.get(k)
            if f is None:
                continue
            qm = np.asarray(f.signals.queue_mean, np.float64)
            fp99 = np.asarray(f.signals.p99, np.float64)
            for i in range(self.T):
                if placement[i] == k:
                    load[k] += float(qm[i])
                    p99[i] = float(fp99[i])
                    have[i] = True

        changed = False
        viol = have & (self.targets > 0) & (p99 > self.targets)
        if self.cfg.rebalance:
            new = self.gboost.copy()
            new[viol] = np.minimum(new[viol] * self.cfg.rebalance_gain,
                                   self.cfg.boost_cap)
            relax = have & (self.targets > 0) & ~viol
            new[relax] = np.maximum(new[relax] / self.cfg.rebalance_gain, 1.0)
            if not np.array_equal(new, self.gboost):
                self.gboost = new
                self.weight_actions += 1
                changed = True

        plans: List[Tuple[int, int, int]] = []
        if self.cfg.migrate and self.migrations_planned < self.cfg.max_migrations:
            src = int(np.argmax(load))
            dst = int(np.argmin(load))
            if dst != src and load[src] > self.cfg.load_margin * load[dst] + 1e-12:
                best, best_ratio = -1, 0.0
                for i in range(self.T):
                    if (placement[i] == src and viol[i]
                            and epoch - self._last_migrated[i]
                            >= self.cfg.cooldown_epochs):
                        ratio = p99[i] / self.targets[i]
                        if ratio > best_ratio:
                            best, best_ratio = i, ratio
                if best >= 0:
                    plans.append((best, src, dst))
                    self._last_migrated[best] = epoch
                    self.migrations_planned += 1
        return plans, changed

    def summary(self) -> Dict:
        return {
            "gboost": self.gboost.tolist(),
            "weight_actions": int(self.weight_actions),
            "migrations_planned": int(self.migrations_planned),
        }
