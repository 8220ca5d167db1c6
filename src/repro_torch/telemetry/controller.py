"""Closed-loop QoS controller (DESIGN.md §6).

Consumes ``SignalFrame``s at a fixed control interval and steers two
actuators both execution surfaces expose:

  * **scheduler weights** (WLBVT ``prio`` + DWRR weights) — AIMD: a
    tenant whose interval p99 sojourn latency violates its SLO target
    gains weight additively; a tenant meeting its target decays
    multiplicatively back toward its base (admission-time) weight, so
    transient boosts are returned once congestion passes and tenants
    without targets keep their static share;
  * **admission backpressure** — hysteresis on congestion pressure
    (max of ECN-mark rate, drop rate, KV/queue pressure): a tenant is
    paused above ``pause_hi`` and resumed only below ``resume_lo``, so
    the gate does not chatter around a single threshold.

The controller is surface-agnostic: the simulator applies actions at
window boundaries in virtual time, the serving engine every
``qos_interval`` steps.  It never touches engine state itself — it
returns a ``ControlAction`` the caller applies.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.telemetry.signals import SignalFrame


@dataclasses.dataclass(frozen=True)
class QoSConfig:
    ai: float = 0.5          # additive weight increase per violating interval
    md: float = 0.7          # multiplicative decay toward base when meeting
    w_min_scale: float = 0.25    # weight floor/ceiling, relative to base
    w_max_scale: float = 16.0
    pause_hi: float = 0.85   # pressure above which admission is paused
    resume_lo: float = 0.5   # pressure below which it resumes
    headroom: float = 0.8    # target fraction: act before the SLO is blown


@dataclasses.dataclass
class ControlAction:
    weights: np.ndarray      # (T,) controller weights (base * boost)
    boost: np.ndarray        # (T,) multiplicative factor vs controller base
    admit: np.ndarray        # (T,) bool: False = backpressure this tenant
    violating: np.ndarray    # (T,) bool: interval p99 above target


class QoSController:
    """Per-tenant AIMD weight adaptation + hysteretic admission gate."""

    def __init__(self, base_weights, p99_targets=None,
                 cfg: QoSConfig = QoSConfig()):
        self.cfg = cfg
        self.base = np.asarray(base_weights, float).copy()
        T = self.base.shape[0]
        t = (np.zeros(T) if p99_targets is None
             else np.asarray(p99_targets, float))
        self.targets = t            # 0 = no latency SLO for that tenant
        self.weights = self.base.copy()
        self.paused = np.zeros(T, bool)
        self.history: List[ControlAction] = []

    def reset_tenant(self, tenant: int, base_weight: float = None) -> None:
        """Forget a tenant's AIMD boost and pause state (ECTX teardown —
        a reused tenant id must not inherit control history)."""
        if base_weight is not None:
            self.base[tenant] = base_weight
        self.weights[tenant] = self.base[tenant]
        self.paused[tenant] = False

    def update(self, sig: SignalFrame) -> ControlAction:
        cfg = self.cfg
        has_slo = self.targets > 0
        viol = has_slo & (sig.p99 > cfg.headroom * self.targets)
        # AIMD on scheduler weights
        boosted = self.weights + cfg.ai * self.base
        decayed = cfg.md * self.weights + (1.0 - cfg.md) * self.base
        w = np.where(viol, boosted, decayed)
        self.weights = np.clip(w, cfg.w_min_scale * self.base,
                               cfg.w_max_scale * self.base)
        # hysteresis on admission: pressure is the worst congestion signal
        pressure = np.maximum.reduce([sig.ecn_rate, sig.drop_rate,
                                      sig.kv_pressure])
        self.paused = np.where(self.paused,
                               pressure > cfg.resume_lo,   # stay paused?
                               pressure > cfg.pause_hi)    # newly pause?
        action = ControlAction(weights=self.weights.copy(),
                               boost=self.weights
                               / np.maximum(self.base, 1e-12),
                               admit=~self.paused, violating=viol)
        self.history.append(action)
        return action


def apply_to_scheduler(action: ControlAction, *targets,
                       installed: Optional[np.ndarray] = None) -> None:
    """Actuate the action onto live scheduler arrays in place.

    Each target is a ``(live_array, base_array)`` pair — WLBVT ``prio``
    and any DWRR weight arrays, each with its *own* SLO-configured base
    (priority vs dma_priority vs egress_priority differ per knob).  The
    controller contributes only the multiplicative ``boost``:
    ``live = base * boost``, so configured QoS provisioning is scaled,
    never clobbered.  ``installed`` restricts writes so un-admitted FMQ
    rows keep their defaults.
    """
    b = action.boost
    sel = (np.ones(len(b), bool) if installed is None
           else np.asarray(installed, bool))
    for live, base in targets:
        n = min(len(b), len(live))
        s = sel[:n]
        live[:n][s] = np.asarray(base)[:n][s] * b[:n][s]
