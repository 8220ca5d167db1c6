"""Per-tenant SLO error-budget accounting + burn-rate alerts (§11.3).

SRE-style multi-window burn-rate alerting over the per-interval
``SignalFrame`` stream: each observation interval is classified good or
bad per tenant, and an ``SLOAlert`` fires when the bad fraction over a
short ("fast") or long ("slow") trailing window burns the error budget
(``1 - objective``) faster than its threshold.  Two windows give the
standard trade-off — the fast window catches an acute violation within
a couple of intervals (before the AIMD controller's first actuation,
whose interval is several observation windows long), the slow window
catches sustained low-grade burn without paging on blips.

An interval is **bad** for a tenant when either
  * latency: the interval recorded sojourn samples and its p99 exceeds
    the tenant's target (``TenantSpec.p99_target`` scaled to the
    backend's time unit — the same targets the QoS controller acts
    on); or
  * goodput: the tenant had arrivals but zero completions (starved
    under demand — the goodput face of its ``SLOPolicy`` share).

An idle interval (no samples, no arrivals) is **good**: the pinned
``SignalFrame`` zero-completion semantics read p99 == 0.0 with
``lat_samples == 0`` there, so burn windows never double-count idleness
as violation (see ``tests/test_observability.py``).

The audit is pure host-side arithmetic over bit-identical committed
telemetry, so the event-loop and batched sim datapaths raise identical
alerts at identical virtual times.  ``EngineBase.observe_tick`` drives
it and pushes each alert as an ``EventKind.SLO_ALERT`` EQ event;
``note_intervention`` is called from the
controller tick so the summary can attribute alert -> AIMD/admission
intervention lead times.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.signals import SignalFrame

MAX_ALERTS = 256               # bounded alert log in the summary
MAX_INTERVENTIONS = 256
MAX_VIOLATION_WINDOWS = 64     # merged bad-interval spans kept per tenant

FAST = "fast"
SLOW = "slow"

# intervention kinds (note_intervention / summary attribution)
IV_AIMD_WEIGHT = "aimd_weight"
IV_ADMISSION = "admission"


@dataclasses.dataclass(frozen=True)
class SLOAuditConfig:
    """Burn-rate policy knobs.

    ``objective`` is the availability objective over observation
    intervals (0.9 = at most 10% of intervals may be bad); the error
    budget is ``1 - objective``.  A window alerts when
    ``bad_fraction / budget >= *_burn`` once it has seen ``*_windows``
    intervals.  Defaults: with budget 0.1, the fast window needs both
    of its 2 intervals bad (burn 10 >= 5), the slow window needs 2 of
    8 (burn 2.5 >= 2).
    """
    objective: float = 0.9
    fast_windows: int = 2
    slow_windows: int = 8
    fast_burn: float = 5.0
    slow_burn: float = 2.0

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0, 1), got "
                             f"{self.objective}")
        if self.fast_windows <= 0 or self.slow_windows < self.fast_windows:
            raise ValueError("need 0 < fast_windows <= slow_windows, got "
                             f"{self.fast_windows}/{self.slow_windows}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


@dataclasses.dataclass(frozen=True)
class SLOAlert:
    """One burn-rate alert (rising edge of a window crossing)."""
    t: float                   # interval end, backend time unit
    tenant: int
    window: str                # FAST | SLOW
    burn_rate: float
    p99: float                 # interval p99 that tripped it
    target: float


class SLOAudit:
    """Streaming per-tenant error-budget accountant."""

    def __init__(self, p99_targets, *, config: Optional[SLOAuditConfig] = None,
                 time_unit: str = "ns"):
        self.cfg = config or SLOAuditConfig()
        self.targets = np.asarray(p99_targets, float)
        self.time_unit = time_unit
        T = len(self.targets)
        self.T = T
        self.intervals = 0
        # trailing bad-interval window, per tenant (slow window length
        # bounds it; the fast window reads its tail)
        self._bad: List[Deque[bool]] = [
            deque(maxlen=self.cfg.slow_windows) for _ in range(T)]
        self._alert_on = {FAST: np.zeros(T, bool),
                          SLOW: np.zeros(T, bool)}
        self._observed = np.zeros(T, np.int64)    # intervals with activity
        self._violating = np.zeros(T, np.int64)
        self.alerts: List[SLOAlert] = []
        self.alerts_total = 0
        self._first_alert_t: Dict[int, float] = {}
        self._first_intervention_t: Dict[int, float] = {}
        self.interventions: List[dict] = []
        self.interventions_total = 0
        self._last_boost: Optional[np.ndarray] = None
        self._last_admit: Optional[np.ndarray] = None
        # merged [first_bad_t, last_bad_t] spans, per tenant
        self._vwindows: Dict[int, List[List[float]]] = {}
        self._open_window: Dict[int, bool] = {}

    # -- per-interval classification ---------------------------------------
    def observe(self, *, t: float, sig: SignalFrame,
                interval_counts: np.ndarray) -> Tuple[SLOAlert, ...]:
        """Classify one observation interval; returns newly-raised
        alerts (rising edges only) in tenant order."""
        from repro_torch.telemetry.metrics import C_IDX
        self.intervals += 1
        arrivals = interval_counts[:, C_IDX["arrivals"]]
        completed = interval_counts[:, C_IDX["completed"]]
        samples = sig.lat_samples
        has_target = self.targets > 0
        bad_lat = has_target & (samples > 0) & (sig.p99 > self.targets)
        starved = has_target & (arrivals > 0) & (completed == 0) \
            & (samples == 0)
        bad = bad_lat | starved
        active = (samples > 0) | (arrivals > 0)
        self._observed += (has_target & active).astype(np.int64)
        self._violating += bad.astype(np.int64)
        out: List[SLOAlert] = []
        budget = self.cfg.budget
        for i in np.nonzero(has_target)[0]:
            i = int(i)
            hist = self._bad[i]
            hist.append(bool(bad[i]))
            self._note_violation_span(i, t, bool(bad[i]))
            for window, length, thresh in (
                    (FAST, self.cfg.fast_windows, self.cfg.fast_burn),
                    (SLOW, self.cfg.slow_windows, self.cfg.slow_burn)):
                if len(hist) < length:
                    continue
                tail = list(hist)[-length:]
                burn = (sum(tail) / length) / budget
                on = self._alert_on[window]
                if burn >= thresh and not on[i]:
                    on[i] = True
                    alert = SLOAlert(
                        t=float(t), tenant=i, window=window,
                        burn_rate=float(burn), p99=float(sig.p99[i]),
                        target=float(self.targets[i]))
                    out.append(alert)
                    self.alerts_total += 1
                    if len(self.alerts) < MAX_ALERTS:
                        self.alerts.append(alert)
                    self._first_alert_t.setdefault(i, float(t))
                elif burn < thresh and on[i]:
                    on[i] = False
        return tuple(out)

    def _note_violation_span(self, tenant: int, t: float, bad: bool) -> None:
        if bad:
            wins = self._vwindows.setdefault(tenant, [])
            if self._open_window.get(tenant):
                if wins:
                    wins[-1][1] = float(t)
            elif len(wins) < MAX_VIOLATION_WINDOWS:
                wins.append([float(t), float(t)])
            self._open_window[tenant] = True
        else:
            self._open_window[tenant] = False

    # -- controller coupling ------------------------------------------------
    def note_intervention(self, t: float, action,
                          installed=None) -> List[dict]:
        """Record the QoS controller's actuation for this tick.  A
        tenant counts as *intervened* when its AIMD boost changed or
        its admission gate flipped relative to the previous tick.
        Returns the new intervention rows."""
        boost = np.asarray(action.boost, float)
        admit = np.asarray(action.admit, bool)
        mask = np.ones(len(boost), bool) if installed is None \
            else np.asarray(installed, bool)
        # neutral pre-controller state: unit boost, everyone admitted —
        # so a first tick that moves a knob already counts
        if self._last_boost is None:
            self._last_boost = np.ones_like(boost)
        if self._last_admit is None:
            self._last_admit = np.ones(len(admit), bool)
        new: List[dict] = []
        changed = mask & (boost != self._last_boost)
        for i in np.nonzero(changed)[0]:
            new.append({"t": float(t), "tenant": int(i),
                        "kind": IV_AIMD_WEIGHT,
                        "value": float(boost[i])})
        flipped = mask & (admit != self._last_admit)
        for i in np.nonzero(flipped)[0]:
            new.append({"t": float(t), "tenant": int(i),
                        "kind": IV_ADMISSION,
                        "value": float(admit[i])})
        self._last_boost = boost.copy()
        self._last_admit = admit.copy()
        for iv in new:
            self.interventions_total += 1
            if len(self.interventions) < MAX_INTERVENTIONS:
                self.interventions.append(iv)
            self._first_intervention_t.setdefault(iv["tenant"], iv["t"])
        return new

    # -- report -------------------------------------------------------------
    def summary(self) -> dict:
        """The ``RunReport.extras['slo_audit']`` block (JSON-able)."""
        tenants = {}
        for i in np.nonzero(self.targets > 0)[0]:
            i = int(i)
            observed = int(self._observed[i])
            viol = int(self._violating[i])
            first_alert = self._first_alert_t.get(i)
            first_iv = self._first_intervention_t.get(i)
            lead = (first_iv - first_alert
                    if first_alert is not None and first_iv is not None
                    else None)
            tenants[i] = {
                "target_p99": float(self.targets[i]),
                "observed_intervals": observed,
                "violating_intervals": viol,
                "compliance_pct": round(
                    100.0 * (1.0 - viol / observed) if observed else 100.0,
                    4),
                "budget_burn": round(
                    (viol / self.intervals) / self.cfg.budget
                    if self.intervals else 0.0, 4),
                "alerts": int(sum(a.tenant == i for a in self.alerts)),
                "first_alert_t": first_alert,
                "first_intervention_t": first_iv,
                "alert_lead": lead,
                "violation_windows": self._vwindows.get(i, []),
            }
        return {
            "objective": self.cfg.objective,
            "budget": self.cfg.budget,
            "fast_windows": self.cfg.fast_windows,
            "slow_windows": self.cfg.slow_windows,
            "fast_burn": self.cfg.fast_burn,
            "slow_burn": self.cfg.slow_burn,
            "intervals": self.intervals,
            "interval_unit": self.time_unit,
            "alerts_total": self.alerts_total,
            "interventions_total": self.interventions_total,
            "tenants": tenants,
            "alerts": [dataclasses.asdict(a) for a in self.alerts],
            "interventions": list(self.interventions),
        }


# summary keys RunReport.validate() checks (single source of truth)
SUMMARY_KEYS = ("objective", "budget", "fast_windows", "slow_windows",
                "fast_burn", "slow_burn", "intervals", "interval_unit",
                "alerts_total", "interventions_total", "tenants", "alerts",
                "interventions")
TENANT_SUMMARY_KEYS = ("target_p99", "observed_intervals",
                       "violating_intervals", "compliance_pct",
                       "budget_burn", "alerts", "first_alert_t",
                       "first_intervention_t", "alert_lead",
                       "violation_windows")
