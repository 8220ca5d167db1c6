"""Derived per-tenant congestion / SLO signals (DESIGN.md §6).

The control plane reads the committed telemetry state plus the live
scheduler arrays and folds them into the signal vector the QoS
controller acts on.  Everything here is host-side numpy, consumed at
control-interval granularity: one ``Telemetry.snapshot`` per interval.

Signals (all ``[T]`` unless noted):

  * ``p50`` / ``p99``     — kernel/request sojourn latency from the log
                            histogram (queueing included);
  * ``ecn_rate``          — ECN-marked fraction of arrivals;
  * ``drop_rate``         — dropped fraction of arrivals;
  * ``service_debt``      — WLBVT debt: mean active priority-normalized
                            throughput minus own (positive = underserved);
  * ``kv_pressure``       — current occupancy / quota cap (serving R3) or
                            FIFO depth / capacity (sim);
  * ``occupancy_mean``    — windowed mean PU/slot occupancy (gauge ring);
  * ``queue_mean``        — windowed mean backlog;
  * ``jain_weighted``     — scalar: weighted Jain index over windowed
                            occupancy (folds core/accounting in).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.accounting import weighted_jain
from repro_torch.telemetry import metrics as M


@dataclasses.dataclass
class SignalFrame:
    """One control-interval reading of the telemetry plane.

    Zero-completion semantics (pinned): an interval in which a tenant
    records no latency samples reads ``p50 == p99 == 0.0`` — never a
    stale carry-forward of the previous interval and never NaN.  Any
    real sample lands in a log2 bucket whose value is >= 1, so 0.0
    uniquely encodes "no data"; ``lat_samples`` carries the per-tenant
    interval sample count so consumers (the SLO burn-rate audit) can
    tell an idle interval from a fast one and must not count it as a
    latency violation.
    """
    p50: np.ndarray
    p99: np.ndarray
    ecn_rate: np.ndarray
    drop_rate: np.ndarray
    service_debt: np.ndarray
    kv_pressure: np.ndarray
    occupancy_mean: np.ndarray
    queue_mean: np.ndarray
    jain_weighted: float
    lat_samples: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


def wlbvt_service_debt(total_occup, bvt, prio) -> np.ndarray:
    """Per-tenant WLBVT debt: how far below the mean *active* tenant's
    priority-normalized service rate this tenant is running.  Positive =
    underserved (owed service), negative = overserved."""
    total_occup = np.asarray(total_occup, float)
    bvt = np.asarray(bvt, float)
    prio = np.asarray(prio, float)
    norm = total_occup / np.maximum(bvt, 1.0) / np.maximum(prio, 1e-9)
    active = bvt > 0
    if not active.any():
        return np.zeros_like(norm)
    return np.where(active, norm[active].mean() - norm, 0.0)


def compute_signals(tel, *, prio, total_occup, bvt,
                    kv_pressure: Optional[np.ndarray] = None,
                    baseline: Optional[dict] = None,
                    snap: Optional[dict] = None) -> SignalFrame:
    """Fold the committed telemetry state + live WLBVT arrays into one
    ``SignalFrame``.  ``tel`` is a ``Telemetry`` wrapper (any backend).

    With ``baseline`` (a previous ``tel.snapshot()``), counters and the
    latency histogram are differenced against it so the latency/rate
    signals cover only the interval since — the responsive form a closed
    loop needs; without it they are run-lifetime cumulative.  Pass a
    pre-taken ``snap`` to reuse it (the control loop hands the same
    snapshot on as the next interval's baseline, so one snapshot per
    interval serves both).
    """
    if snap is None:
        snap = tel.snapshot()
    counts, hist = snap["counts"], snap["hist"]
    if baseline is not None:
        counts = counts - baseline["counts"]
        hist = hist - baseline["hist"]
    arrivals = np.maximum(counts[:, M.C_IDX["arrivals"]], 1.0)
    gmean = M.ring_mean(snap["ring"], int(snap["ptr"]), np)
    occ_mean = gmean[M.G_IDX["occupancy"]]
    prio = np.asarray(prio, float)
    active = occ_mean > 0
    jain = (weighted_jain(occ_mean[active], prio[active])
            if active.sum() >= 2 else 1.0)
    return SignalFrame(
        p50=M.hist_quantile(hist, 0.50, np),
        p99=M.hist_quantile(hist, 0.99, np),
        ecn_rate=counts[:, M.C_IDX["ecn_marks"]] / arrivals,
        drop_rate=counts[:, M.C_IDX["drops"]] / arrivals,
        service_debt=wlbvt_service_debt(total_occup, bvt, prio),
        kv_pressure=(np.zeros(tel.T) if kv_pressure is None
                     else np.asarray(kv_pressure, float)),
        occupancy_mean=occ_mean,
        queue_mean=gmean[M.G_IDX["queue_len"]],
        jain_weighted=float(jain),
        lat_samples=hist.sum(axis=1).astype(float),
    )
