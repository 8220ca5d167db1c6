"""Backend-generic per-tenant metric collectors.

Fixed-shape, array-native state: every kernel here is written once
against an array namespace ``xp`` (numpy, for the simulators' eager fp64
commits), is purely functional (returns new arrays, never mutates), and
is branch-free in array values.  Each has a ``*_torch`` counterpart with
the same arithmetic on the dtypes of a device state (int32 counts and
histogram, fp32 gauges and latencies, an int32 0-d ``ptr``), so the
``"torch"`` backend commits on the card with no host sync.

Three collector families, all ``[T]``-leading so one state serves every
tenant at once:

  * counters        — ``counts [T, C]``, one named column per event kind;
  * latency histograms — ``hist [T, B]`` log-bucketed (HDR-style): bucket
    ``i`` covers ``[LO·G^i, LO·G^(i+1))``, so 32 base-2 buckets span
    1 ns .. ~4 s (or 1 .. 2^32 engine steps) at fixed memory;
  * windowed gauges — ``ring [G, T, W]`` circular buffers of per-window
    samples (occupancy, queue depth, service rate, KV pressure) with a
    single shared write pointer.

``TelemetryState`` is a plain dict of arrays; the ``Telemetry`` wrapper
below stages scalar events cheaply on the host and flushes them once per
step/window — in place on numpy (the simulators, and the serving engine
by default), or through the ``*_torch`` kernels on a device (the serving
engine with ``telemetry_backend="torch"``: the state lives on the
executor's device and ``snapshot()`` is the only copy back).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# counter columns (fixed order — indices are part of the state layout)
COUNTERS: Tuple[str, ...] = (
    "arrivals", "drops", "ecn_marks", "completed", "killed", "rejected",
    "bytes_in", "bytes_out", "tokens",
)
C_IDX: Dict[str, int] = {n: i for i, n in enumerate(COUNTERS)}

# ring-buffered gauges (one per-window sample each)
GAUGES: Tuple[str, ...] = ("occupancy", "queue_len", "service_rate",
                           "kv_pressure")
G_IDX: Dict[str, int] = {n: i for i, n in enumerate(GAUGES)}

HIST_BUCKETS = 32    # [T, 32] log2 buckets: 1 .. 2^32 latency units
HIST_LO = 1.0        # lower edge of bucket 0 (ns on the sim, steps serving)
HIST_GROWTH = 2.0
RING_WINDOW = 64     # windows retained per gauge
BUCKET_EPS = 1e-6    # pre-floor epsilon: fp32 (device) and fp64 (sim)
#                      agree at exact-boundary values (CEIL_EPS idiom)


# ---------------------------------------------------------------------------
# pure kernels (array-namespace generic)
# ---------------------------------------------------------------------------
def create_state(num_tenants: int, *, n_buckets: int = HIST_BUCKETS,
                 window: int = RING_WINDOW, xp=np, dtype=None) -> dict:
    """Fresh all-zero telemetry state for ``num_tenants`` tenants.

    Counters and histogram bins are integers — monotone accumulators in
    fp32 (a device state's float dtype) would silently saturate at 2^24
    (+1 becomes a no-op), blinding interval-differenced signals on long
    runs.  Gauges stay float (``dtype`` overrides the ring dtype only).
    """
    dt = dtype or (np.float64 if xp is np else xp.float32)
    ct = np.int64 if xp is np else xp.int32
    T = num_tenants
    return {
        "counts": xp.zeros((T, len(COUNTERS)), ct),
        "hist": xp.zeros((T, n_buckets), ct),
        "ring": xp.zeros((len(GAUGES), T, window), dt),
        "ptr": xp.zeros((), xp.int32),
    }


def bucket_index(values, n_buckets: int, xp):
    """Log-bucket index of each value: ``clip(floor(log_G(v/LO)), 0, B-1)``."""
    v = xp.maximum(xp.asarray(values, xp.float32 if xp is not np
                              else np.float64), HIST_LO)
    idx = xp.floor(xp.log(v / HIST_LO) / np.log(HIST_GROWTH) + BUCKET_EPS)
    return xp.clip(idx, 0, n_buckets - 1).astype(xp.int32)


def bucket_value(idx, xp=np):
    """Representative latency of a bucket (geometric mid of its edges)."""
    return HIST_LO * HIST_GROWTH ** (xp.asarray(idx, float) + 0.5)


def hist_add(hist, values, mask, xp):
    """Scatter one latency sample per masked tenant into ``hist [T, B]``.

    One-hot add keeps the op fixed-shape and scatter-free: a plain
    compare + add on a device (no host sync, no dynamic shapes).
    """
    B = hist.shape[1]
    idx = bucket_index(values, B, xp)
    onehot = (xp.arange(B)[None, :] == idx[:, None]) & \
        xp.asarray(mask, bool)[:, None]
    return hist + onehot.astype(hist.dtype)


def hist_quantile(hist, q: float, xp=np):
    """Per-tenant quantile estimate from the log histogram.

    Returns the representative value of the first bucket whose CDF
    reaches ``q`` (``[T]`` float; 0 where a tenant has no samples).
    """
    total = xp.sum(hist, axis=1)
    cdf = xp.cumsum(hist, axis=1)
    target = xp.maximum(q * total, 1e-12)
    first = xp.argmax(cdf >= target[:, None], axis=1)
    return xp.where(total > 0, bucket_value(first, xp), 0.0)


def ring_push(ring, ptr, samples, xp):
    """Append one ``[G, T]`` sample column to ``ring [G, T, W]``.

    Returns ``(ring, ptr+1)``; the write slot is ``ptr % W`` so the ring
    holds the last W windows once warm.
    """
    W = ring.shape[-1]
    hot = xp.arange(W) == ptr % W
    ring = xp.where(hot[None, None, :],
                    xp.asarray(samples, ring.dtype)[..., None], ring)
    return ring, ptr + 1


def ring_mean(ring, ptr, xp=np):
    """Mean of the valid portion of each gauge ring -> ``[G, T]``."""
    W = ring.shape[-1]
    n = xp.clip(ptr, 1, W)
    valid = (xp.arange(W) < ptr)[None, None, :]
    return xp.sum(xp.where(valid, ring, 0.0), axis=-1) / n


def record_step(state: dict, counts_inc, lat_values, lat_mask, xp) -> dict:
    """Commit one flush of staged samples: counter increments ``[T, C]``
    plus at most one latency sample per tenant (``lat_values/lat_mask``,
    both ``[T]``).  Pure."""
    return dict(state,
                counts=state["counts"] + xp.asarray(counts_inc,
                                                    state["counts"].dtype),
                hist=hist_add(state["hist"], lat_values, lat_mask, xp))


def record_window(state: dict, gauges, xp) -> dict:
    """Commit one ``[G, T]`` gauge sample column into the rings.  Pure."""
    ring, ptr = ring_push(state["ring"], state["ptr"], gauges, xp)
    return dict(state, ring=ring, ptr=ptr)


# ---------------------------------------------------------------------------
# the same kernels on torch tensors (the "torch" backend's device state)
# ---------------------------------------------------------------------------
def create_state_torch(num_tenants: int, *, n_buckets: int = HIST_BUCKETS,
                       window: int = RING_WINDOW, device="cuda") -> dict:
    """``create_state`` on ``device`` with a device state's dtypes: int32
    counts and histogram, an fp32 ring and an int32 0-d ``ptr``."""
    T = num_tenants
    return {
        "counts": torch.zeros((T, len(COUNTERS)), dtype=torch.int32,
                              device=device),
        "hist": torch.zeros((T, n_buckets), dtype=torch.int32,
                            device=device),
        "ring": torch.zeros((len(GAUGES), T, window), dtype=torch.float32,
                            device=device),
        "ptr": torch.zeros((), dtype=torch.int32, device=device),
    }


def bucket_index_torch(values: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``bucket_index`` in fp32: ``BUCKET_EPS`` absorbs the last-ulp
    error of ``log`` at the exact bucket edges (the powers of two)."""
    v = torch.clamp_min(values.to(torch.float32), HIST_LO)
    idx = torch.floor(torch.log(v / HIST_LO) / float(np.log(HIST_GROWTH))
                      + BUCKET_EPS)
    return torch.clamp(idx, 0, n_buckets - 1).to(torch.int32)


def hist_add_torch(hist: torch.Tensor, values: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """``hist_add``: one-hot compare + add, no scatter, no host sync."""
    B = hist.shape[1]
    idx = bucket_index_torch(values, B)
    onehot = ((torch.arange(B, device=hist.device)[None, :] == idx[:, None])
              & mask.to(torch.bool)[:, None])
    return hist + onehot.to(hist.dtype)


def ring_push_torch(ring: torch.Tensor, ptr: torch.Tensor,
                    samples: torch.Tensor):
    """``ring_push``: the write slot is chosen by a one-hot ``where`` on
    the device ``ptr`` (indexing by ``int(ptr)`` would sync the host)."""
    W = ring.shape[-1]
    hot = torch.arange(W, device=ring.device) == ptr % W
    ring = torch.where(hot[None, None, :],
                       samples.to(ring.dtype)[..., None], ring)
    return ring, ptr + 1


def record_step_torch(state: dict, counts_inc: torch.Tensor,
                      lat_values: torch.Tensor,
                      lat_mask: torch.Tensor) -> dict:
    """``record_step`` on a device state.  ``counts_inc`` arrives in fp32
    (as the reference's jnp backend receives it) and is cast to int32."""
    return dict(state,
                counts=state["counts"] + counts_inc.to(state["counts"].dtype),
                hist=hist_add_torch(state["hist"], lat_values, lat_mask))


def record_window_torch(state: dict, gauges: torch.Tensor) -> dict:
    """``record_window`` on a device state."""
    ring, ptr = ring_push_torch(state["ring"], state["ptr"], gauges)
    return dict(state, ring=ring, ptr=ptr)


# ---------------------------------------------------------------------------
# staging wrapper (both execution surfaces)
# ---------------------------------------------------------------------------
class Telemetry:
    """Per-tenant metric plane: cheap host-side staging + array commits.

    ``inc``/``lat`` stage scalar events in O(1) numpy writes; ``commit``
    flushes them on the configured backend: in place into the numpy
    state (``"numpy"``), or through the ``*_torch`` kernels into a state
    on ``device`` (``"torch"``, the jnp backend's counterpart: one pinned,
    asynchronous host-to-device copy per commit and no host sync; signal
    readers pull the arrays back explicitly via ``snapshot()``).
    ``device`` defaults to the card; without one the ``"torch"`` backend
    raises rather than fall back.
    """

    def __init__(self, num_tenants: int, *, n_buckets: int = HIST_BUCKETS,
                 window: int = RING_WINDOW, backend: str = "numpy",
                 device=None):
        self.T = num_tenants
        self.backend = backend
        if backend == "torch":
            self.device = torch.device("cuda" if device is None else device)
            self.xp = torch
            self.state = create_state_torch(num_tenants, n_buckets=n_buckets,
                                            window=window, device=self.device)
        elif backend == "numpy":
            self.xp = np
            self.state = create_state(num_tenants, n_buckets=n_buckets,
                                      window=window, xp=np)
        else:
            raise ValueError(f"unknown telemetry backend {backend!r} "
                             "('numpy' or 'torch')")
        self._staged_counts = np.zeros((num_tenants, len(COUNTERS)))
        self._staged_lat: List[Tuple[int, float]] = []

    # -- staging (host, O(1) per event) ------------------------------------
    def inc(self, name: str, tenant: int, amount: float = 1.0) -> None:
        self._staged_counts[tenant, C_IDX[name]] += amount

    def inc_column(self, name: str, totals) -> None:
        """Stage pre-aggregated per-tenant totals (``[T]``) in one add —
        equal to per-event ``inc`` calls for the integer-valued totals
        this plane records (integer float sums are exact)."""
        self._staged_counts[:, C_IDX[name]] += totals

    def lat(self, tenant: int, value: float) -> None:
        self._staged_lat.append((tenant, value))

    def staged(self, name: str) -> np.ndarray:
        """Not-yet-committed counter increments for ``name`` (``[T]``)."""
        return self._staged_counts[:, C_IDX[name]].copy()

    # -- commits ------------------------------------------------------------
    def _flush_rounds(self):
        """Group staged latencies into rounds of <= 1 sample per tenant."""
        rounds: List[Tuple[np.ndarray, np.ndarray]] = []
        vals = np.zeros(self.T)
        mask = np.zeros(self.T, bool)
        for t, v in self._staged_lat:
            if mask[t]:
                rounds.append((vals, mask))
                vals, mask = np.zeros(self.T), np.zeros(self.T, bool)
            vals[t] = v
            mask[t] = True
        if mask.any():
            rounds.append((vals, mask))
        self._staged_lat.clear()
        return rounds

    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """One fp32 staging vector to the state's device: pinned and
        asynchronous on the card (a pageable or blocking copy would make
        the host wait for the stream)."""
        t = torch.from_numpy(host)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def commit(self) -> None:
        """Flush staged counters + latencies (call once per step/window).

        The numpy backend takes an in-place fast path (one vectorized
        ``np.add.at`` through the same ``bucket_index`` kernel — result
        identical to the one-hot ``record_step`` path).  The torch
        backend runs the reference's jnp path, ``record_step`` once per
        round of at most one latency per tenant, on one upload of the
        staged counts and rounds (fp32, as the jitted call receives
        them)."""
        if self.xp is np:
            if self._staged_counts.any():
                self.state["counts"] += self._staged_counts.astype(
                    self.state["counts"].dtype)
                self._staged_counts[:] = 0.0
            if self._staged_lat:
                ts = np.array([t for t, _ in self._staged_lat], np.int64)
                vs = np.array([v for _, v in self._staged_lat])
                idx = bucket_index(vs, self.state["hist"].shape[1], np)
                np.add.at(self.state["hist"], (ts, idx), 1)
                self._staged_lat.clear()
            return
        rounds = self._flush_rounds()
        counts = self._staged_counts
        if not rounds and not counts.any():
            return
        if not rounds:
            rounds = [(np.zeros(self.T), np.zeros(self.T, bool))]
        T, C = counts.shape
        host = np.empty(T * C + 2 * T * len(rounds), np.float32)
        host[:T * C] = counts.ravel()
        for i, (vals, mask) in enumerate(rounds):
            o = T * C + 2 * T * i
            host[o:o + T] = vals
            host[o + T:o + 2 * T] = mask
        dev = self._upload(host)
        counts_inc = dev[:T * C].view(T, C)
        for i in range(len(rounds)):
            o = T * C + 2 * T * i
            ci = counts_inc if i == 0 else torch.zeros_like(counts_inc)
            self.state = record_step_torch(self.state, ci, dev[o:o + T],
                                           dev[o + T:o + 2 * T] > 0.5)
        self._staged_counts[:] = 0.0

    def commit_window(self, gauges) -> None:
        """Push one ``[G, T]`` gauge sample (occupancy, queue, rate, KV)."""
        if self.xp is np:
            ring, ptr = self.state["ring"], self.state["ptr"]
            ring[:, :, int(ptr) % ring.shape[-1]] = gauges
            ptr += 1          # 0-d array: in-place increment
            return
        g = self._upload(np.asarray(gauges, np.float32).ravel())
        self.state = record_window_torch(
            self.state, g.view(len(GAUGES), self.T))

    def reset_tenant(self, tenant: int) -> None:
        """Zero one tenant's committed and staged metrics (ECTX teardown
        — a reused tenant id must not inherit telemetry history)."""
        self._staged_counts[tenant] = 0.0
        self._staged_lat = [(t, v) for t, v in self._staged_lat
                            if t != tenant]
        self.state["counts"][tenant] = 0
        self.state["hist"][tenant] = 0
        self.state["ring"][:, tenant, :] = 0.0

    # -- reads (host) --------------------------------------------------------
    def snapshot(self) -> dict:
        """Committed state as host numpy copies (on the torch backend the
        only device-to-host copy) — a snapshot stays frozen while commits
        continue."""
        if self.xp is np:
            return {k: np.array(v) for k, v in self.state.items()}
        return {k: np.array(v.cpu().numpy()) for k, v in self.state.items()}

    def counter(self, name: str, snap: Optional[dict] = None) -> np.ndarray:
        s = snap or self.snapshot()
        return s["counts"][:, C_IDX[name]]
