"""Per-tenant statistics of the PsPIN simulator (``TenantStats``).

The sweep datapath (``sim/devicepath.py``) rebuilds its results into
these, so a replica's statistics carry the same fields, the same
kernel-time reservoir and the same ``default_rng(0xA11CE)`` replacement
stream as the JAX package's simulators: percentiles are bit-identical.
The host event-loop ``Simulator`` and the batched host datapath come to
this module in a later slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

KT_RESERVOIR_CAP = 4096   # kernel-time samples retained per tenant
_KT_RNG_SEED = 0xA11CE    # reservoir replacement stream (deterministic)


@dataclasses.dataclass
class TenantStats:
    completed: int = 0
    killed: int = 0
    drops: int = 0
    served_payload_bytes: float = 0.0
    io_bytes_done: float = 0.0
    first_arrival: float = float("inf")
    last_completion: float = 0.0
    # kernel service times: bounded reservoir (Algorithm R once past the
    # cap) + exact running count/sum — percentiles derive from the
    # reservoir instead of an unbounded list (below the cap the sample
    # is complete, so they are exact)
    kernel_time_count: int = 0
    kernel_time_sum: float = 0.0
    _kt_buf: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    _kt_rng: Optional[np.random.Generator] = dataclasses.field(
        default=None, repr=False, compare=False)
    _kt_pcache: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)

    def record_kernel_time(self, value: float) -> None:
        n = self.kernel_time_count
        if self._kt_buf is None:
            self._kt_buf = np.empty(KT_RESERVOIR_CAP)
        if n < KT_RESERVOIR_CAP:
            self._kt_buf[n] = value
        else:
            if self._kt_rng is None:
                self._kt_rng = np.random.default_rng(_KT_RNG_SEED)
            j = int(self._kt_rng.integers(0, n + 1))
            if j < KT_RESERVOIR_CAP:
                self._kt_buf[j] = value
        self.kernel_time_count = n + 1
        self.kernel_time_sum += value
        self._kt_pcache = None

    def record_kernel_times(self, values: np.ndarray) -> None:
        """Bulk replay of ``record_kernel_time`` over ``values`` in
        order, bit-identical to the sequential calls: the fill phase is
        a copy, the sum a ``cumsum`` tail (left-to-right accumulation,
        same rounding as ``+=``), and only samples past the reservoir
        cap walk the replacement rng one draw at a time."""
        values = np.asarray(values, dtype=float)
        if values.size == 0:
            return
        if self.kernel_time_count or self._kt_buf is not None:
            for v in values:              # mid-stream: no shortcut
                self.record_kernel_time(float(v))
            return
        buf = np.empty(KT_RESERVOIR_CAP)
        m = min(values.size, KT_RESERVOIR_CAP)
        buf[:m] = values[:m]
        self._kt_buf = buf
        if values.size > KT_RESERVOIR_CAP:
            rng = np.random.default_rng(_KT_RNG_SEED)
            for k in range(KT_RESERVOIR_CAP, values.size):
                j = int(rng.integers(0, k + 1))
                if j < KT_RESERVOIR_CAP:
                    buf[j] = values[k]
            self._kt_rng = rng
        self.kernel_time_count = int(values.size)
        self.kernel_time_sum = float(values.cumsum()[-1])
        self._kt_pcache = None

    @property
    def kernel_times(self) -> np.ndarray:
        """The retained kernel-time sample (complete below the cap).
        ``kernel_time_count``/``kernel_time_sum`` are always exact."""
        if self._kt_buf is None:
            return np.empty(0)
        return self._kt_buf[:min(self.kernel_time_count, KT_RESERVOIR_CAP)]

    def kernel_time_percentile(self, q: float) -> float:
        """Reservoir percentile, cached until the next sample lands."""
        if self.kernel_time_count == 0:
            return 0.0
        if self._kt_pcache is None:
            self._kt_pcache = {}
        if q not in self._kt_pcache:
            self._kt_pcache[q] = float(np.percentile(self.kernel_times, q))
        return self._kt_pcache[q]

    @property
    def fct(self) -> float:
        """Flow completion time: ``last_completion - first_arrival``.

        Explicitly 0.0 when the tenant saw no arrivals (packets injected
        before registration leave ``first_arrival`` unset) or no
        completions — previously the ``min(first_arrival,
        last_completion)`` guard silently collapsed those to 0."""
        if self.last_completion <= 0 or self.first_arrival == float("inf"):
            return 0.0
        return max(0.0, self.last_completion - self.first_arrival)
