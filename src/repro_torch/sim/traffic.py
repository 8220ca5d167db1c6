"""Packet trace generation (paper §7.2): arrival sequences uniform, sizes
lognormal [10, 81, 97], link fully utilized."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.configs.osmosis_pspin import PSPIN


@dataclasses.dataclass(frozen=True)
class TracePacket:
    time: float          # arrival, virtual ns (wire timing)
    tenant: int
    size: int            # bytes incl. header


@dataclasses.dataclass
class TraceArrays:
    """Structure-of-arrays packet trace (DESIGN.md §8).

    The column-wise twin of a ``List[TracePacket]``: same values, no
    per-packet Python objects, so million-packet traces are cheap to
    build and the batched simulator fast path consumes them directly.
    Row ``i`` of all three arrays is one packet; order is injection
    order (sorted by time for merged traces, exactly like
    ``merge_traces``).
    """
    times: np.ndarray      # (N,) float64
    tenants: np.ndarray    # (N,) int64
    sizes: np.ndarray      # (N,) int64

    def __len__(self) -> int:
        return int(self.times.shape[0])

    @classmethod
    def from_packets(cls, packets) -> "TraceArrays":
        return cls(times=np.array([p.time for p in packets], np.float64),
                   tenants=np.array([p.tenant for p in packets], np.int64),
                   sizes=np.array([p.size for p in packets], np.int64))

    def to_packets(self) -> List[TracePacket]:
        return [TracePacket(float(t), int(i), int(s))
                for t, i, s in zip(self.times, self.tenants, self.sizes)]


def merge_trace_arrays(*traces: TraceArrays) -> TraceArrays:
    """Array twin of ``merge_traces``: concatenate then stable-sort by
    time, so equal-time packets keep argument order (identical to the
    stable Python ``sort`` on packet lists)."""
    times = np.concatenate([t.times for t in traces])
    tenants = np.concatenate([t.tenants for t in traces])
    sizes = np.concatenate([t.sizes for t in traces])
    order = np.argsort(times, kind="stable")
    return TraceArrays(times[order], tenants[order], sizes[order])


def lognormal_sizes(rng: np.random.Generator, n: int, mean_bytes: float,
                    sigma: float = 0.7, lo: int = 64, hi: int = 4096
                    ) -> np.ndarray:
    mu = np.log(mean_bytes) - sigma ** 2 / 2
    s = rng.lognormal(mu, sigma, n)
    return np.clip(s, lo, hi).astype(np.int64)


def make_trace_arrays(tenant: int, n: int = 0, *, size: Optional[int] = None,
                      mean_size: float = 512.0, link_gbps: float = 400.0,
                      share: float = 1.0, start: float = 0.0,
                      duration_ns: Optional[float] = None,
                      seed: int = 0) -> TraceArrays:
    """``make_trace`` without the per-packet objects: same RNG stream,
    same values, returned as a ``TraceArrays`` column bundle."""
    rng = np.random.default_rng(seed + 7919 * tenant)
    if duration_ns is not None:
        mean = float(size) if size is not None else mean_size
        n = max(1, int(duration_ns * link_gbps * share / (8.0 * mean)))
    sizes = (np.full(n, size, np.int64) if size is not None
             else lognormal_sizes(rng, n, mean_size))
    ns_per_byte = 8.0 / (link_gbps * share)
    mean_gaps = sizes * ns_per_byte
    gaps = rng.uniform(0.0, 2.0 * mean_gaps)
    times = start + np.cumsum(gaps) - gaps[0]
    return TraceArrays(times=np.asarray(times, np.float64),
                       tenants=np.full(n, tenant, np.int64),
                       sizes=sizes)


def make_trace(tenant: int, n: int = 0, *, size: Optional[int] = None,
               mean_size: float = 512.0, link_gbps: float = 400.0,
               share: float = 1.0, start: float = 0.0,
               duration_ns: Optional[float] = None,
               seed: int = 0) -> List[TracePacket]:
    """Packets for one tenant at `share` of a fully-utilized link.

    Inter-arrival gaps are sampled from a uniform distribution with the
    mean matched to the byte rate (paper §7.2: "packet arrival sequences
    follow a uniform distribution"); `size=None` samples lognormal sizes.
    """
    return make_trace_arrays(
        tenant, n, size=size, mean_size=mean_size, link_gbps=link_gbps,
        share=share, start=start, duration_ns=duration_ns,
        seed=seed).to_packets()


def merge_traces(*traces: List[TracePacket]) -> List[TracePacket]:
    out = [p for tr in traces for p in tr]
    out.sort(key=lambda p: p.time)
    return out


def equal_share_traces(num_tenants: int, n_each: int = 0, *, sizes=None,
                       mean_size: float = 512.0, seed: int = 0,
                       duration_ns: Optional[float] = None,
                       arrays: bool = False):
    """All tenants push at the same ingress *byte* rate (paper §3 'PU
    contention'): each gets an equal share of the fully utilized link.
    With `duration_ns`, per-tenant packet counts are derived so all flows
    span the same wall-clock window regardless of packet size.  With
    ``arrays=True`` the merged trace is returned as ``TraceArrays``
    (identical packet sequence, no per-packet objects)."""
    traces = []
    for t in range(num_tenants):
        sz = sizes[t] if sizes is not None else None
        traces.append(make_trace_arrays(
            t, n_each, size=sz, mean_size=mean_size,
            link_gbps=PSPIN.ingress_gbps, share=1.0 / num_tenants,
            seed=seed, duration_ns=duration_ns))
    merged = merge_trace_arrays(*traces)
    return merged if arrays else merged.to_packets()
