"""Modeled VOQ/crossbar switch connecting the per-NIC engines.

The fabric model follows the classic input-queued switch shape
(SNIPPETS.md §1/§3): each of the N input ports keeps one bounded
virtual output queue *per output port*, so a saturated output can only
back up its own VOQs — packets headed to an uncongested output are
never stuck behind them (no head-of-line blocking; pinned by the
``fleet_incast`` test).  Each output port runs its own arbiter over
the N inputs:

  * ``rr``   — round-robin pointer scan (same grant order as
               ``wlbvt.select_rr``, inlined for the per-packet path);
  * ``mdrr`` — modified deficit round robin over the VOQ head sizes,
               reusing ``wlbvt.DWRRState``/``dwrr_select`` verbatim.

A granted packet occupies its output link for ``size*8/link_gbps`` ns
of serialization and lands ``prop_delay_ns`` later.  ``link_gbps == 0``
and ``prop_delay_ns == 0`` select the ideal passthrough fabric
(deliveries are the injections, verbatim) used for the N=1
bit-identity configuration.

All state advances through a resumable ``advance(t)`` so the fleet
engine can co-step the switch with the per-NIC engines in epochs; the
same conservation law the property tests pin holds at every instant:

    injected + replayed == delivered + dropped + in-flight
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core import wlbvt as W
from repro_torch.core.events import Event, EventKind

_K_IN = 0    # packet reaches its input port's VOQ stage
_K_OUT = 1   # output link finishes serializing the granted packet


class CrossbarSwitch:
    """N-port input-queued crossbar with bounded VOQs.

    Packets are ``(arrival, src, dst, tenant, size)``; ``inject`` is
    resumable/out-of-order-safe as long as times within one epoch are
    fed before ``advance`` crosses them (the fleet engine guarantees
    this by injecting each epoch's trace slice before advancing).
    """

    def __init__(self, num_ports: int, *, num_tenants: int,
                 link_gbps: float = 400.0, prop_delay_ns: float = 50.0,
                 voq_depth: int = 1024, arbiter: str = "rr",
                 quantum_bytes: int = 4096, tracer=None,
                 track_ids: bool = False):
        if num_ports < 1:
            raise ValueError("num_ports must be >= 1")
        if arbiter not in ("rr", "mdrr"):
            raise ValueError(f"unknown switch arbiter {arbiter!r}")
        self.n = num_ports
        self.num_tenants = num_tenants
        self.link_gbps = float(link_gbps)
        self.prop_delay_ns = float(prop_delay_ns)
        self.voq_depth = int(voq_depth)
        self.arbiter = arbiter
        self.quantum = int(quantum_bytes)
        self.passthrough = self.link_gbps == 0.0 and self.prop_delay_ns == 0.0
        self.tracer = tracer
        self.now = 0.0

        n = num_ports
        # voq[src][dst] -> list of (t_in, tenant, size, uid) FIFOs
        self._voq: List[List[List[tuple]]] = [
            [[] for _ in range(n)] for _ in range(n)]
        self._voq_head: List[List[int]] = [[0] * n for _ in range(n)]
        self.voq_len = np.zeros((n, n), np.int64)
        self.voq_peak = np.zeros((n, n), np.int64)
        self._rr_ptr = [0] * n                     # per-output input scan
        self._out_pending = [0] * n                # queued pkts per output
        self._dwrr = [W.DWRRState.create(np.ones(n)) for _ in range(n)]
        self._busy = [False] * n                   # output link serializing
        self._tx: List[Optional[tuple]] = [None] * n
        self._heap: List[tuple] = []               # (t, seq, code, port)
        self._deliv: List[tuple] = []              # (t_out, seq, tenant,
        #                                             size, dst, src, t_in)
        self._seq = 0
        self._uid = 0
        # bulk arrival stream (inject_bulk): consumed by advance()
        self._in_t = np.empty(0, np.float64)
        self._in_src = self._in_dst = self._in_ten = self._in_sz = \
            np.empty(0, np.int64)
        self._in_idx = 0
        self._in_uid0 = 0

        t = num_tenants
        self.injected = np.zeros(t, np.int64)
        self.replayed = np.zeros(t, np.int64)      # migration re-injections
        self.delivered = np.zeros(t, np.int64)
        self.dropped = np.zeros(t, np.int64)
        self.busy_ns = np.zeros(n, np.float64)
        self.pair_lat_sum = np.zeros((n, n), np.float64)
        self.pair_count = np.zeros((n, n), np.int64)
        self.events: List[Event] = []

        self.track_ids = track_ids
        self.injected_ids: Set[int] = set()
        self.delivered_ids: Set[int] = set()
        self.dropped_ids: Set[int] = set()

    # ---------------------------------------------------------- inject

    def inject(self, t: float, src: int, dst: int, tenant: int, size: int,
               *, replay: bool = False) -> None:
        uid = self._uid
        self._uid += 1
        if replay:
            self.replayed[tenant] += 1
        else:
            self.injected[tenant] += 1
        if self.track_ids:
            self.injected_ids.add(uid)
        if self.passthrough:
            self._seq += 1
            heapq.heappush(self._deliv,
                           (t, self._seq, tenant, size, dst, src, t))
            return
        self._seq += 1
        heapq.heappush(self._heap,
                       (t, self._seq, _K_IN, (src, dst, tenant, size, uid)))

    def inject_bulk(self, times: np.ndarray, srcs: np.ndarray,
                    dsts: np.ndarray, tenants: np.ndarray,
                    sizes: np.ndarray) -> None:
        """Array fast path for a time-sorted arrival stream (the
        control-plane-off slice): one call replaces ``len(times)``
        ``inject()``s — identical uids, counters and arrival order,
        minus the per-packet call + heap churn.  ``advance`` merges the
        stream with the serialization-event heap."""
        if self._in_idx < len(self._in_t):
            raise RuntimeError("bulk arrival stream still pending")
        if self.passthrough:
            for j in range(len(times)):
                self.inject(float(times[j]), int(srcs[j]), int(dsts[j]),
                            int(tenants[j]), int(sizes[j]))
            return
        n = len(times)
        self.injected += np.bincount(tenants, minlength=self.num_tenants)
        uid0 = self._uid
        self._uid += n
        if self.track_ids:
            self.injected_ids.update(range(uid0, uid0 + n))
        self._in_t = np.asarray(times, np.float64)
        self._in_src = np.asarray(srcs, np.int64)
        self._in_dst = np.asarray(dsts, np.int64)
        self._in_ten = np.asarray(tenants, np.int64)
        self._in_sz = np.asarray(sizes, np.int64)
        self._in_idx = 0
        self._in_uid0 = uid0

    def bulk_passthrough(self, tenants: np.ndarray, srcs: np.ndarray,
                         dsts: np.ndarray) -> None:
        """Counter-only fast path for the single-shot (N=1 ideal
        fabric) configuration: every injection is its own delivery."""
        self.injected += np.bincount(tenants, minlength=self.num_tenants)
        self.delivered += np.bincount(tenants, minlength=self.num_tenants)
        np.add.at(self.pair_count, (srcs, dsts), 1)

    # --------------------------------------------------------- advance

    def advance(self, t: float) -> List[Tuple[float, int, int, int]]:
        """Run the fabric up to (and including) virtual time ``t``;
        return the chronological ``(t_deliver, tenant, size, dst)``
        deliveries that have landed by then.  Later deliveries stay
        buffered for the next call."""
        heap, deliv = self._heap, self._deliv
        it, idx, n_in = self._in_t, self._in_idx, len(self._in_t)
        isrc, idst = self._in_src, self._in_dst
        iten, isz, uid0 = self._in_ten, self._in_sz, self._in_uid0
        while True:
            # merge the sorted bulk stream with the event heap; at equal
            # times arrivals win, matching inject()'s seq ordering
            t_in = it[idx] if idx < n_in else None
            if (t_in is not None and t_in <= t
                    and (not heap or t_in <= heap[0][0])):
                self._arrive(float(t_in),
                             (int(isrc[idx]), int(idst[idx]),
                              int(iten[idx]), int(isz[idx]), uid0 + idx))
                idx += 1
            elif heap and heap[0][0] <= t:
                et, _, code, payload = heapq.heappop(heap)
                if code == _K_IN:
                    self._arrive(et, payload)
                else:
                    self._tx_done(et, payload)
            else:
                break
        self._in_idx = idx
        out: List[Tuple[float, int, int, int]] = []
        while deliv and deliv[0][0] <= t:
            dt_, _, tenant, size, dst, src, t_in = heapq.heappop(deliv)
            self.delivered[tenant] += 1
            self.pair_lat_sum[src, dst] += dt_ - t_in
            self.pair_count[src, dst] += 1
            out.append((dt_, tenant, size, dst))
        if t > self.now:
            self.now = t
        return out

    @property
    def idle(self) -> bool:
        """No queued fabric events and no undelivered packets."""
        return (not self._heap and not self._deliv
                and self._in_idx >= len(self._in_t))

    @property
    def inflight(self) -> int:
        voq = int(self.voq_len.sum())
        tx = sum(1 for p in self._tx if p is not None)
        pending = len(self._in_t) - self._in_idx
        return voq + tx + len(self._deliv) + pending

    # ----------------------------------------------------- event paths

    def _arrive(self, t: float, payload: tuple) -> None:
        src, dst, tenant, size, uid = payload
        if (not self._busy[dst] and self._out_pending[dst] == 0
                and self.arbiter == "rr" and self.voq_depth >= 1):
            # uncontended fast path: idle output, empty VOQ column —
            # the append + immediate-grant sequence collapses to a
            # direct grant with identical externally visible state
            # (RR pointer advanced past src, peak depth 1, same OUT
            # event).  MDRR keeps the slow path: its deficit counters
            # mutate on every select.
            if self.voq_peak[src, dst] == 0:
                self.voq_peak[src, dst] = 1
            self._rr_ptr[dst] = (src + 1) % self.n
            ser = size * 8.0 / self.link_gbps if self.link_gbps > 0 else 0.0
            self._busy[dst] = True
            self._tx[dst] = (t, tenant, size, uid, src)
            self.busy_ns[dst] += ser
            self._seq += 1
            heapq.heappush(self._heap, (t + ser, self._seq, _K_OUT, dst))
            return
        q = self._voq[src][dst]
        head = self._voq_head[src][dst]
        if len(q) - head >= self.voq_depth:
            self.dropped[tenant] += 1
            if self.track_ids:
                self.dropped_ids.add(uid)
            self.events.append(Event(
                tenant, EventKind.SWITCH_DROP, t,
                detail=f"voq[{src}->{dst}] full ({self.voq_depth})"))
            if self.tracer is not None:
                from repro_torch.telemetry.trace import D_DROP, ST_SWITCH
                self.tracer.span(ST_SWITCH, uid, tenant, t, t, disp=D_DROP)
            return
        q.append((t, tenant, size, uid))
        self._out_pending[dst] += 1
        depth = len(q) - head
        self.voq_len[src, dst] = depth
        if depth > self.voq_peak[src, dst]:
            self.voq_peak[src, dst] = depth
        if not self._busy[dst]:
            self._grant(dst, t)

    def _tx_done(self, t: float, out_port: int) -> None:
        t_in, tenant, size, uid, src = self._tx[out_port]
        self._tx[out_port] = None
        self._busy[out_port] = False
        self._seq += 1
        heapq.heappush(self._deliv,
                       (t + self.prop_delay_ns, self._seq, tenant, size,
                        out_port, src, t_in))
        if self.track_ids:
            self.delivered_ids.add(uid)
        if self.tracer is not None:
            from repro_torch.telemetry.trace import D_OK, ST_SWITCH
            self.tracer.span(ST_SWITCH, uid, tenant, t_in,
                             t + self.prop_delay_ns, disp=D_OK)
        self._grant(out_port, t)

    def _grant(self, out_port: int, t: float) -> None:
        """Arbitrate among the inputs holding traffic for ``out_port``
        and start serializing the winner's VOQ head."""
        src = self._pick_input(out_port)
        if src < 0:
            return
        q = self._voq[src][out_port]
        head = self._voq_head[src][out_port]
        t_in, tenant, size, uid = q[head]
        head += 1
        if head > 64 or head == len(q):          # amortized FIFO compaction
            del q[:head]
            head = 0
        self._voq_head[src][out_port] = head
        self.voq_len[src, out_port] = len(q) - head
        self._out_pending[out_port] -= 1
        ser = size * 8.0 / self.link_gbps if self.link_gbps > 0 else 0.0
        self._busy[out_port] = True
        self._tx[out_port] = (t_in, tenant, size, uid, src)
        self.busy_ns[out_port] += ser
        self._seq += 1
        heapq.heappush(self._heap, (t + ser, self._seq, _K_OUT, out_port))

    def _pick_input(self, out_port: int) -> int:
        n = self.n
        col = self.voq_len[:, out_port]
        if self.arbiter == "rr":
            # same semantics as wlbvt.select_rr, inlined: scan from the
            # pointer, grant the first non-empty VOQ, advance past it
            ptr = self._rr_ptr[out_port]
            for off in range(n):
                i = (ptr + off) % n
                if col[i] > 0:
                    self._rr_ptr[out_port] = (i + 1) % n
                    return i
            return -1
        pending = col > 0
        if not pending.any():
            return -1
        heads = np.zeros(n, np.float64)
        for i in range(n):
            if pending[i]:
                q = self._voq[i][out_port]
                heads[i] = q[self._voq_head[i][out_port]][2]
        return int(W.dwrr_select(self._dwrr[out_port], heads, pending,
                                 float(self.quantum)))

    # ----------------------------------------------------------- stats

    def conservation_ok(self) -> bool:
        counts = (int(self.injected.sum()) + int(self.replayed.sum())
                  == int(self.delivered.sum()) + int(self.dropped.sum())
                  + self.inflight)
        if not self.track_ids:
            return counts
        inflight_ids = (self.injected_ids - self.delivered_ids
                        - self.dropped_ids)
        return (counts
                and not (self.delivered_ids & self.dropped_ids)
                and len(inflight_ids) == self.inflight
                and len(self.delivered_ids) + len(self.dropped_ids)
                + len(inflight_ids) == len(self.injected_ids))

    def stats(self) -> Dict:
        elapsed = self.now if self.now > 0 else 1.0
        util = np.clip(self.busy_ns / elapsed, 0.0, 1.0)
        with np.errstate(invalid="ignore"):
            lat = np.where(self.pair_count > 0,
                           self.pair_lat_sum / np.maximum(self.pair_count, 1),
                           0.0)
        return {
            "ports": self.n,
            "arbiter": self.arbiter,
            "passthrough": self.passthrough,
            "injected": self.injected.tolist(),
            "replayed": self.replayed.tolist(),
            "delivered": self.delivered.tolist(),
            "dropped": self.dropped.tolist(),
            "drops_total": int(self.dropped.sum()),
            "inflight": self.inflight,
            "voq_peak": self.voq_peak.tolist(),
            "voq_peak_out": self.voq_peak.max(axis=0).tolist(),
            "voq_now": self.voq_len.tolist(),
            "link_busy_ns": self.busy_ns.tolist(),
            "link_utilization": util.tolist(),
            "pair_latency_mean": lat.tolist(),
            "pair_count": self.pair_count.tolist(),
        }
