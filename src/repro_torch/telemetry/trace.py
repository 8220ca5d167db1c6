"""Trace plane: packet-lifecycle flight recorder + decision provenance.

Two bounded, preallocated structure-of-arrays ring
buffers shared by every datapath through ``EngineBase``:

  * **span ring** — one row per packet lifecycle stage
    (ARRIVE → FMQ_ENQ → SCHED_GRANT → PU_EXEC → DMA → EQ_COMPLETE),
    each carrying tenant, PU slot, disposition and virtual-time
    begin/end.  Rows are written *complete* (at stage close), so ring
    eviction under flood can never strand half a span.
  * **decision ring** — one row per scheduler grant (WLBVT / RR /
    DWRR) or admission reject, carrying the eligible set, a per-tenant
    BVT-or-deficit snapshot, the winner and a reason code.

Recording sites stage O(1) work per event into flat typed buffers
(``array.array`` / ``bytearray`` — no per-event tuples or numpy calls)
and ``commit()`` expands + scatters them into the rings vectorized —
the same staging→commit rhythm as the telemetry plane: per window on
the sim datapaths, per step on the serving engine.  Each staging
method also notes the ring-row offset its rows will occupy, so commit
reassembles the exact staging order with index arithmetic alone
(no per-entry type dispatch).  The scatter itself is the fixed-shape
kernel :func:`ring_scatter`, in place on numpy: the rings are host
state on every machine, the card included.

The two staging records that carry the hot paths:

  * :meth:`TraceRecorder.span_packet` — one flat-buffer append
    covering a granted packet's whole lifecycle; commit expands it to
    the FMQ / GRANT / PU (/ DMA) / EQ rows.
  * :func:`record_wlbvt_round` — one append per scheduling round: the
    post-round scheduler arrays as a raw-bytes snapshot plus the pick
    list.  Commit reconstructs the pre-round state (picks are the
    exact charge the scheduler applied), replays per-pick eligibility
    with one batched computation over all rounds, and derives the
    reason codes.

Provenance is recorded by *replay*: the scheduler's own decision code
is never touched (bit-identity with tracing off is a hard contract).
The replay recomputes eligibility from snapshots with the same
formulas (``sched_generic``) the scheduler used.

A third table holds **host spans** on the wall clock
(``telemetry/clock.py``, the profiler's timeline): the serving engine's
steps and phases, its executor's calls and their stage / launch /
readback, and each request's queue / prefill / decode (DESIGN.md
§10.6).  Step and call spans nest through an open-span stack; the
executor, reached through wrappers, finds the recorder through
:func:`bound`, set by ``Engine.step()`` for the step's duration.
"""
from __future__ import annotations

import threading
from array import array
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import sched_generic as G
from repro_torch.telemetry.clock import now_ns

# --------------------------------------------------------------------------
# encodings
# --------------------------------------------------------------------------

# lifecycle stages (span ring ``stage`` column)
ST_ARRIVE = 0   # instant; disposition records the admission outcome
ST_FMQ = 1      # span [arrival, grant]: FMQ residency
ST_GRANT = 2    # instant at the WLBVT/RR grant; carries the PU slot
ST_PU = 3       # span [grant, t_comp]: PU execution (incl. DMA setup)
ST_DMA = 4      # span [t_comp, io_done]: AXI/egress DMA drain
ST_EQ = 5       # instant at EQ completion/kill
ST_SWITCH = 6   # span [fabric inject, delivery]: VOQ wait + crossbar
#                 serialization + propagation (fleet plane)
STAGES = ("ARRIVE", "FMQ_ENQ", "SCHED_GRANT", "PU_EXEC", "DMA",
          "EQ_COMPLETE", "SWITCH")

# span dispositions (``disp`` column)
D_OPEN = 0      # flushed while still open (end of run)
D_OK = 1
D_MARK = 2      # admitted but ECN-marked (ARRIVE rows only)
D_DROP = 3      # FMQ overflow drop
D_REJECT = 4    # admission-gate / backpressure reject
D_KILL = 5      # watchdog or total-budget kill
DISPOSITIONS = ("OPEN", "OK", "ECN_MARK", "DROP", "REJECT", "KILL")
TERMINAL_DISPOSITIONS = (D_DROP, D_REJECT, D_KILL)

# maps the batched arrival classifier's ``kind`` codes (0 ok / 1 mark /
# 2 drop) onto ARRIVE dispositions
DISP_FROM_KIND = np.array([D_OK, D_MARK, D_DROP], np.int8)

# decision kinds (decision ring ``kind`` column)
K_PU_WLBVT = 0
K_PU_RR = 1
K_AXI_DWRR = 2
K_EGRESS_DWRR = 3
K_ADMISSION = 4
K_SLO_ALERT = 5       # burn-rate SLO alert (telemetry/slo_audit.py)
K_QOS_INTERVENE = 6   # controller actuation: AIMD weight / admission flip
K_FLEET_MIGRATE = 7   # global QoS live migration (fleet/engine.py)
DECISION_KINDS = ("PU_WLBVT", "PU_RR", "AXI_DWRR", "EGRESS_DWRR",
                  "ADMISSION", "SLO_ALERT", "QOS_INTERVENE",
                  "FLEET_MIGRATE")

# reason codes (decision ring ``reason`` column)
R_PRIORITY = 0        # winner was the highest-priority/-weight eligible
R_DEBT = 1            # a lower-priority tenant won on lagging BVT/deficit
R_FORCED_SINGLE = 2   # exactly one eligible tenant — no real choice
R_ADMISSION_REJECT = 3
R_BURN_FAST = 4       # fast-window burn crossing (SLO_ALERT rows)
R_BURN_SLOW = 5       # slow-window burn crossing (SLO_ALERT rows)
R_AIMD_WEIGHT = 6     # QOS_INTERVENE: boost changed for the winner tenant
R_ADMISSION_GATE = 7  # QOS_INTERVENE: admission gate flipped
R_MIGRATION = 8       # FLEET_MIGRATE: SLO violation on an overloaded NIC
REASONS = ("PRIORITY", "DEBT", "FORCED_SINGLE", "ADMISSION_REJECT",
           "BURN_FAST", "BURN_SLOW", "AIMD_WEIGHT", "ADMISSION_GATE",
           "MIGRATION")

SPAN_RING_DEPTH = 65536
DECISION_RING_DEPTH = 8192

_SPAN_DTYPES = (
    ("uid", np.int64), ("tenant", np.int16), ("stage", np.int8),
    ("pu", np.int16), ("disp", np.int8), ("t0", np.float64),
    ("t1", np.float64),
)

# host spans (``host_rows()`` ``name`` column): an engine step, its
# phases, the executor's calls, their parts, an MoE layer's routing, a
# request's lifecycle
(H_STEP, H_CONTROL, H_ASSIGN, H_PREFILL, H_DECODE, H_ACCOUNT,
 H_EXE_RESET, H_EXE_PREFILL, H_EXE_DECODE,
 H_RESET_STAGE, H_RESET_LAUNCH,
 H_PREFILL_STAGE, H_PREFILL_LAUNCH, H_PREFILL_READBACK,
 H_DECODE_STAGE, H_DECODE_LAUNCH, H_DECODE_READBACK, H_MOE_ROUTE,
 H_REQ_QUEUE, H_REQ_PREFILL, H_REQ_DECODE) = range(21)
HOST_SPANS = (
    "engine.step", "engine.control", "engine.assign", "engine.prefill",
    "engine.decode", "engine.account",
    "executor.reset", "executor.prefill", "executor.decode",
    "reset.stage", "reset.launch",
    "prefill.stage", "prefill.launch", "prefill.readback",
    "decode.stage", "decode.launch", "decode.readback", "moe.route",
    "request.queue", "request.prefill", "request.decode")

# an executor call's MoE routing counts (``moe_rows()``): the call's
# span id, then the counts ``models.moe.counting()`` sums
MOE_COLUMNS = ("call", "routed", "experts_hit", "expert_rows_max",
               "dropped")

_HOST_DTYPES = (
    ("name", np.int8), ("id", np.int64), ("parent", np.int64),
    ("uid", np.int64), ("tenant", np.int16), ("disp", np.int8),
    ("t0_ns", np.int64), ("t1_ns", np.int64), ("valid", np.int64),
    ("computed", np.int64),
)
_HOST_NCOLS = len(_HOST_DTYPES)

# the recorder of the engine step in progress in this thread
# (``Engine.step()`` binds it); an executor called outside a step finds
# None and records nothing
_step = threading.local()


def bind(tr: Optional["TraceRecorder"]) -> None:
    """Make ``tr`` (or nothing) the recorder :func:`bound` returns in
    this thread."""
    _step.recorder = tr


def bound() -> Optional["TraceRecorder"]:
    """The recorder of this thread's engine step in progress, or None."""
    return getattr(_step, "recorder", None)


# --------------------------------------------------------------------------
# pure ring kernel
# --------------------------------------------------------------------------

def ring_scatter(ring, count, vals):
    """Write ``vals`` (m <= capacity rows) into ``ring`` at positions
    ``(count + arange(m)) % capacity``, in place.

    Fixed-shape for a fixed ``m``: index arithmetic only, no
    data-dependent producers.
    """
    cap = ring.shape[0]
    m = vals.shape[0]
    idx = (count + np.arange(m)) % cap
    ring[idx] = vals
    return ring


# --------------------------------------------------------------------------
# recorder
# --------------------------------------------------------------------------

class TraceRecorder:
    """Bounded SoA flight recorder for spans + scheduler decisions."""

    def __init__(self, num_tenants: int, *, num_pus: int = 0,
                 depth: int = SPAN_RING_DEPTH,
                 decision_depth: int = DECISION_RING_DEPTH):
        self.T = int(num_tenants)
        self.P = int(num_pus)
        self.depth = int(depth)
        self.decision_depth = int(decision_depth)
        d = self.depth
        self.spans: Dict[str, np.ndarray] = {
            name: (np.full(d, -1, dt) if name in ("uid", "pu")
                   else np.zeros(d, dt))
            for name, dt in _SPAN_DTYPES
        }
        dd = self.decision_depth
        self.decisions: Dict[str, np.ndarray] = {
            "time": np.zeros(dd, np.float64),
            "kind": np.zeros(dd, np.int8),
            "winner": np.full(dd, -1, np.int32),
            "reason": np.zeros(dd, np.int8),
            "n_elig": np.zeros(dd, np.int32),
            "metric": np.zeros(dd, np.float64),
            "snapshot": np.zeros((dd, self.T), np.float32),
            "elig": np.zeros((dd, self.T), bool),
        }
        self.span_count = 0      # rows ever written (monotone; evicted
        self.decision_count = 0  # rows are still counted)
        self._open: Dict[Tuple[int, int], Tuple[int, float]] = {}
        self._reset_span_stage()
        self._reset_decision_stage()
        # host spans: a ring of the same depth, allocated at the first
        # commit that has host rows (the simulators record none)
        self.host: Optional[Dict[str, np.ndarray]] = None
        self.host_count = 0
        self._host_next_id = 0
        # open step / call spans, innermost last:
        # (name, id, parent, valid, computed, t0_ns)
        self._host_stack: List[tuple] = []
        # each request's open lifecycle span: uid -> (name, tenant, t0_ns)
        self._host_req: Dict[int, Tuple[int, int, int]] = {}
        # the newest ``depth`` executor calls' MoE counts, oldest first
        self._moe: Deque[Tuple[int, ...]] = deque(maxlen=self.depth)
        self._reset_host_stage()
        # staged-row watermark for maybe_commit(): large enough to
        # amortize the fixed numpy cost of a batched expansion over
        # tens of thousands of rows, small enough to bound staging
        # memory (a staged row is a few dozen bytes)
        self._commit_every = max(1024, min(self.depth, 32768))

    def _reset_span_stage(self) -> None:
        # Flat staging buffers; fresh objects (not in-place clears) so
        # numpy views taken by commit never pin a buffer we resize.
        # Each kind also stages the ring-row offset of its rows
        # (``*_pos``); ``_srows`` is the running staged-row total.
        self._sp_plain = array("d")      # 7 values per plain row
        self._sp_plain_pos = array("q")
        self._sp_pk = array("d")         # 8 values per packet record
        self._sp_pk_pos = array("q")
        self._sp_blocks: List[Dict[str, np.ndarray]] = []
        self._sp_blk_pos = array("q")
        self._srows = 0

    def _reset_decision_stage(self) -> None:
        # one (now, kind, num_pus, n_picks) quad per WLBVT round — a
        # single flat f64 buffer so staging is one C-level extend
        self._wl_meta = array("d")
        self._wl_pos = array("q")
        self._wl_picks = array("q")      # ... flattened picks
        self._wl_snap = bytearray()      # ... concatenated raw arrays
        self._wl_caps: List[Tuple[int, bytes]] = []
        self._rr_rows: List[tuple] = []
        self._rr_pos = array("q")
        self._dw_rows: List[tuple] = []
        self._dw_pos = array("q")
        self._d_plain: List[tuple] = []
        self._d_plain_pos = array("q")
        self._drows = 0

    def _reset_host_stage(self) -> None:
        self._hs = array("q")            # _HOST_NCOLS values per row
        self._hrows = 0

    # -- host spans (wall clock) -------------------------------------------

    def _host_row(self, name: int, hid: int, parent: int, uid: int,
                  tenant: int, disp: int, t0_ns: int, t1_ns: int,
                  valid: int, computed: int) -> None:
        self._hs.extend((name, hid, parent, uid, tenant, disp, t0_ns,
                         t1_ns, valid, computed))
        self._hrows += 1

    def _host_push(self, name: int, valid: int, computed: int,
                   t0_ns: int) -> None:
        st = self._host_stack
        hid = self._host_next_id
        self._host_next_id += 1
        st.append((name, hid, st[-1][1] if st else -1, valid, computed,
                   t0_ns))

    def _host_pop(self, t1_ns: int) -> None:
        name, hid, parent, valid, computed, t0_ns = self._host_stack.pop()
        self._host_row(name, hid, parent, -1, -1, D_OK, t0_ns, t1_ns,
                       valid, computed)

    def host_root(self, name: int) -> None:
        """Open a span with no parent (a step's)."""
        self._host_push(name, 0, 0, now_ns())

    def host_unwind(self) -> None:
        """Drop the step and call spans still open: a step that raised
        records none of them."""
        self._host_stack.clear()

    def host_begin(self, name: int, valid: int = 0,
                   computed: int = 0) -> None:
        """Open a span inside the innermost open one; ``valid`` /
        ``computed`` are the rows of work it carries."""
        self._host_push(name, valid, computed, now_ns())

    def host_next(self, name: int) -> None:
        """Close the innermost span and open its sibling ``name`` at the
        same instant (phases that tile their parent)."""
        t_ns = now_ns()
        self._host_pop(t_ns)
        self._host_push(name, 0, 0, t_ns)

    def host_end(self) -> int:
        """Close the innermost span; returns its end, ns."""
        t_ns = now_ns()
        self._host_pop(t_ns)
        return t_ns

    def host_request(self, uid: int, tenant: int, name: int,
                     t_ns: int) -> None:
        """Move request ``uid`` into lifecycle span ``name`` at ``t_ns``,
        closing the span it was in (a request's spans tile its life)."""
        self.host_request_end(uid, t_ns)
        self._host_req[uid] = (name, tenant, t_ns)

    def host_request_end(self, uid: int, t_ns: int,
                         disp: int = D_OK) -> None:
        """Close request ``uid``'s open lifecycle span, if any, with
        ``disp`` (OK, or REJECT / KILL on a terminal path)."""
        got = self._host_req.pop(uid, None)
        if got is not None:
            name, tenant, t0_ns = got
            hid = self._host_next_id
            self._host_next_id += 1
            self._host_row(name, hid, -1, uid, tenant, disp, t0_ns, t_ns,
                           0, 0)

    def moe_counts(self, counts) -> None:
        """Record an executor call's MoE routing counts (``COUNTERS``'
        order), under the innermost open span: the call's."""
        st = self._host_stack
        self._moe.append((st[-1][1] if st else -1,
                          *(int(c) for c in counts)))

    def moe_rows(self) -> Dict[str, np.ndarray]:
        """The recorded MoE counts, one row a call, in record order."""
        a = np.array(self._moe, np.int64).reshape(-1, len(MOE_COLUMNS))
        return {k: a[:, j] for j, k in enumerate(MOE_COLUMNS)}

    def host_rows(self) -> Dict[str, np.ndarray]:
        """Retained host spans in write (close) order, ``name`` as its
        string; then each request's open span, disposition OPEN, ending
        at this read-out (it stays open)."""
        self.commit()
        if self.host is None:
            cols = {k: np.zeros(0, dt) for k, dt in _HOST_DTYPES}
        else:
            order = self._order(self.host_count, self.depth)
            cols = {k: v[order] for k, v in self.host.items()}
        if self._host_req:
            t_ns = now_ns()
            open_ = np.array(
                [(name, -1, -1, uid, tenant, D_OPEN, t0_ns, t_ns, 0, 0)
                 for uid, (name, tenant, t0_ns)
                 in sorted(self._host_req.items())], np.int64)
            cols = {k: np.concatenate([cols[k], open_[:, j].astype(dt)])
                    for j, (k, dt) in enumerate(_HOST_DTYPES)}
        cols["name"] = np.asarray(HOST_SPANS)[cols["name"].astype(np.int64)]
        return cols

    def _scatter_host(self) -> None:
        vals = np.frombuffer(self._hs, np.int64).reshape(-1, _HOST_NCOLS)
        m = len(vals)
        cap = self.depth
        if self.host is None:
            self.host = {k: np.zeros(cap, dt) for k, dt in _HOST_DTYPES}
        start = self.host_count
        if m > cap:
            start += m - cap
            vals = vals[m - cap:]
        for j, (k, dt) in enumerate(_HOST_DTYPES):
            ring_scatter(self.host[k], start, vals[:, j].astype(dt))
        self.host_count += m

    # -- span recording ----------------------------------------------------

    def span(self, stage: int, uid: int, tenant: int, t0: float,
             t1: float, disp: int = D_OK, pu: int = -1) -> None:
        """Record one complete lifecycle row."""
        self._sp_plain.extend((uid, tenant, stage, pu, disp, t0, t1))
        self._sp_plain_pos.append(self._srows)
        self._srows += 1

    def span_begin(self, stage: int, uid: int, tenant: int,
                   t0: float) -> None:
        """Open a span; it enters the ring only when closed (or
        abandoned / flushed) so eviction never splits a pair."""
        self._open[(stage, uid)] = (tenant, t0)

    def span_end(self, stage: int, uid: int, t1: float,
                 disp: int = D_OK, pu: int = -1) -> None:
        tenant, t0 = self._open.pop((stage, uid))
        self.span(stage, uid, tenant, t0, t1, disp, pu)

    def span_abandon(self, stage: int, uid: int, t1: float,
                     disp: int) -> None:
        """Close an open span on a terminal path (DROP/REJECT/KILL)."""
        tenant, t0 = self._open.pop((stage, uid))
        self.span(stage, uid, tenant, t0, t1, disp)

    def flush_open(self, t: float) -> None:
        """Write every still-open span with disposition OPEN (end of
        run: packets still queued when the horizon hit)."""
        ordered = sorted(self._open.items(),
                         key=lambda kv: (kv[1][1], kv[0][1], kv[0][0]))
        for (stage, uid), (tenant, t0) in ordered:
            self.span(stage, uid, tenant, t0, t, D_OPEN)
        self._open.clear()

    def span_packet(self, uid: int, tenant: int, pu: int, disp: int,
                    adisp: int, t_arr: float, t_grant: float,
                    t_comp: float, t_done: float) -> None:
        """One append covering a granted packet's whole lifecycle.

        Commit expands it to the ARRIVE instant (disposition
        ``adisp``: the admission outcome, OK or ECN_MARK), FMQ
        [arr, grant], GRANT instant, PU [grant, comp], DMA
        [comp, done] (only when ``t_done > t_comp``) and EQ instant
        rows, in that order.  Packets that never reach a PU (drops /
        rejects / still queued at flush) record their rows through
        :meth:`span` instead.  This is the simulators' hot completion
        path — keep it one flat append.
        """
        self._sp_pk.extend((uid, tenant, pu, disp, adisp, t_arr,
                            t_grant, t_comp, t_done))
        self._sp_pk_pos.append(self._srows)
        self._srows += 6 if t_done > t_comp else 5

    def span_block(self, stage: int, uids, tenants, t0s, t1s, disps,
                   pus=None) -> None:
        """Vectorized row block (batched-arrival fast paths)."""
        uids = np.asarray(uids, np.int64)
        m = len(uids)
        cols = {
            "uid": uids,
            "tenant": np.asarray(tenants, np.int16),
            "stage": np.full(m, stage, np.int8),
            "pu": (np.full(m, -1, np.int16) if pus is None
                   else np.asarray(pus, np.int16)),
            "disp": (np.full(m, disps, np.int8) if np.isscalar(disps)
                     else np.asarray(disps, np.int8)),
            "t0": np.asarray(t0s, np.float64),
            "t1": np.asarray(t1s, np.float64),
        }
        self._sp_blocks.append(cols)
        self._sp_blk_pos.append(self._srows)
        self._srows += m

    # -- decision recording ------------------------------------------------

    def decision(self, time: float, kind: int, winner: int, reason: int,
                 n_elig: int, metric: float = 0.0, snapshot=None,
                 elig=None) -> None:
        snap = (np.zeros(self.T, np.float32) if snapshot is None
                else np.array(snapshot, np.float32))
        el = (np.zeros(self.T, bool) if elig is None
              else np.array(elig, bool))
        self._d_plain.append((float(time), int(kind), int(winner),
                              int(reason), int(n_elig), float(metric),
                              snap, el))
        self._d_plain_pos.append(self._drows)
        self._drows += 1

    # -- commit / readout --------------------------------------------------

    def maybe_commit(self) -> None:
        """Commit only once enough rows are staged to amortize the
        batched expansion — the engines call this per telemetry window
        / step; nothing reads the rings mid-run (``rows()`` and friends
        force a commit), so the cadence is purely a cost knob."""
        if self._srows + self._drows + self._hrows >= self._commit_every:
            self.commit()

    def commit(self) -> None:
        """Scatter staged rows into the rings.

        Each staging kind is expanded with one batched numpy
        computation, merged into staging order via the offsets noted
        at stage time, and scattered with one :func:`ring_scatter` per
        column — commit cost is O(columns) per kind, not O(events).
        """
        if self._srows:
            self._scatter_spans(self._merge_spans())
            self._reset_span_stage()
        if self._drows:
            self._scatter_decisions(self._merge_decisions())
            self._reset_decision_stage()
        if self._hrows:
            self._scatter_host()
            self._reset_host_stage()

    @staticmethod
    def _seg_dest(offs: np.ndarray, cnt: np.ndarray) -> np.ndarray:
        """Destination indices for entries whose rows start at ``offs``
        and run for ``cnt`` rows each (segmented arange)."""
        tot = int(cnt.sum())
        return (np.repeat(offs, cnt) + np.arange(tot)
                - np.repeat(np.cumsum(cnt) - cnt, cnt))

    def _merge_spans(self) -> Dict[str, np.ndarray]:
        """Expand the span staging buffers — plain rows, packet records
        and column blocks interleave freely — into one column set in
        staging order (one batched expansion per staging kind, then a
        single ring scatter)."""
        out = {name: np.empty(self._srows, dt)
               for name, dt in _SPAN_DTYPES}
        if self._sp_plain_pos:
            a = np.frombuffer(self._sp_plain, np.float64).reshape(-1, 7)
            pos = np.frombuffer(self._sp_plain_pos, np.int64)
            for j, (name, dt) in enumerate(_SPAN_DTYPES):
                out[name][pos] = a[:, j].astype(dt, copy=False)
        if self._sp_pk_pos:
            pk = np.frombuffer(self._sp_pk, np.float64).reshape(-1, 9)
            cnt = np.where(pk[:, 8] > pk[:, 7], 6, 5)
            dest = self._seg_dest(
                np.frombuffer(self._sp_pk_pos, np.int64), cnt)
            for k, v in self._expand_pkts(pk).items():
                out[k][dest] = v
        if self._sp_blocks:
            blocks = self._sp_blocks
            cnt = np.asarray([len(b["uid"]) for b in blocks], np.int64)
            dest = self._seg_dest(
                np.frombuffer(self._sp_blk_pos, np.int64), cnt)
            for k in out:
                out[k][dest] = np.concatenate([b[k] for b in blocks])
        return out

    @staticmethod
    def _expand_pkts(a: np.ndarray) -> Dict[str, np.ndarray]:
        """Expand ``span_packet`` records — already stacked as a
        float64 ``(n, 9)`` array — into per-stage rows, grouped per
        packet so ring eviction keeps lifecycles contiguous."""
        n = len(a)
        uid = a[:, 0].astype(np.int64)
        ten = a[:, 1].astype(np.int16)
        pu = a[:, 2].astype(np.int16)
        disp = a[:, 3].astype(np.int8)
        adisp = a[:, 4].astype(np.int8)
        ta, tg, tc, td = a[:, 5], a[:, 6], a[:, 7], a[:, 8]
        K = 6
        stages = np.array([ST_ARRIVE, ST_FMQ, ST_GRANT, ST_PU, ST_DMA,
                           ST_EQ], np.int8)
        t0s = np.stack([ta, ta, tg, tg, tc, td], 1)
        t1s = np.stack([ta, tg, tg, tc, td, td], 1)
        dmat = np.empty((n, K), np.int8)
        dmat[:, 0] = adisp
        dmat[:, 1] = D_OK
        dmat[:, 2] = D_OK
        dmat[:, 3] = disp
        dmat[:, 4] = D_OK
        dmat[:, 5] = disp
        pmat = np.empty((n, K), np.int16)
        pmat[:, 0] = -1              # ARRIVE predates the grant
        pmat[:, 1:] = pu[:, None]
        keep = np.ones((n, K), bool)
        keep[:, 4] = td > tc  # zero-width DMA (kills): no row
        flat = keep.ravel()
        return {
            "uid": np.repeat(uid, K)[flat],
            "tenant": np.repeat(ten, K)[flat],
            "stage": np.tile(stages, n)[flat],
            "pu": pmat.ravel()[flat],
            "disp": dmat.ravel()[flat],
            "t0": t0s.ravel()[flat],
            "t1": t1s.ravel()[flat],
        }

    def _merge_decisions(self) -> Dict[str, np.ndarray]:
        """Expand the decision staging buffers — WLBVT rounds, RR
        picks, DWRR grants and plain rows interleave freely — into one
        column set in staging order."""
        total = self._drows
        out = {
            "time": np.empty(total, np.float64),
            "kind": np.empty(total, np.int8),
            "winner": np.empty(total, np.int32),
            "reason": np.empty(total, np.int8),
            "n_elig": np.empty(total, np.int32),
            "metric": np.empty(total, np.float64),
            "snapshot": np.empty((total, self.T), np.float32),
            "elig": np.empty((total, self.T), bool),
        }
        if self._wl_meta:
            meta = np.frombuffer(self._wl_meta,
                                 np.float64).reshape(-1, 4)
            dest = self._seg_dest(
                np.frombuffer(self._wl_pos, np.int64),
                meta[:, 3].astype(np.int64))
            for k, v in self._expand_wlbvt().items():
                out[k][dest] = v
        for rows, pos, expand in (
                (self._rr_rows, self._rr_pos, self._expand_rr),
                (self._dw_rows, self._dw_pos, self._expand_dwrr),
                (self._d_plain, self._d_plain_pos,
                 self._drows_to_cols)):
            if rows:
                dest = np.frombuffer(pos, np.int64)
                for k, v in expand(rows).items():
                    out[k][dest] = v
        return out

    @staticmethod
    def _drows_to_cols(buf: List[tuple]) -> Dict[str, np.ndarray]:
        time, kind, winner, reason, n_elig, metric, snap, el = zip(*buf)
        return {
            "time": np.asarray(time, np.float64),
            "kind": np.asarray(kind, np.int8),
            "winner": np.asarray(winner, np.int32),
            "reason": np.asarray(reason, np.int8),
            "n_elig": np.asarray(n_elig, np.int32),
            "metric": np.asarray(metric, np.float64),
            "snapshot": np.stack(snap),
            "elig": np.stack(el),
        }

    def _expand_wlbvt(self) -> Dict[str, np.ndarray]:
        """Replay the staged WLBVT rounds from post-round snapshots.

        Each round stages its picks plus the *post*-round scheduler
        arrays as raw bytes.  ``select_k`` charges exactly one
        ``queue_len -= 1`` / ``cur_occup += 1`` per pick, so the
        pre-round and per-pick states are reconstructed from a
        segmented exclusive cumsum of one-hot picks; eligibility,
        reason codes and metrics are then derived for every pick of
        every round in one batched computation (``total_occup``/
        ``bvt``/``prio`` do not change within a round).
        """
        T = self.T
        meta = np.frombuffer(self._wl_meta, np.float64).reshape(-1, 4)
        times, npus = meta[:, 0], meta[:, 2]
        kinds = meta[:, 1].astype(np.int8)
        lens = meta[:, 3].astype(np.int64)
        R = len(lens)
        ints = np.frombuffer(self._wl_snap, np.int64).reshape(R, 5, T)
        flts = np.frombuffer(self._wl_snap,
                             np.float64).reshape(R, 5, T)
        ql_post, co_post = ints[:, 0], ints[:, 1]
        bvt, occ, prio = flts[:, 2], flts[:, 3], flts[:, 4]
        picks = np.frombuffer(self._wl_picks, np.int64)
        N = len(picks)
        rid = np.repeat(np.arange(R), lens)
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        onehot = np.zeros((N, T), np.int64)
        onehot[np.arange(N), picks] = 1
        S = np.cumsum(onehot, axis=0)
        E = S - onehot                        # global exclusive cumsum
        C = E - E[starts][rid]                # charges earlier this round
        tot = S[starts + lens - 1] - E[starts]  # total charge per round
        QL = ql_post[rid] + tot[rid] - C      # state the pick saw
        CO = co_post[rid] - tot[rid] + C
        PR = prio[rid]
        # rowwise G.pu_limit
        psum = np.sum(np.where(QL > 0, PR, 0.0), axis=1, keepdims=True)
        lim = np.ceil(npus[rid][:, None] * PR / np.maximum(psum, 1e-9)
                      - G.CEIL_EPS)
        limit = np.where(psum > 0, lim, npus[rid][:, None])
        elig = (QL > 0) & (CO < limit)
        if self._wl_caps:
            caps = np.full((R, T), np.inf)
            for r, b in self._wl_caps:
                caps[r] = np.frombuffer(b, np.float64)
            elig &= CO < caps[rid]
        ne = elig.sum(axis=1)
        pw = PR[np.arange(N), picks]
        pmax = np.where(elig, PR, -np.inf).max(axis=1)
        reason = np.where(ne <= 1, R_FORCED_SINGLE,
                          np.where(pw >= pmax, R_PRIORITY,
                                   R_DEBT)).astype(np.int8)
        met = (G.tput(occ, bvt, np) / prio)[rid, picks]
        return {
            "time": times[rid],
            "kind": kinds[rid],
            "winner": picks.astype(np.int32),
            "reason": reason,
            "n_elig": ne.astype(np.int32),
            "metric": met,
            "snapshot": bvt[rid].astype(np.float32),
            "elig": elig,
        }

    def _expand_rr(self, entries: List[tuple]) -> Dict[str, np.ndarray]:
        T = self.T
        R = len(entries)
        ql = np.frombuffer(b"".join(e[3] for e in entries),
                           np.int64).reshape(R, T)
        snap = np.frombuffer(b"".join(e[4] for e in entries),
                             np.float64).reshape(R, T)
        pend = ql > 0
        ne = pend.sum(axis=1)
        return {
            "time": np.asarray([e[0] for e in entries], np.float64),
            "kind": np.asarray([e[1] for e in entries], np.int8),
            "winner": np.asarray([e[2] for e in entries], np.int32),
            "reason": np.where(ne <= 1, R_FORCED_SINGLE,
                               R_PRIORITY).astype(np.int8),
            "n_elig": ne.astype(np.int32),
            "metric": np.zeros(R, np.float64),
            "snapshot": snap.astype(np.float32),
            "elig": pend,
        }

    def _expand_dwrr(self, entries: List[tuple]) -> Dict[str, np.ndarray]:
        T = self.T
        R = len(entries)
        win = np.asarray([e[2] for e in entries], np.int64)
        defc = np.frombuffer(b"".join(e[3] for e in entries),
                             np.float64).reshape(R, T)
        w = np.frombuffer(b"".join(e[4] for e in entries),
                          np.float64).reshape(R, T)
        pend = np.frombuffer(b"".join(e[5] for e in entries),
                             np.bool_).reshape(R, T)
        ne = pend.sum(axis=1)
        ww = w[np.arange(R), win]
        wmax = np.where(pend, w, -np.inf).max(axis=1)
        reason = np.where(ne <= 1, R_FORCED_SINGLE,
                          np.where(ww >= wmax, R_PRIORITY,
                                   R_DEBT)).astype(np.int8)
        return {
            "time": np.asarray([e[0] for e in entries], np.float64),
            "kind": np.asarray([e[1] for e in entries], np.int8),
            "winner": win.astype(np.int32),
            "reason": reason,
            "n_elig": ne.astype(np.int32),
            "metric": defc[np.arange(R), win],
            "snapshot": defc.astype(np.float32),
            "elig": pend,
        }

    def _scatter_spans(self, cols: Dict[str, np.ndarray]) -> None:
        m = len(cols["uid"])
        if m == 0:
            return
        cap = self.depth
        start = self.span_count
        if m > cap:  # keep only the newest ``cap`` rows of the chunk
            start += m - cap
            cols = {k: v[m - cap:] for k, v in cols.items()}
        for k, ring in self.spans.items():
            ring_scatter(ring, start, cols[k])
        self.span_count += m

    def _scatter_decisions(self, cols: Dict[str, np.ndarray]) -> None:
        m = len(cols["time"])
        if m == 0:
            return
        cap = self.decision_depth
        start = self.decision_count
        if m > cap:
            start += m - cap
            cols = {k: v[m - cap:] for k, v in cols.items()}
        for k, ring in self.decisions.items():
            ring_scatter(ring, start, cols[k])
        self.decision_count += m

    def _order(self, count: int, cap: int) -> np.ndarray:
        if count <= cap:
            return np.arange(count)
        cut = count % cap
        return np.concatenate([np.arange(cut, cap), np.arange(cut)])

    def rows(self) -> Dict[str, np.ndarray]:
        """Retained span rows in write (chronological) order."""
        self.commit()
        order = self._order(self.span_count, self.depth)
        return {k: v[order] for k, v in self.spans.items()}

    def tail(self, n: int) -> Dict[str, np.ndarray]:
        """The newest ``n`` retained span rows (write order)."""
        r = self.rows()
        m = len(r["uid"])
        k = max(0, min(int(n), m))
        return {c: v[m - k:] for c, v in r.items()}

    def decision_rows(self) -> Dict[str, np.ndarray]:
        """Retained decision rows in write order."""
        self.commit()
        order = self._order(self.decision_count, self.decision_depth)
        return {k: v[order] for k, v in self.decisions.items()}

    # -- summaries ---------------------------------------------------------
    # keys of the trace_summary() extras block — RunReport.validate()
    # checks the exported schema against this tuple
    TRACE_SUMMARY_KEYS = (
        "spans_recorded", "spans_retained", "span_depth",
        "decisions_recorded", "decisions_retained", "decision_depth",
        "open_spans", "stage_time_share", "decision_reasons",
        "decision_kinds")

    def trace_summary(self) -> dict:
        """RunReport ``extras`` block: volumes, per-tenant stage time
        shares, decision reason/kind histograms."""
        r = self.rows()
        d = self.decision_rows()
        dur = r["t1"] - r["t0"]
        shares: Dict[int, Dict[str, float]] = {}
        for t in np.unique(r["tenant"]).tolist():
            mt = r["tenant"] == t
            tot = float(dur[mt].sum())
            row = {}
            for s in (ST_FMQ, ST_PU, ST_DMA):
                v = float(dur[mt & (r["stage"] == s)].sum())
                row[STAGES[s]] = round(v / tot, 6) if tot > 0 else 0.0
            shares[int(t)] = row
        reasons = {}
        for i, name in enumerate(REASONS):
            c = int(np.count_nonzero(d["reason"] == i))
            if c:
                reasons[name] = c
        kinds = {}
        for i, name in enumerate(DECISION_KINDS):
            c = int(np.count_nonzero(d["kind"] == i))
            if c:
                kinds[name] = c
        return {
            "spans_recorded": int(self.span_count),
            "spans_retained": int(len(r["uid"])),
            "span_depth": self.depth,
            "decisions_recorded": int(self.decision_count),
            "decisions_retained": int(len(d["time"])),
            "decision_depth": self.decision_depth,
            "open_spans": len(self._open),
            "stage_time_share": shares,
            "decision_reasons": reasons,
            "decision_kinds": kinds,
        }


# --------------------------------------------------------------------------
# provenance replay helpers (never touch live scheduler state)
# --------------------------------------------------------------------------

def record_wlbvt_round(tr: TraceRecorder, now: float, st, picks,
                       num_pus: int, kind: int, cap=None) -> None:
    """Stage one WLBVT round's provenance from *post*-round state.

    Called after ``select_k`` with the live (already-charged)
    ``WLBVTState`` — no copies.  The picks are exactly the charge the
    scheduler applied, so :meth:`TraceRecorder._expand_wlbvt`
    reconstructs the pre-round and per-pick states at commit time.
    ``st``'s dtypes are the WLBVTState contract (queue_len/cur_occup
    int64, bvt/total_occup/prio float64) — the byte snapshot relies
    on it.
    """
    n = len(picks)
    if not n:
        return
    tr._wl_meta.extend((now, kind, num_pus, n))
    tr._wl_picks.extend(picks)
    snap = tr._wl_snap
    snap += st.queue_len.tobytes()
    snap += st.cur_occup.tobytes()
    snap += st.bvt.tobytes()
    snap += st.total_occup.tobytes()
    snap += st.prio.tobytes()
    if cap is not None:
        tr._wl_caps.append((len(tr._wl_meta) // 4 - 1,
                            np.asarray(cap, np.float64).tobytes()))
    tr._wl_pos.append(tr._drows)
    tr._drows += n


def record_rr_pick(tr: TraceRecorder, now: float, kind: int, winner: int,
                   queue_len, snapshot) -> None:
    """One round-robin grant: called before the caller charges
    ``queue_len`` so the eligible set is the pre-grant one."""
    tr._rr_rows.append((
        float(now), int(kind), int(winner),
        np.ascontiguousarray(queue_len, np.int64).tobytes(),
        np.ascontiguousarray(snapshot, np.float64).tobytes()))
    tr._rr_pos.append(tr._drows)
    tr._drows += 1


def record_dwrr_grant(tr: TraceRecorder, now: float, kind: int,
                      winner: int, deficit, pending, weights) -> None:
    """One DWRR grant; ``deficit`` is the pre-grant deficit snapshot
    (the scheduler mutates it in place, so the caller copies it)."""
    tr._dw_rows.append((
        float(now), int(kind), int(winner),
        np.ascontiguousarray(deficit, np.float64).tobytes(),
        np.ascontiguousarray(weights, np.float64).tobytes(),
        np.ascontiguousarray(pending, bool).tobytes()))
    tr._dw_pos.append(tr._drows)
    tr._drows += 1


def record_dwrr_round(tr: TraceRecorder, now: float, kind: int, picks,
                      deficit, counts, weights) -> None:
    """Replay a multi-grant DWRR round (serving prefill arbitration).

    ``deficit``/``counts`` are pre-round copies; the pending set is
    replayed per pick, the deficit snapshot is round-granularity.
    """
    counts = np.asarray(counts).copy()
    for i in picks:
        if i < 0:
            break
        record_dwrr_grant(tr, now, kind, int(i), deficit, counts > 0,
                          weights)
        counts[i] -= 1


def record_admission_reject(tr: TraceRecorder, now: float,
                            tenant: int) -> None:
    tr.decision(now, K_ADMISSION, int(tenant), R_ADMISSION_REJECT, 0,
                0.0)


def record_slo_alert(tr: TraceRecorder, now: float, tenant: int,
                     window: str, burn_rate: float) -> None:
    """SLO burn-rate alert row: Perfetto renders it on the Scheduler
    track next to the QOS_INTERVENE rows it precedes, making the
    alert -> intervention causality visible; ``metric`` carries the
    burn rate."""
    tr.decision(now, K_SLO_ALERT, int(tenant),
                R_BURN_FAST if window == "fast" else R_BURN_SLOW, 0,
                float(burn_rate))


def record_qos_intervention(tr: TraceRecorder, now: float, tenant: int,
                            kind: str, value: float) -> None:
    """Controller actuation row (``kind``: the slo_audit intervention
    kinds — aimd_weight / admission); ``metric`` carries the new boost
    or gate value."""
    tr.decision(now, K_QOS_INTERVENE, int(tenant),
                R_AIMD_WEIGHT if kind == "aimd_weight" else R_ADMISSION_GATE,
                0, float(value))
