"""Device-resident sim datapath: the event loop as one fixed-length loop of
tensor steps over an explicit ``[R, ...]`` replica axis (DESIGN.md §13).

This module runs the *whole* inner loop of the PsPIN simulator —
arrival ingestion, FMQ push with ECN mark-before-drop, WLBVT/RR dispatch,
budget-clamp kills, completion bookkeeping, occupancy/BVT folds, EQ
emission — as ``S`` steps over every replica of a ``SweepSpec`` at once,
on the card by default.  Each WLBVT dispatch of each step launches the
hand-written CUDA kernel ``kernels/csrc/wlbvt_select.cu`` (through
``kernels.ops.wlbvt_select_rounds``); the rest of a step is PyTorch
ops on the replica tensors, updated in place.  A step has ~126 small
kernels and no host sync, so on the card blocks of ``GRAPH_STEPS`` steps
are captured once as a CUDA graph and replayed.

Event model (per replica, fixed shapes): the heap of the host loop
degenerates, on the compute-only contract below, to a two-way merge of
the (pre-sorted) arrival array against the PU slot table's min
finish-time.  Arrival seqs are assigned at inject (0..n-1) and
completion seqs start at n, so an arrival always precedes a completion
at equal time and completion ties resolve by lower seq — exactly the
host heap's ``(time, seq)`` order.  Each step consumes at most one
event; dead steps (replica drained or past horizon) are masked no-ops,
so ragged replicas ride the same grid.  A step reads nothing back to the
host: the step count is fixed up front and the per-step records go into
preallocated ``[S, R]`` tensors, copied to the host once after the loop.

Device contract — ``device_eligible`` returns the reason a spec needs
the host path: compute-only workloads (``io_kind == "none"``; the
DWRR/AXI/egress machinery never engages), no QoS controller (windows
then carry no decisions, only telemetry flushes), wlbvt/rr scheduling,
no timeline/trace capture.  Inside the contract the device path is
decision/EQ/telemetry **bit-identical** to the JAX package's host
``BatchedSimulator`` under ``precision="exact"`` (float64, which the
H100 has natively); the only documented drift is the Jain time-average,
whose host fold compresses the active set before summing (DESIGN.md
§8).  Every sum over tenants takes ``core.sched_generic.lane_sum``'s
fixed order, so a card run and a CPU run of this module agree field for
field.  ``precision="fast"`` trades float64 for float32 lanes and
downgrades the parity claim to statistical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.osmosis_pspin import PSPIN
from repro_torch.core import sched_generic as G
from repro_torch.core.events import Event, EventKind
from repro_torch.kernels import ops
from repro_torch.serving.serve_step import require_device

EQ_RING_CAPACITY = 4096   # host EQHub shared-queue retention
# a step's ~126 kernels are each shorter than their launch from Python,
# so on the card blocks of GRAPH_STEPS steps are CUDA-graph replays
# (PERF.md: 3.0 -> 0.23 ms per step of the 256-replica mix on an NVIDIA
# H100 80GB HBM3 at a 700 W power limit)
GRAPH_STEPS = 128
_WARM_STEPS = 2
PRECISIONS = {"exact": np.float64, "fast": np.float32}
_TORCH_FLOAT = {np.float64: torch.float64, np.float32: torch.float32}

# ys codes -> EQ event kinds (0 = no event this step)
_EQ_KINDS = {
    1: EventKind.ECN_MARK,
    2: EventKind.QUEUE_OVERFLOW,
    3: EventKind.CYCLE_BUDGET_EXCEEDED,
    4: EventKind.TOTAL_BUDGET_EXCEEDED,
}


class DevicePathError(ValueError):
    """Spec falls outside the device-path contract."""


def device_eligible(spec) -> Optional[str]:
    """None when ``spec`` fits the device contract, else the reason it
    must run on a host datapath."""
    if getattr(spec, "analytic", ""):
        return "analytic scenario (no datapath at all)"
    if getattr(spec, "num_nics", 0):
        return "fleet spec (switch fabric is host-only)"
    if spec.controller is not None:
        return "QoS controller (host-only control plane)"
    if spec.scheduler not in ("wlbvt", "rr"):
        return f"scheduler {spec.scheduler!r} (device supports wlbvt|rr)"
    if spec.record_timeline:
        return "record_timeline (host-only window capture)"
    for t in spec.tenants:
        wl = t.workload.build()
        if wl.io_kind != "none":
            return (f"tenant {t.name!r} io_kind {wl.io_kind!r} "
                    "(DWRR IO path is host-only)")
    return None


# ---------------------------------------------------------------------------
# the step (closed over static geometry; the loop root is _launch)
# ---------------------------------------------------------------------------
def _build_launch(T: int, P: int, C: int, S: int, scheduler: str,
                  impl: str, graph_steps: int = GRAPH_STEPS):
    """One launch per (tenants, PUs, ring, steps, sched, impl) geometry.
    Returns ``_launch(state, data) -> (state, ys)``, which runs ``S``
    steps and updates ``state`` in place.  On the card, after
    ``_WARM_STEPS`` eager steps, whole blocks of ``graph_steps`` steps are
    CUDA-graph replays (0: every step eager); the rest run eagerly.

    Single-grant theorem (what makes the step cheap): the host dispatch
    loop maintains the quiescence invariant "free_pus == 0 or nothing
    eligible" after every event.  An arrival adds exactly one packet (a
    new non-empty queue only *shrinks* other tenants' ``pu_limit``), a
    completion frees exactly one PU — so every event grants **at most
    one** PU under both wlbvt and rr, and the per-event dispatch is one
    ``wlbvt_select`` round with ``max_picks=1``, no loop.

    Slot arrays are sized ``P + 1``: index P is an inert pad (t_fin
    ``+inf``, seq sentinel) that masked writes aim at, so no gather-merge
    is needed on the no-op branch.  Likewise the FIFO ring is ``C + 1``
    wide with column C as the discard target.  Within a step every
    replica row writes one index of each array, so the in-place writes
    (``index_put_``, ``scatter_add_``) never collide.
    """
    dma_ns = PSPIN.cycles_ns(PSPIN.dma_setup_cycles)
    ns_per_cycle = PSPIN.ns_per_cycle
    wlbvt = scheduler == "wlbvt"
    i32, i64 = torch.int32, torch.int64
    PKT = (1 << 30) - 1                      # slot meta: pkt | kill<<30 |
    KILL = 1 << 30                           # budget-kill<<31

    def _pre(s, d, k):
        """Consume one event (or nothing): pick the earliest of the next
        arrival and the earliest slot finish, advance the BVT/Jain
        integrals to it, apply the event, emit the EQ/completion record.
        Everything the event reads (slot finish times, the completing
        slot's meta and start, the arrival's queue length and FIFO head)
        is read before the first in-place write."""
        eq_pack_k, t_k, comp_meta_k, comp_ktime_k = k["ys"]
        na = s["na"][:, None]
        ta = d["arr_t"].gather(1, na)[:, 0]
        tfin = s["s_tf"][:, :, 0]            # slot pairs: (t_fin, t0)
        tmin = torch.amin(tfin, dim=1)
        # completion candidate: lowest seq among the min-finish slots
        pc = torch.where(tfin == tmin[:, None], s["s_ps"][:, :, 1],
                         k["sent"]).argmin(dim=1, keepdim=True)
        is_arr = ta <= tmin                  # arrival seqs < completion seqs
        t_ev = torch.where(is_arr, ta, tmin)
        # horizon_live = min(horizon, largest finite): t_ev <= horizon
        # and t_ev < inf in one compare
        live = t_ev <= d["horizon_live"]
        t = torch.where(live, t_ev, s["now"], out=t_k)
        prio = d["prio"]
        # --- advance fold (Simulator._advance_to, pre-event state) ----
        # ``now`` doubles as the fold's last-advance time (the two are
        # always set together), so a dead step has dt = 0
        dt = (t - s["now"]).clamp_min_(0.0)
        ql = s["queue_len"]
        co = s["cur_occup"]
        act = (ql > 0) | (co > 0)
        occf = co.to(prio.dtype)
        # an inactive tenant has co == 0: its occupancy term is exactly 0
        s["total_occup"] += occf * dt[:, None]
        s["bvt"] += dt[:, None] * act
        x = occf / prio
        actn, s1, s2 = G.lane_sum(torch.stack([act.to(prio.dtype), x,
                                               x * x]))
        jain = torch.where(s2 > 0.0, s1 * s1 / (actn * s2), k["one"])
        two_act = actn >= 2.0
        s["jain_acc"] += jain * dt * two_act
        s["jain_t"] += dt * two_act
        # --- arrival branch (FMQ push: admit -> overflow -> ECN) ------
        ia = d["arr_tenant"].gather(1, na)
        qa = ql.gather(1, ia)
        head_a = s["fifo_head"].gather(1, ia)
        marr = (live & is_arr)[:, None]
        acc = marr & (qa < d["fifo_cap"])
        drop = marr ^ acc
        mark = acc & (qa >= d["ecn_m1"])     # qa + 1 >= ecn threshold
        # --- completion branch (tenant derived from the packet id) ----
        mcomp = live[:, None] ^ marr
        pk = s["s_ps"][:, :, 0].gather(1, pc)
        ic = d["arr_tenant"].gather(1, (pk & PKT).long())
        kflag = mcomp & ((pk & KILL) != 0)
        bkflag = mcomp & (pk < 0)
        # host op order: now - (t0 - dma_ns), NOT now - grant
        ktime = t[:, None] - (s["s_tf"][:, :, 1].gather(1, pc) - dma_ns)
        # --- apply (masked writes aim at the pad slot/column) ---------
        mc = mcomp.to(i32)
        ql.scatter_add_(1, ia, acc.to(i32))
        co.scatter_add_(1, ic, -mc)
        tail_w = torch.where(acc, torch.remainder(head_a + qa, C), k["C"])
        s["fifo_buf"].index_put_((k["ar"], ia[:, 0], tail_w[:, 0]),
                                 s["na"])
        # the freed slot keeps its stale seq: seqs are only consulted
        # among the tfin == tmin slots, and a freed slot sits at +inf
        # until the next grant overwrites both fields
        pc_w = torch.where(mcomp, pc, k["P"])
        tfin.scatter_(1, pc_w, float("inf"))
        s["free_pus"] += mc[:, 0]
        # --- per-step records (step order IS host heap-pop order, so
        # the completion stream needs no carried per-packet arrays; the
        # packed slot meta ships as-is, -1 = no completion) -------------
        torch.where(mcomp[:, 0], pk[:, 0], k["neg1"], out=comp_meta_k)
        torch.where(mcomp[:, 0], ktime[:, 0], k["zero"], out=comp_ktime_k)
        # --- EQ (at most one event per step; code | tenant<<3 packed):
        # 1 mark, 2 drop (arrivals), 3 kill, 4 budget kill (completions)
        code = torch.where(kflag, bkflag + 3, drop * 2 + mark)
        ten = torch.where(is_arr[:, None], ia, ic)
        eq_pack_k.copy_(((ten << 3) | code)[:, 0])
        s["na"] += marr[:, 0]
        s["now"].copy_(t)
        return t, torch.where(live, s["free_pus"], k["zero_i"])

    def _rr_pick(s, free_k, k):
        """Host `_dispatch` rr arm, single-grant form: the pointer only
        advances on an actual grant (host never probes with 0 free)."""
        ptr, ql, co = s["rr_ptr"], s["queue_len"], s["cur_occup"]
        idx, ptr1 = G.select_rr(ptr, ql, G.torch_namespace(ql.device))
        can = (idx >= 0) & (free_k > 0)
        hot = ((k["lane"] == idx[:, None]) & can[:, None]).to(i32)
        ql -= hot
        co += hot
        s["rr_ptr"] = torch.where(can, ptr1, ptr)
        return torch.where(can, idx, k["neg1_l"])

    def _apply_one(s, d, pick, t, k):
        """Host ``_pop_and_start`` for the (single) winner: FIFO pop,
        budget clamps (exact op order of the inlined BudgetLedger
        mirror), slot fill, ``(t_fin, seq)`` heap push."""
        won = (pick >= 0)[:, None]
        wi = won.to(i32)
        i = pick.clamp_min(0).long()[:, None]
        head_i = s["fifo_head"].gather(1, i)
        j = s["fifo_buf"][k["ar"], i[:, 0], torch.remainder(head_i[:, 0], C)]
        j = j[:, None]
        s["fifo_head"].scatter_add_(1, i, won.to(i64))
        comp = d["arr_comp"].gather(1, j)
        # per-tenant (klim, tlim); klim is +inf where there is no limit,
        # so ``comp > klim`` is the host's ``klim > 0 and comp > klim``
        klim = d["klim"].gather(1, i)
        kill1 = comp > klim
        comp = torch.where(kill1, klim, comp)
        tlim = d["tlim"].gather(1, i)
        remaining = tlim - s["spent"].gather(1, i)
        bk = (tlim > 0) & (comp > remaining)
        comp = torch.where(bk, remaining.clamp_min(0.0), comp)
        s["spent"].scatter_add_(1, i, comp * won)
        # any free slot (t_fin == +inf, the max; the pad P is the last):
        # the heap orders by (t_fin, seq), not by slot index
        slot = s["s_tf"][:, :, 0].argmax(dim=1, keepdim=True)
        sw = torch.where(won, slot, k["P"])[:, 0]
        t0v = t + dma_ns
        tfv = t0v + comp[:, 0] * ns_per_cycle
        j32 = j[:, 0].to(i32)
        meta = torch.where(bk[:, 0], j32 | k["kill_bk"],
                           torch.where(kill1[:, 0], j32 | KILL, j32))
        won = won[:, 0]
        s["s_tf"].index_put_((k["ar"], sw), torch.stack(
            [torch.where(won, tfv, k["inf"]), t0v], dim=-1))
        s["s_ps"].index_put_((k["ar"], sw), torch.stack(
            [meta, torch.where(won, s["seq"], k["sent"])], dim=-1))
        s["seq"] += wi[:, 0]
        s["free_pus"] -= wi[:, 0]

    def _step(s, d, k):
        t, free_k = _pre(s, d, k)
        if wlbvt:
            picks, ql2, co2 = ops.wlbvt_select_rounds(
                d["prio"], s["queue_len"], s["cur_occup"],
                s["total_occup"], s["bvt"], free_k, num_pus=P,
                max_picks=1, impl=impl)
            pick = picks[:, 0]
            s["queue_len"], s["cur_occup"] = ql2, co2
        else:
            pick = _rr_pick(s, free_k, k)
        _apply_one(s, d, pick, t, k)

    def _replay_blocks(state, data, k, ys, B, start, n_blocks):
        """Steps ``start ..`` in whole blocks of ``B``: one CUDA graph
        captures B steps once and is replayed, so the ~126 small kernels
        of a step are launched as one graph, not one by one from
        Python.  The graph reads and writes the state's own tensors: the
        entries a step replaces (kernel outputs) are copied back into
        them at the end of the block.  The per-step records go to a block
        buffer, copied into ``ys`` after each replay.  Launches are
        counted per replay: the kernels the capture recorded, once more
        for every replay (the capture itself runs nothing)."""
        blk = tuple(torch.empty((B,) + tuple(y.shape[1:]), dtype=y.dtype,
                                device=y.device) for y in ys)
        base = dict(state)
        before = dict(ops.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(B):
                k["ys"] = tuple(b[i] for b in blk)
                _step(state, data, k)
            for key, t in base.items():
                if state[key] is not t:
                    t.copy_(state[key])
        state.update(base)
        per_replay = {n: ops.LAUNCHES[n] - before[n] for n in before}
        ops.LAUNCHES.update(before)
        for s0 in range(start, start + n_blocks * B, B):
            graph.replay()
            for n, c in per_replay.items():
                ops.LAUNCHES[n] += c
            for y, b in zip(ys, blk):
                y[s0:s0 + B].copy_(b)

    def _launch(state, data):
        R = state["now"].shape[0]
        dev = state["now"].device
        fdt = state["now"].dtype

        def const(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        ys = (torch.empty((S, R), dtype=i32, device=dev),    # eq_pack
              torch.empty((S, R), dtype=fdt, device=dev),    # event time
              torch.empty((S, R), dtype=i32, device=dev),    # comp_meta
              torch.empty((S, R), dtype=fdt, device=dev))    # comp_ktime
        k = {"ar": torch.arange(R, device=dev),
             "lane": torch.arange(T, device=dev),
             "inf": const(float("inf"), fdt), "zero": const(0.0, fdt),
             "one": const(1.0, fdt), "zero_i": const(0, i32),
             "neg1": const(-1, i32), "neg1_l": const(-1, i64),
             "C": const(C, i64), "P": const(P, i64),
             "sent": const(int(np.iinfo(np.int32).max), i32),
             "kill_bk": const(-(1 << 30), i32)}   # bits 30 and 31
        done = 0

        def eager(n):
            nonlocal done
            for step in range(done, done + n):
                k["ys"] = tuple(y[step] for y in ys)
                _step(state, data, k)
            done += n

        # the first steps run eagerly: they also fill every lazily made
        # constant and load every kernel before a capture
        eager(min(S, _WARM_STEPS))
        B = graph_steps if dev.type == "cuda" else 0
        if B and S - done >= B:
            n_blocks = (S - done) // B
            _replay_blocks(state, data, k, ys, B, done, n_blocks)
            done += n_blocks * B
        eager(S - done)
        return state, ys

    return _launch


# ---------------------------------------------------------------------------
# host side: spec -> replica arrays -> launch -> results
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceRunResult:
    """Per-replica result with the host ``SimResult`` observables the
    device contract covers (stats are real ``TenantStats``; EQ events
    carry the host ring's last-4096 retention)."""
    spec: object
    time: float
    stats: Dict[int, "object"]
    jain_pu_timeavg: float
    jain_io_timeavg: float
    events: List[Event]
    events_dropped: int
    completions: List[Tuple[int, float]]
    counters: Dict[str, np.ndarray]
    sched_state: dict

    def throughput_gbps(self, tenant: int) -> float:
        st = self.stats[tenant]
        return st.served_payload_bytes * 8.0 / max(self.time, 1e-9)

    def summary_row(self, knobs: Optional[dict] = None) -> dict:
        """Flat JSON-portable sweep report row (RunReport-style)."""
        row = {
            "scenario": self.spec.name,
            "seed": self.spec.seed,
            "knobs": dict(knobs or {}),
            "time_ns": self.time,
            "jain_pu_timeavg": self.jain_pu_timeavg,
            "events": len(self.events),
            "tenants": [],
        }
        for i, t in enumerate(self.spec.tenants):
            st = self.stats[i]
            row["tenants"].append({
                "name": t.name,
                "completed": st.completed,
                "killed": st.killed,
                "drops": st.drops,
                "ecn_marks": int(self.counters["ecn_marks"][i]),
                "throughput_gbps": self.throughput_gbps(i),
                "p50_kernel_ns": st.kernel_time_percentile(50),
                "p99_kernel_ns": st.kernel_time_percentile(99),
            })
        return row


def _spec_arrays(spec, ftype) -> dict:
    """Replica-local host arrays for one spec (trace + per-tenant
    config), with the exact float ops ``BatchedSimulator._inject``
    applies (payload clamp, compute-cycles formula)."""
    from repro_torch.api.runtime import build_traces
    ta = build_traces(spec, arrays=True)
    tn = ta.tenants.astype(np.int64)
    sz = ta.sizes.astype(np.int64)
    payload = np.maximum(0, sz - PSPIN.header_bytes)
    wls = [t.workload.build() for t in spec.tenants]
    spin = np.array([w.spin_factor for w in wls])
    base = np.array([w.compute_base for w in wls])
    cpb = np.array([w.compute_per_byte for w in wls])
    comp = spin[tn] * (base[tn] + cpb[tn] * payload)
    cap = int(spec.fifo_capacity)
    thresh = max(1, (3 * cap) // 4)                          # FMQ default
    horizon = spec.horizon_us * 1e3 if spec.horizon_us else np.inf
    return {
        "n": len(ta),
        "n_live": int(np.sum(ta.times <= horizon)),
        "arr_t": ta.times.astype(np.float64),
        "arr_tenant": tn.astype(np.int32),
        "arr_size": sz.astype(ftype),
        "arr_payload": payload.astype(ftype),
        "arr_comp": comp.astype(ftype),
        "prio": np.array([t.priority for t in spec.tenants], ftype),
        "fifo_cap": np.int32(cap),
        "ecn_thresh": np.int32(thresh),
        "klim": np.array([float(t.kernel_cycle_limit)
                          for t in spec.tenants], ftype),
        "tlim": np.array([float(t.total_cycle_limit)
                          for t in spec.tenants], ftype),
        "horizon": ftype(horizon),
    }


def _stack_data(per_spec: List[dict], ftype, device) -> Tuple[dict, np.ndarray, int]:
    """Pad ragged replica arrays to a common grid; index NB is the inert
    sentinel row (arrival at +inf / zero-size packet).  Only what the
    step reads ships to the device — sizes/payloads stay host-side and
    the counters are reconstructed from the EQ/completion streams.
    Indices (tenants, packets) are int64, PyTorch's index type; a kernel
    cycle limit of 0 (none) ships as +inf and the horizon capped at the
    largest finite value, so each test is one compare in the step."""
    R = len(per_spec)
    NB = max(a["n"] for a in per_spec)
    arr_t = np.full((R, NB + 1), np.inf, np.float64)
    arr_tenant = np.zeros((R, NB + 1), np.int64)
    arr_comp = np.zeros((R, NB + 1), ftype)
    n_arr = np.zeros(R, np.int32)
    for r, a in enumerate(per_spec):
        n = a["n"]
        n_arr[r] = n
        arr_t[r, :n] = a["arr_t"]
        arr_tenant[r, :n] = a["arr_tenant"]
        arr_comp[r, :n] = a["arr_comp"]
    klim = np.stack([a["klim"] for a in per_spec])
    host = {
        "arr_t": arr_t.astype(ftype),
        "arr_tenant": arr_tenant,
        "arr_comp": arr_comp,
        "prio": np.stack([a["prio"] for a in per_spec]),
        "fifo_cap": np.array([[a["fifo_cap"]] for a in per_spec], np.int32),
        "ecn_m1": np.array([[a["ecn_thresh"] - 1] for a in per_spec],
                           np.int32),
        "klim": np.where(klim > 0, klim, np.inf).astype(ftype),
        "tlim": np.stack([a["tlim"] for a in per_spec]),
        "horizon_live": np.minimum(
            np.array([a["horizon"] for a in per_spec], ftype),
            np.finfo(ftype).max),
    }
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}
    return data, n_arr, NB


def _init_state(R: int, T: int, P: int, C: int, NB: int, n_arr,
                ftype, device) -> dict:
    """Slot arrays carry an inert pad at index P and the FIFO ring a
    discard column at index C (masked writes aim there, see
    ``_build_launch``); no per-tenant counters ride the state — they are
    all recoverable from the EQ/completion streams in ``_materialize``."""
    f = _TORCH_FLOAT[ftype]
    i32, i64 = torch.int32, torch.int64

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "now": z(R, f),
        "na": z(R, i64),
        "seq": torch.as_tensor(n_arr, dtype=i32).to(device),  # from n
        "free_pus": full((R,), P, i32),
        "rr_ptr": z(R, i64),
        "queue_len": z((R, T), i32),
        "cur_occup": z((R, T), i32),
        "total_occup": z((R, T), f),
        "bvt": z((R, T), f),
        "fifo_head": z((R, T), i64),
        "fifo_buf": z((R, T, C + 1), i64),
        "spent": z((R, T), f),
        # slot pairs: s_tf = (t_fin, t0) float, s_ps = (pkt-meta, seq)
        # int32 — paired so grant/free are single row writes
        "s_tf": torch.stack([full((R, P + 1), float("inf"), f),
                             z((R, P + 1), f)], dim=-1),
        "s_ps": torch.stack([full((R, P + 1), NB, i32),
                             full((R, P + 1), int(np.iinfo(np.int32).max),
                                  i32)], dim=-1),
        "jain_acc": z(R, f),
        "jain_t": z(R, f),
    }


def _materialize(spec, a: dict, fin_state, ys, r: int,
                 record_completions: bool) -> DeviceRunResult:
    """Rebuild the host-side result objects for replica ``r`` (``a`` is
    the replica's ``_spec_arrays`` dict; state and ys are numpy)."""
    from repro_torch.sim.engine import TenantStats
    T = len(spec.tenants)
    g = {k: v[r] for k, v in fin_state.items()}
    (eq_pack, eq_t, comp_meta, comp_ktime) = (y[:, r] for y in ys)
    eq_code = eq_pack & 7
    eq_ten = eq_pack >> 3
    time = float(g["now"])
    # step order IS the host heap-pop (t_fin, seq) order
    steps = np.flatnonzero(comp_meta != -1)
    meta = comp_meta[steps]
    arr_tenant = a["arr_tenant"].astype(np.int64)
    arr_t = a["arr_t"]
    na = int(g["na"])
    fin = eq_t[steps]
    ktimes = comp_ktime[steps]
    killed = ((meta >> 30) & 1) != 0        # pkt | kill<<30 | bk<<31
    pkts = (meta & ((1 << 30) - 1)).astype(np.int64)
    ten_of = arr_tenant[pkts]
    if record_completions:
        completions = [(int(i), float(t))
                       for i, t in zip(ten_of, fin)]
    else:
        completions = []
    # counters reconstructed from the streams (nothing rides the state):
    # arrivals/bytes from the first na trace rows, drops/marks from EQ
    # codes, completions from the (packet, killed) stream.  Byte sums are
    # nonnegative integers < 2^53, so order of summation is irrelevant.
    tb = np.arange(T + 1, dtype=np.int64)
    arrivals = np.histogram(arr_tenant[:na], bins=tb)[0]
    bytes_in = np.histogram(arr_tenant[:na], bins=tb,
                            weights=a["arr_size"][:na].astype(np.float64))[0]
    drops = np.histogram(eq_ten[eq_code == 2], bins=tb)[0]
    ecn_marks = np.histogram(eq_ten[eq_code == 1], bins=tb)[0]
    completed = np.histogram(ten_of[~killed], bins=tb)[0]
    n_killed = np.histogram(ten_of[killed], bins=tb)[0]
    payload = a["arr_payload"].astype(np.float64)
    bytes_out = np.histogram(ten_of[~killed], bins=tb,
                             weights=payload[pkts[~killed]])[0]
    counters = {
        "arrivals": arrivals,
        "drops": drops,
        "ecn_marks": ecn_marks,
        "enqueued": arrivals - drops,
        "completed": completed,
        "killed": n_killed,
        "bytes_in": bytes_in,
        "bytes_out": bytes_out,
    }
    stats: Dict[int, TenantStats] = {}
    for i in range(T):
        st = TenantStats(
            completed=int(counters["completed"][i]),
            killed=int(counters["killed"][i]),
            drops=int(counters["drops"][i]),
            served_payload_bytes=float(counters["bytes_out"][i]),
        )
        proc = arr_tenant[:na] == i
        if proc.any():
            st.first_arrival = float(arr_t[:na][proc].min())
        mine = np.flatnonzero(ten_of == i)
        if mine.size:
            st.last_completion = float(fin[mine].max())
            # completion order: exact reservoir replay, vectorized
            st.record_kernel_times(ktimes[mine])
        stats[i] = st
    live = np.flatnonzero(eq_code > 0)
    dropped = max(0, live.size - EQ_RING_CAPACITY)
    live = live[dropped:]                 # trim before materializing
    events = [Event(tenant=int(eq_ten[k]), kind=_EQ_KINDS[int(eq_code[k])],
                    time=float(eq_t[k])) for k in live]
    jt = float(g["jain_t"])
    cap = np.full(T, int(spec.fifo_capacity), np.float64)
    return DeviceRunResult(
        spec=spec,
        time=time,
        stats=stats,
        jain_pu_timeavg=float(g["jain_acc"]) / jt if jt else 1.0,
        jain_io_timeavg=1.0,
        events=events,
        events_dropped=dropped,
        completions=completions,
        counters=counters,
        sched_state={
            "prio": a["prio"].astype(np.float64),
            "total_occup": g["total_occup"].astype(np.float64),
            "bvt": g["bvt"].astype(np.float64),
            "kv_pressure": g["queue_len"].astype(np.float64) / cap,
        },
    )


def run_sweep_specs(specs: Sequence, *, impl: str = "",
                    precision: str = "exact",
                    record_completions: bool = False,
                    device="cuda") -> List[DeviceRunResult]:
    """Run every spec as one replica row of a single batched loop.

    All specs must share tenant count and scheduler (one ``SweepSpec``
    expansion always does).  ``precision="exact"`` runs float64 lanes for
    bit-exact parity with the host datapaths; ``"fast"`` float32.
    ``record_completions`` materializes the per-packet completion list
    (parity tests); sweeps keep it off — the summary rows never read it.
    Runs on the card unless ``device="cpu"``; raises without a card.
    """
    dev = require_device(device)
    if not specs:
        return []
    for spec in specs:
        reason = device_eligible(spec)
        if reason:
            raise DevicePathError(
                f"spec {spec.name!r} needs a host datapath: {reason}")
    T = len(specs[0].tenants)
    sched = specs[0].scheduler
    for spec in specs:
        if len(spec.tenants) != T or spec.scheduler != sched:
            raise DevicePathError(
                "sweep replicas must share tenant count and scheduler "
                f"(got T={len(spec.tenants)}/{T}, "
                f"scheduler={spec.scheduler!r}/{sched!r})")
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} (exact|fast)")
    return _run_batch(list(specs), PRECISIONS[precision], sched, impl,
                      record_completions, dev)


def _run_batch(specs, ftype, sched: str, impl: str,
               record_completions: bool, device):
    T = len(specs[0].tenants)
    P = PSPIN.num_pus
    per_spec = [_spec_arrays(s, ftype) for s in specs]
    data, n_arr, NB = _stack_data(per_spec, ftype, device)
    if NB >= (1 << 30) - 1:   # slot meta packs pkt | kill<<30 | bk<<31
        raise DevicePathError(f"trace too long for device path ({NB})")
    C = max(1, min(int(max(s.fifo_capacity for s in specs)), NB))
    S = 2 * max(a["n_live"] for a in per_spec) + 2
    state = _init_state(len(specs), T, P, C, NB, n_arr, ftype, device)
    launch = _build_launch(T, P, C, S, sched, impl)
    with torch.inference_mode():
        fin_state, ys = launch(state, data)
    fin_state = {k: v.cpu().numpy() for k, v in fin_state.items()}
    ys = tuple(y.cpu().numpy() for y in ys)
    return [_materialize(s, per_spec[r], fin_state, ys, r,
                         record_completions)
            for r, s in enumerate(specs)]


def run_device(spec, *, impl: str = "",
               precision: str = "exact",
               record_completions: bool = True,
               device="cuda") -> DeviceRunResult:
    """Single-scenario convenience wrapper (R=1 sweep)."""
    return run_sweep_specs([spec], impl=impl, precision=precision,
                           record_completions=record_completions,
                           device=device)[0]
