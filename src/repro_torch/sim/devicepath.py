"""Device-resident sim datapath: the event loop as one fixed-length loop of
steps over an explicit ``[R, ...]`` replica axis (DESIGN.md §13).

This module runs the *whole* inner loop of the PsPIN simulator —
arrival ingestion, FMQ push with ECN mark-before-drop, WLBVT/RR dispatch,
budget-clamp kills, completion bookkeeping, occupancy/BVT folds, EQ
emission — as ``S`` steps over every replica of a ``SweepSpec`` at once,
on the card by default, through ``kernels.ops.sweep_scan``.  On the card
that is one launch of the hand-written CUDA kernel
``kernels/csrc/sweep_scan.cu``, which keeps each replica's state on chip
for all ``S`` steps and runs each step's WLBVT round inlined
(``csrc/wlbvt_round.cuh``, the round of ``csrc/wlbvt_select.cu``).  On
the CPU the same steps run as the plain version
``kernels/ref.py::sweep_scan_ref``, a few dozen PyTorch ops a step on the
replica tensors.  The two are one function, bit for bit: a change to the
step changes the plain step and ``sweep_scan.cu`` together, and the
``gpu`` tests (``tests/test_torch_sweep_scan.py``,
``tests/test_torch_sweep_card.py``) and ``chip_smoke.py`` are what hold
them together.  This module is the host side: spec -> replica arrays ->
the scan -> results.

Event model (per replica, fixed shapes): the heap of the host loop
degenerates, on the compute-only contract below, to a two-way merge of
the (pre-sorted) arrival array against the PU slot table's min
finish-time.  Arrival seqs are assigned at inject (0..n-1) and
completion seqs start at n, so an arrival always precedes a completion
at equal time and completion ties resolve by lower seq — exactly the
host heap's ``(time, seq)`` order.  Each step consumes at most one
event; dead steps (replica drained or past horizon) are no-ops, so
ragged replicas ride the same grid.  A step reads nothing back to the
host: the step count is fixed up front and the per-step records go into
preallocated ``[S, R]`` tensors, copied to the host once after the loop.

Device contract — ``device_eligible`` returns the reason a spec needs
the host path: compute-only workloads (``io_kind == "none"``; the
DWRR/AXI/egress machinery never engages), no QoS controller (windows
then carry no decisions, only telemetry flushes), wlbvt/rr scheduling,
no timeline/trace capture.  Inside the contract the device path is
decision/EQ/telemetry **bit-identical** to the host ``BatchedSimulator``
(``sim/fastpath.py``, itself equal to the JAX package's) under
``precision="exact"`` (float64, which the H100 has natively); the only
documented drift is the Jain time-average, whose host fold compresses
the active set before summing (DESIGN.md §8).  Every sum over tenants takes ``core.sched_generic.lane_sum``'s
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
from repro_torch.core.events import Event, EventKind
from repro_torch.kernels import ops
from repro_torch.serving.serve_step import require_device

EQ_RING_CAPACITY = 4096   # host EQHub shared-queue retention
PRECISIONS = {"exact": np.float64, "fast": np.float32}

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


def _stack_data(per_spec: List[dict], ftype, device) -> Tuple[dict, int]:
    """Pad ragged replica arrays to a common grid; index NB is the inert
    sentinel row (arrival at +inf / zero-size packet).  Only what the
    step reads ships to the device — sizes/payloads stay host-side and
    the counters are reconstructed from the EQ/completion streams.
    ``n_arr`` (each replica's packets) seeds the completion seqs.
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
        "n_arr": n_arr,
    }
    data = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}
    return data, NB


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
    return _run_batch(list(specs), PRECISIONS[precision], impl,
                      record_completions, dev)


def scan_inputs(specs, ftype, device) -> Tuple[List[dict], dict, dict]:
    """A batch's scan inputs: each spec's host arrays, the stacked replica
    arrays on ``device`` and the scan's geometry (``ops.sweep_scan``'s
    keywords): ``P`` PUs, a FIFO ring of ``C`` entries, ``S`` steps (each
    live step consumes one event: at most ``n_live`` arrivals and as many
    completions)."""
    per_spec = [_spec_arrays(s, ftype) for s in specs]
    data, NB = _stack_data(per_spec, ftype, device)
    if NB >= (1 << 30) - 1:   # slot meta packs pkt | kill<<30 | bk<<31
        raise DevicePathError(f"trace too long for device path ({NB})")
    geometry = dict(T=len(specs[0].tenants), P=PSPIN.num_pus,
                    C=max(1, min(int(max(s.fifo_capacity for s in specs)),
                                 NB)),
                    S=2 * max(a["n_live"] for a in per_spec) + 2,
                    scheduler=specs[0].scheduler)
    return per_spec, data, geometry


def _run_batch(specs, ftype, impl: str, record_completions: bool, device):
    per_spec, data, geometry = scan_inputs(specs, ftype, device)
    with torch.inference_mode():
        fin_state, ys = ops.sweep_scan(data, **geometry, impl=impl)
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
