"""Trace readouts: Perfetto/Chrome ``trace_event`` export + console
waterfall (DESIGN.md §10).

Perfetto mapping:

  * pid 1 ``PU slots`` — one thread per PU; PU_EXEC spans as complete
    ("X") duration events named ``t<tenant>/pkt<uid>``.
  * pid 2 ``Tenants`` — one thread per tenant; ARRIVE / EQ_COMPLETE as
    instant ("i") events (drops, kills, rejects and ECN marks are
    process-scoped so they read as flow markers), FMQ and DMA residency
    as async ("b"/"e") spans keyed by packet uid.
  * pid 3 ``Scheduler`` — one thread per decision kind; every grant is
    an instant event carrying winner / reason / eligible-count args.

Timestamps are emitted in microseconds as the trace_event spec
requires: virtual-ns are scaled by 1e-3, serving steps map to 1 step =
1 µs for display.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.telemetry.trace import (
    DECISION_KINDS, DISPOSITIONS, D_DROP, D_KILL, D_MARK, D_OK, D_OPEN,
    D_REJECT, REASONS, ST_ARRIVE, ST_DMA, ST_EQ, ST_FMQ, ST_GRANT,
    ST_PU, STAGES, TraceRecorder,
)

PID_PU = 1
PID_TENANTS = 2
PID_SCHED = 3

_ARRIVE_NAMES = {D_OK: "arrive", D_MARK: "ecn_mark", D_DROP: "drop",
                 D_REJECT: "reject"}


def _scale(time_unit: str) -> float:
    # trace_event ts/dur are microseconds; 1 serving step displays as 1us
    return 1e-3 if time_unit == "ns" else 1.0


def to_perfetto(trace: TraceRecorder, *, time_unit: str = "ns",
                last: Optional[int] = None,
                tenant_names: Optional[Dict[int, str]] = None) -> dict:
    """Render the retained rings as a Chrome/Perfetto trace dict."""
    r = trace.tail(last) if last else trace.rows()
    d = trace.decision_rows()
    k = _scale(time_unit)
    names = tenant_names or {}
    ev: List[dict] = []

    def meta(pid, name):
        ev.append({"ph": "M", "pid": pid, "tid": 0,
                   "name": "process_name", "args": {"name": name}})

    def thread(pid, tid, name):
        ev.append({"ph": "M", "pid": pid, "tid": int(tid),
                   "name": "thread_name", "args": {"name": name}})

    meta(PID_PU, "PU slots")
    for p in range(max(trace.P, 1)):
        thread(PID_PU, p, f"PU {p}")
    meta(PID_TENANTS, "Tenants")
    tenants = sorted(set(np.asarray(r["tenant"]).tolist())
                     | set(int(t) for t in names))
    for t in tenants:
        thread(PID_TENANTS, t, names.get(t, f"tenant {t}"))
    meta(PID_SCHED, "Scheduler")
    kinds_present = sorted(set(np.asarray(d["kind"]).tolist()))
    for kd in kinds_present:
        thread(PID_SCHED, kd, DECISION_KINDS[kd])

    n = len(r["uid"])
    for i in range(n):
        uid = int(r["uid"][i])
        t = int(r["tenant"][i])
        stage = int(r["stage"][i])
        disp = int(r["disp"][i])
        pu = int(r["pu"][i])
        t0 = float(r["t0"][i]) * k
        t1 = float(r["t1"][i]) * k
        args = {"uid": uid, "tenant": t, "disp": DISPOSITIONS[disp]}
        if stage == ST_ARRIVE:
            ev.append({"ph": "i", "pid": PID_TENANTS, "tid": t,
                       "ts": t0, "s": "t" if disp == D_OK else "p",
                       "name": _ARRIVE_NAMES.get(disp, "arrive"),
                       "cat": "arrive", "args": args})
        elif stage == ST_GRANT:
            ev.append({"ph": "i", "pid": PID_TENANTS, "tid": t,
                       "ts": t0, "s": "t", "name": "grant",
                       "cat": "sched", "args": dict(args, pu=pu)})
        elif stage == ST_PU:
            ev.append({"ph": "X", "pid": PID_PU, "tid": max(pu, 0),
                       "ts": t0, "dur": t1 - t0,
                       "name": f"t{t}/pkt{uid}", "cat": "pu",
                       "args": args})
            if disp == D_KILL:
                ev.append({"ph": "i", "pid": PID_TENANTS, "tid": t,
                           "ts": t1, "s": "p", "name": "kill",
                           "cat": "pu", "args": args})
        elif stage == ST_EQ:
            ev.append({"ph": "i", "pid": PID_TENANTS, "tid": t,
                       "ts": t0, "s": "t" if disp == D_OK else "p",
                       "name": ("eq_complete" if disp == D_OK
                                else "eq_kill"),
                       "cat": "eq", "args": args})
        else:  # FMQ / DMA residency as async spans keyed by uid
            cat = "fmq" if stage == ST_FMQ else "dma"
            name = STAGES[stage]
            if disp == D_OPEN:
                args["open"] = True
            base = {"pid": PID_TENANTS, "tid": t, "cat": cat,
                    "id": uid, "name": name}
            ev.append(dict(base, ph="b", ts=t0, args=args))
            ev.append(dict(base, ph="e", ts=t1, args={}))

    for i in range(len(d["time"])):
        kd = int(d["kind"][i])
        ev.append({
            "ph": "i", "pid": PID_SCHED, "tid": kd,
            "ts": float(d["time"][i]) * k, "s": "t",
            "name": REASONS[int(d["reason"][i])], "cat": "decision",
            "args": {"winner": int(d["winner"][i]),
                     "n_elig": int(d["n_elig"][i]),
                     "metric": float(d["metric"][i])},
        })

    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"time_unit": time_unit,
                          "spans_recorded": int(trace.span_count),
                          "decisions_recorded": int(trace.decision_count)}}


def write_perfetto(trace: TraceRecorder, path: str, **kw) -> dict:
    doc = to_perfetto(trace, **kw)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc


def console_waterfall(trace: TraceRecorder, *, top_k: int = 10,
                      time_unit: str = "ns") -> str:
    """Top-k slowest packets with a per-stage breakdown."""
    r = trace.rows()
    per: Dict[int, dict] = {}
    n = len(r["uid"])
    for i in range(n):
        uid = int(r["uid"][i])
        stage = int(r["stage"][i])
        rec = per.setdefault(uid, {"tenant": int(r["tenant"][i]),
                                   "stages": {}, "disp": D_OK,
                                   "arrive": None})
        dur = float(r["t1"][i]) - float(r["t0"][i])
        if stage in (ST_FMQ, ST_PU, ST_DMA):
            rec["stages"][stage] = rec["stages"].get(stage, 0.0) + dur
        if stage == ST_ARRIVE:
            rec["arrive"] = float(r["t0"][i])
        if stage in (ST_EQ, ST_PU) and int(r["disp"][i]) != D_OK:
            rec["disp"] = int(r["disp"][i])
    ranked = sorted(per.items(),
                    key=lambda kv: -sum(kv[1]["stages"].values()))
    lines = [f"top {min(top_k, len(ranked))} slowest packets "
             f"({time_unit}):",
             f"{'uid':>8} {'tenant':>6} {'total':>12} {'fmq_wait':>12} "
             f"{'pu_exec':>12} {'dma':>12}  disp"]
    for uid, rec in ranked[:top_k]:
        s = rec["stages"]
        total = sum(s.values())
        lines.append(
            f"{uid:>8} {rec['tenant']:>6} {total:>12.1f} "
            f"{s.get(ST_FMQ, 0.0):>12.1f} {s.get(ST_PU, 0.0):>12.1f} "
            f"{s.get(ST_DMA, 0.0):>12.1f}  "
            f"{DISPOSITIONS[rec['disp']]}")
    return "\n".join(lines)
