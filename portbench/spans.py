"""A cell served with the program's own flight recorder on, read from the
inside: the engine's steps and phases, the executor's calls and their
stage / launch / readback, each request's queue / prefill / decode, all
on the program's clock (``repro_torch.telemetry.clock``, the profiler's
timeline).

    python3 portbench/spans.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--program-trace <0|1>]

from the root of a checkout.  The run is ``run.py``'s up to the window's
end (the same set-up, warm-up, traffic and window; no correctness check),
but the engine is built with ``EngineConfig.trace`` set unless
``--program-trace 0``.  It prints one JSON line: the end-to-end metrics;
the benchmark's per-layer metrics as ``run.py`` reads them (without
``--trace 1``, those of the harness's host stamps alone); and, with the
program tracing, the readings below from its host spans.  ``run.py`` never turns the program's tracing on, so the
benchmark's own runs are untouched by this file.

The readings (``read_program``), each over the window:

  engine_self_ms            mean ``engine.step`` less its ``executor.*``
                            calls (the twin of ``engine_host_ms``)
  victim_grant_wait_p90_ms  p90 of ``request.queue`` (submission to the
                            slot grant) over the victims' requests
                            submitted in the window; one still waiting
                            counts to the window's end (the harness's
                            ``victim_queue_wait_p90_ms`` counts from the
                            due time, so it also holds the wait in the
                            client for the engine's step to end)
  prefill_launch_ms         mean ``prefill.launch``: the serve function
  decode_launch_ms          mean ``decode.launch``   from entry to return
  prefill_valid_rows_pct    100 x the valid token rows over the rows
                            computed, summed over ``executor.prefill``
                            (``decode_valid_rows_pct``: the active slots
                            over the slots, over ``executor.decode``)
  launch_idle_share         % of the window the device ran nothing while
                            the host's innermost span was a ``*.launch``
                            (``--trace 1`` only; no device operation in
                            the trace, as on the CPU: the device counts
                            as idle throughout)

and beside them the victims' p90 from the grant to the first token
(``victim_prefill_p90_ms``) and from the first token to the finish
(``victim_decode_p90_ms``), the idle seconds by the host's innermost
span (``idle_by_span``), each phase's mean self time a step, each
executor part's mean, the offset of the program's call spans from the
harness's ``portbench.<kind>`` marks (the two clocks' agreement), and,
from the harness, the victims' p90 from due to submission.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LAUNCH = (".launch",)
OUTSIDE = "outside a step"


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------
def busy_union(ops, w0: float, w1: float):
    """The device's busy intervals inside [w0, w1] (s), merged and
    sorted: (starts, ends)."""
    iv = sorted((max(a, w0), min(b, w1)) for _, a, b in ops
                if b > w0 and a < w1)
    s, e = [], []
    for a, b in iv:
        if e and a <= e[-1]:
            e[-1] = max(e[-1], b)
        else:
            s.append(a)
            e.append(b)
    return np.asarray(s, float), np.asarray(e, float)


def busy_before(starts, ends, t):
    """Device busy seconds in [-inf, t] for each t (vectorised)."""
    t = np.asarray(t, float)
    if not starts.size:
        return np.zeros_like(t)
    cum = np.concatenate(([0.0], np.cumsum(ends - starts)))
    k = np.searchsorted(starts, t, side="right")
    over = np.where(k > 0, np.maximum(ends[np.maximum(k - 1, 0)] - t, 0.0),
                    0.0)
    return cum[k] - over


def idle_in(starts, ends, a, b):
    """Idle seconds of the device in each [a, b]."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return (b - a) - (busy_before(starts, ends, b)
                      - busy_before(starts, ends, a))


def self_intervals(rows, w0_ns: int, w1_ns: int):
    """(name, a_ns, b_ns) pieces of the window, each labelled with the
    innermost step / call span the host was in (``OUTSIDE`` where it was
    in none): every span's interval less its children's."""
    tree = ~np.char.startswith(rows["name"].astype(str), "request.")
    ids = rows["id"][tree]
    names = rows["name"][tree]
    t0, t1 = rows["t0_ns"][tree], rows["t1_ns"][tree]
    kids = defaultdict(list)
    for i, p in zip(range(len(ids)), rows["parent"][tree]):
        kids[int(p)].append(i)
    out = []

    def pieces(name, a, b, children):
        cur = a
        for c in sorted(children, key=lambda c: t0[c]):
            if t0[c] > cur:
                out.append((name, cur, min(t0[c], b)))
            cur = max(cur, t1[c])
        if b > cur:
            out.append((name, cur, b))

    for i in range(len(ids)):
        pieces(str(names[i]), int(t0[i]), int(t1[i]), kids[int(ids[i])])
    pieces(OUTSIDE, w0_ns, w1_ns, kids[-1])
    return [(n, max(a, w0_ns), min(b, w1_ns)) for n, a, b in out
            if min(b, w1_ns) > max(a, w0_ns)]


# ---------------------------------------------------------------------------
# the readings
# ---------------------------------------------------------------------------
def _in_window(rows, w0_ns: int, w1_ns: int):
    return (rows["t0_ns"] >= w0_ns) & (rows["t1_ns"] <= w1_ns)


def _mean_ms(rows, mask) -> Optional[float]:
    d = (rows["t1_ns"] - rows["t0_ns"])[mask]
    return float(d.mean()) / 1e6 if d.size else None


def read_program(rows: Dict[str, np.ndarray], w0_ns: int, w1_ns: int,
                 victims, ops=None) -> dict:
    """The six readings and their companions from the recorder's
    ``host_rows()`` over the window [w0_ns, w1_ns]; ``ops`` are the
    trace's device operations (name, start_s, end_s) on the same clock,
    or None."""
    name = rows["name"].astype(str)
    inw = _in_window(rows, w0_ns, w1_ns)
    dur = rows["t1_ns"] - rows["t0_ns"]
    by_id = {int(i): k for k, i in enumerate(rows["id"]) if i >= 0}
    out: dict = {}

    # the engine's own time a step: the step less its executor calls
    steps = np.flatnonzero(inw & (name == "engine.step"))
    inside = defaultdict(int)
    for k in np.flatnonzero(np.char.startswith(name, "executor.")):
        phase = by_id.get(int(rows["parent"][k]))
        if phase is not None:
            inside[int(rows["parent"][phase])] += int(dur[k])
    if steps.size:
        out["engine_self_ms"] = float(np.mean(
            [dur[k] - inside[int(rows["id"][k])] for k in steps])) / 1e6

    # the victims' requests, by the part of their life begun in the
    # window: the wait for a slot from submission, the grant to the
    # first token on the host, the first token to the finish; one still
    # in that part counts to the window's end
    mine = np.isin(rows["tenant"], list(victims)) \
        & (rows["t0_ns"] >= w0_ns) & (rows["t0_ns"] <= w1_ns)
    for part, key in (("queue", "victim_grant_wait_p90_ms"),
                      ("prefill", "victim_prefill_p90_ms"),
                      ("decode", "victim_decode_p90_ms")):
        q = mine & (name == f"request.{part}")
        if q.any():
            waits = np.minimum(rows["t1_ns"][q], w1_ns) - rows["t0_ns"][q]
            out[key] = float(np.percentile(waits, 90)) / 1e6

    for kind in ("prefill", "decode"):
        v = _mean_ms(rows, inw & (name == f"{kind}.launch"))
        if v is not None:
            out[f"{kind}_launch_ms"] = v
        call = inw & (name == f"executor.{kind}")
        if rows["computed"][call].sum() > 0:
            out[f"{kind}_valid_rows_pct"] = 100.0 * float(
                rows["valid"][call].sum()) / float(
                rows["computed"][call].sum())

    # the device's idle time by the host's innermost span (seconds from
    # the window's start, so that no precision is lost to Unix time);
    # without a trace of the window there is nothing to read
    w0, span_s = w0_ns * 1e-9, (w1_ns - w0_ns) * 1e-9
    pieces = self_intervals(rows, w0_ns, w1_ns)
    if ops is not None:
        starts, ends = busy_union([(n, a - w0, b - w0) for n, a, b in ops],
                                  0.0, span_s)
        idle = defaultdict(float)
        gaps = idle_in(starts, ends, [(p[1] - w0_ns) * 1e-9 for p in pieces],
                       [(p[2] - w0_ns) * 1e-9 for p in pieces])
        for (n, _, _), g in zip(pieces, gaps):
            idle[n] += float(g)
        out["launch_idle_share"] = 100.0 * sum(
            v for n, v in idle.items() if n.endswith(LAUNCH)) / span_s
        out["idle_by_span"] = dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1]))
        out["busy_s"] = float((ends - starts).sum())
        out["window_s"] = span_s

    # companions: phases' self time, calls and their parts
    selfs = defaultdict(list)
    for n, a, b in pieces:
        selfs[n].append(b - a)
    n_steps = max(int(steps.size), 1)
    out["self_ms_per_step"] = {
        n: float(np.sum(v)) / 1e6 / n_steps for n, v in sorted(selfs.items())
        if n.startswith("engine.")}
    out["mean_ms"] = {n: _mean_ms(rows, inw & (name == n))
                      for n in sorted(set(name[inw]))
                      if not n.startswith(("request.", "engine."))}
    out["counts"] = {n: int(c) for n, c in zip(
        *np.unique(name[inw], return_counts=True))}
    return out


def clock_offsets_ms(rows, spans) -> dict:
    """Median start of the program's ``executor.<kind>`` spans less the
    harness's ``portbench.<kind>`` marks (ms) — the wrapper's own time
    plus the clocks' disagreement."""
    out = {}
    name = rows["name"].astype(str)
    for kind in ("prefill", "decode", "reset"):
        prog = np.sort(rows["t0_ns"][name == f"executor.{kind}"]) * 1e-9
        mark = np.sort([a for n, a, _ in spans if n == kind])
        if not len(mark) or not len(prog):
            continue
        i = np.searchsorted(prog, mark)
        lo = prog[np.clip(i - 1, 0, len(prog) - 1)]
        hi = prog[np.clip(i, 0, len(prog) - 1)]
        near = np.where(np.abs(lo - mark) <= np.abs(hi - mark), lo, hi)
        out[kind] = float(np.median(near - mark)) * 1e3
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------
def victim_tenants(cell) -> list:
    return [i for i, t in enumerate(cell.traffic["tenants"])
            if t.get("victim")]


def run_spans(root: Path, name: str, seed: int, seconds: float,
              trace: bool, program_trace: bool = True, device: str = "cuda",
              t_process: Optional[float] = None, log=print) -> dict:
    """The run; returns the printed line's fields and, under ``_``-keys,
    the host rows, the window on the program's clock and the harness's
    ``RunRecord``."""
    import torch
    from portbench.harness import trace as TRC
    from portbench.harness.bench import end_to_end, prepare, release, serve
    from repro_torch.telemetry.clock import now_ns

    t_process = time.perf_counter() if t_process is None else t_process
    st = prepare(root, name, seed, device)
    if program_trace:
        st.ecfg = dataclasses.replace(st.ecfg, trace=True)
    # the harness's clock (perf_counter) onto the program's
    to_prog_ns = now_ns() - time.perf_counter_ns()
    run, drv, prof = serve(st, seconds, trace)
    rec = drv.eng.trace
    rows = rec.host_rows() if rec is not None else None
    e2e = end_to_end(run)
    e2e["setup_s"] = run.t0 - t_process
    peak = (torch.cuda.max_memory_allocated(st.dev)
            if st.dev.type == "cuda" else 0)
    release(st, drv)
    w0_ns = int(round(run.t0 * 1e9)) + to_prog_ns
    w1_ns = int(round(run.t1 * 1e9)) + to_prog_ns
    ops = spans = None
    per_layer = {}
    if prof is not None:
        ops, spans = TRC.raw_events(prof)
        del prof
        run.trace = TRC.reduce(ops, spans)
        win = [(a, b) for n, a, b in spans if n == "window"][0]
        w0_ns, w1_ns = int(round(win[0] * 1e9)), int(round(win[1] * 1e9))
    # without a trace, the readers of the harness's host stamps still read
    for m in st.cell.metrics("per_layer"):
        v = st.cell.reader(m["name"])(run)
        if v is not None:
            per_layer[m["name"]] = float(v)
    lag = [r.submitted - r.due for r in run.victims_due()]
    if lag:
        # the harness submits between engine steps: a request due during
        # a step waits in the client until the step ends
        e2e["_victim_submit_lag_p90_ms"] = float(np.percentile(lag, 90)) * 1e3
    line = {"workload": name, "seed": seed, "trace": int(trace),
            "program_trace": int(program_trace),
            "end_to_end": {k: v for k, v in e2e.items()
                           if not k.startswith("_")},
            "harness": {k[1:]: v for k, v in e2e.items()
                        if k.startswith("_")},
            "per_layer": per_layer, "memory_peak_bytes": int(peak),
            "device": (torch.cuda.get_device_name(st.dev)
                       if st.dev.type == "cuda" else "cpu")}
    if rows is not None:
        line["program"] = read_program(rows, w0_ns, w1_ns,
                                       victim_tenants(st.cell), ops)
        if spans is not None:
            line["program"]["clock_offset_ms"] = clock_offsets_ms(rows,
                                                                  spans)
    line.update(_rows=rows, _w=(w0_ns, w1_ns), _run=run, _ops=ops)
    log(f"portbench spans: {name} seed {seed}: steps in the window "
        f"{len(run.steps)}, host rows {0 if rows is None else len(rows['id'])}")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program-trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.run import _environment
    _environment()          # run.py's caches and import path
    import torch
    if not torch.cuda.is_available():
        print("portbench spans: no CUDA device", file=sys.stderr)
        return 2
    line = run_spans(ROOT, args.workload, args.seed, args.seconds,
                     bool(args.trace), bool(args.program_trace),
                     t_process=T_PROCESS,
                     log=lambda *a: print(*a, file=sys.stderr, flush=True))
    print(json.dumps({k: v for k, v in line.items()
                      if not k.startswith("_")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
