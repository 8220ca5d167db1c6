"""Trace CLI: run a scenario with the flight recorder on and export the
packet-lifecycle trace (DESIGN.md §10).  The whole plane is host numpy
on every machine, the card's included.

    PYTHONPATH=src python -m repro_torch.launch.trace \
        --scenario qos_closed_loop --out trace.json
    PYTHONPATH=src python -m repro_torch.launch.trace \
        --scenario fig9_congestor_victim --backend sim --console
    PYTHONPATH=src python -m repro_torch.launch.trace \
        --scenario fig9_congestor_victim --out tail.json --last 1000
    PYTHONPATH=src python -m repro_torch.launch.trace \
        --scenario fig9_congestor_victim --datapath batched --out b.json

``--out`` writes Chrome/Perfetto ``trace_event`` JSON — open it in
ui.perfetto.dev (or chrome://tracing).  ``--last N`` exports only the
newest N retained span rows (ring tail); ``--console`` prints a
waterfall of the top-k slowest packets instead of / in addition to the
file.  Scenario parameters are overridable with ``--set key=value``
exactly as in ``repro_torch.launch.scenario``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.launch.scenario import _parse_sets


def run_traced(name: str, backend: str, params, *, fast: bool = False,
               depth: int = 65536, decision_depth: int = 8192,
               datapath: str = ""):
    """Run one registered scenario with tracing on.

    Returns ``(RunReport, TraceRecorder, spec)`` — the recorder is
    flushed (open spans written with disposition OPEN) and committed.
    ``datapath`` ("event" | "batched", sim backend) overrides the
    spec's simulator datapath; both record identical rows.
    """
    from repro_torch.api import get_scenario
    from repro_torch.api.registry import scenario_params
    from repro_torch.api.runtime import make_runtime
    accepted = scenario_params(name)
    unknown = set(params) - accepted
    if unknown:
        raise SystemExit(
            f"scenario {name!r} takes no parameter(s) "
            f"{', '.join(sorted(unknown))} (accepted: "
            f"{', '.join(sorted(accepted)) or 'none'})")
    spec = get_scenario(name, **params)
    if spec.analytic:
        raise SystemExit(f"scenario {name!r} is analytic — nothing to trace")
    if fast:
        kw = {"duration_us": min(spec.duration_us, 60.0)}
        if spec.horizon_us:
            kw["horizon_us"] = min(spec.horizon_us, 60.0)
        spec = spec.replace(**kw)
    if datapath:
        spec = spec.replace(datapath=datapath)
    if backend not in spec.backends:
        raise SystemExit(
            f"scenario {name!r} does not support backend {backend!r} "
            f"(supported: {', '.join(spec.backends)})")
    rt = make_runtime(spec, backend, trace=True, trace_depth=depth,
                      trace_decision_depth=decision_depth)
    rep = rt.run(spec)
    rt.flush_trace()
    return rep, rt.trace, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run a scenario with the packet-lifecycle flight "
                    "recorder on and export a Perfetto trace")
    ap.add_argument("--scenario", required=True,
                    help="registered scenario name "
                         "(repro_torch.launch.scenario --list)")
    ap.add_argument("--backend", default="sim", choices=["sim", "serve"])
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a scenario parameter (repeatable)")
    ap.add_argument("--datapath", default="", choices=["", "event",
                                                       "batched"],
                    help="sim backend: the simulator datapath (default: "
                         "the scenario's)")
    ap.add_argument("--fast", action="store_true",
                    help="cap sim durations at 60us (CI smoke)")
    ap.add_argument("--out", default="",
                    help="write Perfetto trace_event JSON here")
    ap.add_argument("--last", type=int, default=0, metavar="N",
                    help="export only the newest N span rows (ring tail)")
    ap.add_argument("--console", action="store_true",
                    help="print a waterfall of the slowest packets")
    ap.add_argument("--top-k", type=int, default=10,
                    help="waterfall size for --console")
    ap.add_argument("--depth", type=int, default=65536,
                    help="span ring depth")
    ap.add_argument("--decision-depth", type=int, default=8192,
                    help="decision-provenance ring depth")
    args = ap.parse_args(argv)

    rep, tr, spec = run_traced(
        args.scenario, args.backend, _parse_sets(args.set),
        fast=args.fast, depth=args.depth,
        decision_depth=args.decision_depth, datapath=args.datapath)

    print(rep.summary())
    s = tr.trace_summary()
    print(f"trace: {s['spans_recorded']} spans recorded "
          f"({s['spans_retained']} retained, depth {s['span_depth']}), "
          f"{s['decisions_recorded']} decisions recorded "
          f"({s['decisions_retained']} retained)")
    if args.console:
        from repro_torch.telemetry import console_waterfall
        print(console_waterfall(tr, top_k=args.top_k,
                                time_unit=rep.time_unit))
    if args.out:
        from repro_torch.telemetry import write_perfetto
        names = {i: t.name for i, t in enumerate(spec.tenants)}
        doc = write_perfetto(tr, args.out, time_unit=rep.time_unit,
                             last=args.last or None, tenant_names=names)
        print(f"wrote {args.out} ({len(doc['traceEvents'])} events) — "
              f"open in ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
