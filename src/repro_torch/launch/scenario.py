"""Scenario CLI: run any registered scenario on either backend and dump
the portable RunReport (DESIGN.md §7).

    PYTHONPATH=src python -m repro_torch.launch.scenario --list
    PYTHONPATH=src python -m repro_torch.launch.scenario \
        fig9_congestor_victim --backend sim --json /tmp/fig9.json
    PYTHONPATH=src python -m repro_torch.launch.scenario qos_closed_loop \
        --backend serve
    PYTHONPATH=src python -m repro_torch.launch.scenario --all --fast \
        --out-dir /tmp/run_reports
    PYTHONPATH=src python -m repro_torch.launch.scenario serve_mixed_slo \
        --backend serve --arch qwen3-8b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.scenario qos_closed_loop \
        --export /tmp/obs --dash
    PYTHONPATH=src python -m repro_torch.launch.scenario fleet_migrate

Scenario parameters are overridable with ``--set key=value`` (repeat as
needed); values parse as JSON where possible (``--set scheduler=rr``,
``--set duration_us=60``).  The sim backend and ``--backend serve``
without ``--arch`` (the scheduling-only NullExecutor) are host code on
every machine; ``--arch`` selects a real model, which runs on the card
unless ``--device cpu`` (without a card the default raises).  The
fleet plane's multi-NIC scenarios (``fleet_*``) run on the host fleet
engine on every machine.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _parse_sets(pairs):
    """``--set key=value`` pairs -> dict; values JSON-parsed if valid."""
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"--set expects key=value, got {p!r}")
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def run_one(name: str, backend: str, params, *, arch: str = "",
            smoke: bool = False, fast: bool = False,
            export_dir: str = "", dash: bool = False,
            device: str = "cuda"):
    """Build + run one scenario; returns the validated RunReport.

    With ``arch`` (serve backend only), the registered spec's engine
    shape — via ``ServeRuntime.from_spec``, the single owner of the
    ServeSpec→EngineConfig mapping — also configures a real
    ``ModelExecutor`` data plane on ``device``, under
    ``attn_impl="pallas"`` as ``launch/serve.py`` runs it: on the card
    the model's hand-written kernels run (on the CPU, their plain
    versions).

    ``export_dir`` attaches the metrics bus with the OpenMetrics +
    JSONL exporters (files ``<dir>/<name>.<backend>.om.txt`` and
    ``.jsonl``); ``dash`` attaches the live terminal dashboard.  With
    ``arch`` the bus rides the real model's serve.
    """
    from repro_torch.api import get_scenario, run_scenario
    from repro_torch.api.registry import scenario_params
    accepted = scenario_params(name)
    unknown = set(params) - accepted
    if unknown:
        raise SystemExit(
            f"scenario {name!r} takes no parameter(s) "
            f"{', '.join(sorted(unknown))} (accepted: "
            f"{', '.join(sorted(accepted)) or 'none'})")
    spec = get_scenario(name, **params)
    if fast and not spec.analytic:
        kw = {"duration_us": min(spec.duration_us, 60.0)}
        if spec.horizon_us:
            kw["horizon_us"] = min(spec.horizon_us, 60.0)
        spec = spec.replace(**kw)
    if backend not in spec.backends and not spec.analytic:
        raise SystemExit(
            f"scenario {name!r} does not support backend {backend!r} "
            f"(supported: {', '.join(spec.backends)})")

    bus = None
    om_sink = None
    if (export_dir or dash) and not spec.analytic:
        from repro_torch.telemetry.bus import MetricsBus
        bus = MetricsBus()
        names = {i: t.name for i, t in enumerate(spec.tenants)}
        if export_dir:
            os.makedirs(export_dir, exist_ok=True)
            from repro_torch.telemetry.export import attach_exporters
            om_sink, _ = attach_exporters(
                bus, os.path.join(export_dir, f"{name}.{backend}"),
                names=names)
        if dash:
            from repro_torch.launch.dash import Dashboard
            bus.add_sink(Dashboard(names=names))

    from repro_torch.fleet.spec import FleetSpec
    if isinstance(spec, FleetSpec) and not spec.analytic:
        # fleet scenarios: N per-NIC engines over the modeled switch,
        # publishing per-NIC frames onto the one shared bus; the fabric
        # gauges ride into the OpenMetrics exposition as extra rows.
        # Host code on every machine, whatever ``device`` says
        from repro_torch.fleet.engine import fleet_metric_rows, run_fleet
        try:
            rep = run_fleet(spec, backend, bus=bus)
            if om_sink is not None:
                om_sink.extra_rows = fleet_metric_rows(
                    rep.extras["fleet"], backend=backend)
            return rep
        finally:
            if bus is not None:
                bus.close()

    if backend == "serve" and arch and not spec.analytic:
        from repro_torch.api import ServeRuntime
        from repro_torch.configs import get_config, smoke_config
        from repro_torch.serving.engine import ModelExecutor
        cfg = dataclasses.replace(
            smoke_config(arch) if smoke else get_config(arch),
            attn_impl="pallas")
        rt = ServeRuntime.from_spec(
            spec, executor=lambda ecfg: ModelExecutor(
                cfg, ecfg, rng_seed=spec.seed, device=device))
    elif bus is not None:
        from repro_torch.api.runtime import make_runtime
        rt = make_runtime(spec, backend)
    else:
        return run_scenario(spec, backend)
    if bus is not None:
        rt.attach_bus(bus)
    try:
        return rt.run(spec).validate()
    finally:
        if bus is not None:
            bus.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run a registered OSMOSIS scenario -> RunReport")
    ap.add_argument("scenario", nargs="?", default="",
                    help="registered scenario name (see --list)")
    ap.add_argument("--backend", default="sim", choices=["sim", "serve"])
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--all", action="store_true",
                    help="run every registered scenario on every backend "
                         "it supports")
    ap.add_argument("--fast", action="store_true",
                    help="cap sim durations at 60us (CI smoke)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a scenario parameter (repeatable)")
    ap.add_argument("--json", default="",
                    help="dump the RunReport JSON to this path")
    ap.add_argument("--export", default="", metavar="DIR",
                    help="attach the metrics bus and write OpenMetrics "
                         "(<scenario>.<backend>.om.txt) + JSONL exports "
                         "into DIR")
    ap.add_argument("--dash", action="store_true",
                    help="live terminal dashboard during the run "
                         "(plain ANSI; see repro_torch.launch.dash)")
    ap.add_argument("--out-dir", default="",
                    help="with --all: write one RunReport JSON per run")
    ap.add_argument("--arch", default="",
                    help="serve backend: run a real model (default: "
                         "scheduling-only NullExecutor)")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: shrink the model to smoke size")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="with --arch: where the model runs (default: the "
                         "card)")
    args = ap.parse_args(argv)

    from repro_torch.api import list_scenarios

    if args.list:
        for s in list_scenarios():
            kind = "analytic" if s["analytic"] else ",".join(s["backends"])
            print(f"{s['name']:<24} [{kind:>9}] T={s['tenants']}  "
                  f"{s['description']}")
        return 0

    params = _parse_sets(args.set)

    if args.all:
        if not args.out_dir:
            raise SystemExit("--all requires --out-dir")
        os.makedirs(args.out_dir, exist_ok=True)
        from repro_torch.api.registry import scenario_params
        failures = []
        for s in list_scenarios():
            backends = ["sim"] if s["analytic"] else s["backends"]
            # --set overrides apply wherever a factory accepts the key
            applicable = {k: v for k, v in params.items()
                          if k in scenario_params(s["name"])}
            for backend in backends:
                tag = f"{s['name']}.{backend}"
                try:
                    rep = run_one(s["name"], backend, applicable,
                                  fast=args.fast)
                except Exception as exc:  # noqa: BLE001 — smoke must report all
                    failures.append((tag, repr(exc)))
                    print(f"FAIL {tag}: {exc!r}")
                    continue
                path = os.path.join(args.out_dir, f"{tag}.json")
                rep.save(path)
                print(f"ok   {tag:<36} -> {path}")
        if failures:
            print(f"{len(failures)} scenario run(s) failed")
            return 1
        return 0

    if not args.scenario:
        raise SystemExit("scenario name required (or --list / --all)")

    rep = run_one(args.scenario, args.backend, params, arch=args.arch,
                  smoke=args.smoke, fast=args.fast,
                  export_dir=args.export, dash=args.dash,
                  device=args.device)
    print(rep.summary())
    if rep.extras.get("analytic"):
        cols = rep.extras["columns"]
        print(",".join(cols))
        for row in rep.extras["table"]:
            print(",".join(str(x) for x in row))
    if args.json:
        rep.save(args.json)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
