"""Per-tenant telemetry report CLI (DESIGN.md §6).

Runs a congestor-vs-victim scenario on either execution surface, with or
without the closed-loop QoS controller, and dumps the telemetry plane as
a console table + JSON:

    PYTHONPATH=src python -m repro_torch.launch.telemetry_report \
        --surface sim --controller --json /tmp/telemetry.json

``--surface serving`` drives the scheduling-only serving engine
(NullExecutor) so the report renders without a model; latency units are
engine steps there, nanoseconds on the simulator.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _sim_report(args) -> dict:
    from repro_torch.sim.scenarios import run_qos_closed_loop
    from repro_torch.telemetry import compute_signals, tenant_report
    res = run_qos_closed_loop(args.controller,
                              duration_us=args.duration_us, seed=args.seed)
    sim_tel = res.telemetry
    ss = res.sched_state
    sig = compute_signals(sim_tel, prio=ss["prio"],
                          total_occup=ss["total_occup"], bvt=ss["bvt"],
                          kv_pressure=ss["kv_pressure"])
    rep = tenant_report(sim_tel, names={0: "congestor", 1: "victim"},
                        signals=sig)
    rep["surface"] = "sim"
    rep["jain_pu_timeavg"] = res.jain_pu_timeavg
    rep["latency_unit"] = "ns"
    return rep


def _serving_report(args) -> dict:
    from repro_torch.core.slo import SLOPolicy
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.request import Request
    from repro_torch.telemetry import QoSController
    ecfg = EngineConfig(max_slots=8, max_len=256, prefill_chunk=32,
                        max_tenants=4, kv_overcommit=2.0,
                        qos_interval=16 if args.controller else 0)
    eng = Engine(ecfg)
    eng.create_ectx(0, SLOPolicy(kv_quota_tokens=256 * 8), name="congestor")
    eng.create_ectx(1, SLOPolicy(kv_quota_tokens=256 * 8), name="victim")
    if args.controller:
        eng.attach_controller(QoSController(
            base_weights=np.ones(ecfg.max_tenants),
            p99_targets=[0.0, 40.0] + [0.0] * (ecfg.max_tenants - 2)))
    rng = np.random.RandomState(args.seed)
    for i in range(48):
        t = i % 2
        plen = 160 if t == 0 else 16
        new = 48 if t == 0 else 8
        eng.submit(Request(t, rng.randint(1, 90, plen).astype(np.int32),
                           max_new_tokens=new))
    eng.run_until_idle()
    rep = eng.telemetry_report()
    rep["surface"] = "serving"
    rep["jain_timeavg"] = eng.metrics()["jain_timeavg"]
    rep["latency_unit"] = "steps"
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--surface", default="sim", choices=["sim", "serving"])
    ap.add_argument("--controller", action="store_true",
                    help="enable the closed-loop QoS controller")
    ap.add_argument("--duration-us", type=float, default=150.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="",
                    help="also dump the report to this path")
    args = ap.parse_args(argv)

    from repro_torch.telemetry import dump_json, format_console
    rep = (_sim_report(args) if args.surface == "sim"
           else _serving_report(args))
    print(f"surface={rep['surface']}  controller={args.controller}  "
          f"latency_unit={rep['latency_unit']}")
    print(format_console(rep, time_unit=rep["latency_unit"]))
    if args.json:
        dump_json(rep, args.json, overwrite=True)  # explicit CLI target
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
