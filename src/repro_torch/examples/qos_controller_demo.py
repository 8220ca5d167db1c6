"""Closed-loop QoS on the serving engine (DESIGN.md §6).

A congestor floods long prompts/generations while a latency-SLO victim
serves short interactive requests.  Run once with static weights and
once with the QoSController adapting WLBVT/DWRR weights from the
telemetry plane's p99 signal; compare the victim's p99 FCT (in steps).

    PYTHONPATH=src python -m repro_torch.examples.qos_controller_demo

The engine runs its scheduling core alone (no executor: the
scheduling-only NullExecutor), host numpy on every machine.
"""
import sys

import numpy as np

from repro_torch.core.slo import SLOPolicy
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import Request
from repro_torch.telemetry import QoSController, format_console


def run(controller: bool, seed: int = 0, rounds: int = 120):
    ecfg = EngineConfig(max_slots=8, max_len=512, prefill_chunk=32,
                        max_tenants=4, kv_overcommit=2.0,
                        qos_interval=16 if controller else 0)
    eng = Engine(ecfg)
    eng.create_ectx(0, SLOPolicy(kv_quota_tokens=512 * 8), name="congestor")
    eng.create_ectx(1, SLOPolicy(kv_quota_tokens=512 * 8), name="victim")
    if controller:
        targets = np.zeros(ecfg.max_tenants)
        targets[1] = 30.0            # victim p99 FCT target, engine steps
        eng.attach_controller(QoSController(
            base_weights=np.ones(ecfg.max_tenants), p99_targets=targets))
    rng = np.random.RandomState(seed)
    # congestor: standing backlog (WLBVT's weighted cap only binds while a
    # tenant stays backlogged); victim: steady stream whose slot demand
    # (~5 of 8) slightly exceeds its static fair-share cap (4) — the same
    # regime as the simulator's closed-loop scenario
    for _ in range(16):
        eng.submit(Request(0, rng.randint(1, 90, 192).astype(np.int32),
                           max_new_tokens=64))
    for i in range(rounds):
        if i % 8 == 0:
            eng.submit(Request(
                0, rng.randint(1, 90, 192).astype(np.int32),
                max_new_tokens=64))
        for _ in range(2 + i % 2):     # ~5.6 slots of demand: the victim
            eng.submit(Request(        # stays backlogged, so caps bind
                1, rng.randint(1, 90, 12).astype(np.int32),
                max_new_tokens=8))
        eng.run(4)
    eng.run_until_idle()
    return eng


def main(argv=None) -> int:
    del argv                           # no options
    for enabled in (False, True):
        eng = run(enabled)
        rep = eng.telemetry_report()
        victim = rep["tenants"][1]
        print(f"\n=== controller={'on' if enabled else 'off'} ===")
        print(format_console(rep))
        print(f"victim p99 FCT: {victim['p99_latency']:.0f} steps   "
              f"Jain(time-avg): {eng.metrics()['jain_timeavg']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
