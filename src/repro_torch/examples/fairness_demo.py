"""Paper-figure playground: run the paper's experiments (Figs. 9, 10,
12, 13) through the unified runtime API and print the OSMOSIS-vs-
reference comparison from the portable RunReports.

    PYTHONPATH=src python -m repro_torch.examples.fairness_demo --exp fig9
    PYTHONPATH=src python -m repro_torch.examples.fairness_demo --exp fig10
    PYTHONPATH=src python -m repro_torch.examples.fairness_demo --exp all

Each experiment is a registered declarative scenario — list them all
with ``python -m repro_torch.launch.scenario --list``.  Host numpy: the
event-loop simulator runs on every machine.
"""
import argparse
import sys

from repro_torch.api import get_scenario, run_scenario


def _run(name, **params):
    return run_scenario(get_scenario(name, **params), "sim")


def fig9():
    print("Fig 9 — PU fairness, 2x-costlier congestor vs victim")
    for sched in ("rr", "wlbvt"):
        r = _run("fig9_congestor_victim", scheduler=sched, duration_us=120)
        print(f"  {sched:6s} Jain={r.jain_pu:.3f}  "
              f"congestor={r.tenants[0].completed}pkts  "
              f"victim={r.tenants[1].completed}pkts")


def fig10():
    print("Fig 10 — HoL-blocking vs fragment size (victim=64B, "
          "congestor=4KiB egress)")
    base = _run("fig10_hol_blocking", frag_mode="off", arb="fifo",
                duration_us=80)
    print(f"  {'off(fifo)':14s} victim p99={base.tenants[1].p99_latency:7.0f}ns  "
          f"congestor={base.tenants[0].throughput:5.1f}Gbit/s")
    for mode in ("software", "hardware"):
        for fb in (512, 2048):
            r = _run("fig10_hol_blocking", frag_mode=mode, frag_bytes=fb,
                     duration_us=80)
            print(f"  {mode + f'({fb}B)':14s} "
                  f"victim p99={r.tenants[1].p99_latency:7.0f}ns  "
                  f"congestor={r.tenants[0].throughput:5.1f}Gbit/s")


def fig12():
    print("Fig 12 — compute-bound mixture (Reduce+Histogram x "
          "victim/congestor)")
    for sched in ("rr", "wlbvt"):
        r = _run("fig12_compute_mixture", scheduler=sched, duration_us=120)
        fct = [round(r.tenants[i].extra["fct"]) for i in range(4)]
        print(f"  {sched:6s} Jain={r.jain_pu:.3f}  FCTs={fct}")


def fig13():
    print("Fig 13 — IO-bound mixture (DMA read/write x victim/congestor)")
    for sched in ("rr", "wlbvt"):
        r = _run("fig13_io_mixture", scheduler=sched, duration_us=120)
        fct = [round(r.tenants[i].extra["fct"]) for i in range(4)]
        print(f"  {sched:6s} Jain_io={r.jain_io:.3f}  FCTs={fct}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="fig9",
                    choices=["fig9", "fig10", "fig12", "fig13", "all"])
    args = ap.parse_args(argv)
    exps = {"fig9": fig9, "fig10": fig10, "fig12": fig12, "fig13": fig13}
    if args.exp == "all":
        for fn in exps.values():
            fn()
            print()
    else:
        exps[args.exp]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
