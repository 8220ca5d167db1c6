"""Find a cell's knee: the highest victim rate at which, with the other
tenants' backlog, the victims' queue does not grow over a window.

    python3 portbench/knee.py --workload <cell> --rates 0.5,1,2 \
        [--seconds 30] [--seed 7]

One process: the weights are drawn and the executor warmed once; each
rate (requests a second over all victim tenants, split evenly) is served
from a fresh engine through the mix's warm-up and a window, and prints
the victims' waiting requests at the window's start and end, their
requests due and granted in the window and their time to first token,
and, by 5 s from the traffic's start, the tokens served and the other
tenants' requests finished (how long the backlog takes to turn over).
Run once when a cell is made; its rate is then fixed in the traffic
file.  Not part of a benchmark run.
"""
import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def waiting(recs, t):
    return sum(r.victim and r.submitted <= t
               and (r.grant is None or r.grant > t) for r in recs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import numpy as np
    from portbench.harness.bench import end_to_end, prepare, serve
    st = prepare(ROOT, args.workload, args.seed)
    victims = [t for t in st.cell.traffic["tenants"] if t.get("victim")]
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(st.cell.traffic)
        for t in mix["tenants"]:
            if t.get("victim"):
                t["arrival"]["rate_per_s"] = rate / len(victims)
        run, drv, _ = serve(st, args.seconds, False, mix=mix)
        e2e = end_to_end(run)
        due = run.victims_due()
        print(json.dumps({
            "rate": rate, "waiting_at_start": waiting(run.recs, run.t0),
            "waiting_at_end": waiting(run.recs, run.t1),
            "due": len(due),
            "granted": sum(r.grant is not None and r.grant <= run.t1
                           for r in due),
            "steps": len(run.steps),
            "tokens_by_5s_from_start": np.bincount(
                [int((t - drv.start) // 5) for r in run.recs
                 for t in r.times if t <= run.t1]).tolist(),
            "others_done_by_5s_from_start": np.bincount(
                [int((r.end - drv.start) // 5) for r in run.recs
                 if not r.victim and r.status == "done"
                 and r.end <= run.t1]).tolist(),
            "step_ms_median": float(np.median(
                [s.t1 - s.t0 for s in run.steps])) * 1e3,
            **{k: v for k, v in e2e.items() if not k.startswith("_")}}),
            flush=True)
        st.inner.reset(np.zeros(st.ecfg.max_slots, bool))
    return 0


if __name__ == "__main__":
    sys.exit(main())
