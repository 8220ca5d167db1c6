"""The readings a cell's correctness limit is set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 30] [--control-seeds 2]

For each seed, one run as the benchmark makes it (weights from the seed,
the mix's warm-up, a window of ``--seconds``, the seed's sample of the
requests it finished), then at every sampled position two readings
against the fp32 reference: the gap of the token the program served
(the number the benchmark compares) and the gap of the token that the
reference computed one precision lower (fp8 weight products: the
control) puts first.  One JSON line a seed with the widest of each.  All
seeds run in one process.  Not part of a benchmark run.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--control-seeds", type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import check as CHK
    from portbench.harness.bench import prepare, release, serve
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control_seeds is None \
        else args.control_seeds
    for k, seed in enumerate(seeds):
        st = prepare(ROOT, args.workload, seed)
        run, drv, _ = serve(st, args.seconds, False)
        release(st, drv)
        chk = st.cell.config["check"]
        t_chk = time.perf_counter()
        sample = CHK.draw_sample(run.recs, seed, run.t0, run.t1,
                                 chk["sample_tokens"], chk["sample_requests"])
        gp = CHK.gaps(st.cell.reference(), st.W, st.cell.pub, sample,
                      st.dev, control=k < n_control)
        check_s = time.perf_counter() - t_chk
        print(json.dumps({
            "seed": seed, "phases": st.phases, "check_s": check_s,
            "served": CHK.widest(gp["served"]),
            "control": CHK.widest(gp["control"]),
            "sample": [[s.tenant, len(s.prompt), len(s.served)]
                       for s in sample],
            "tokens": int(sum(len(s.served) for s in sample)),
            "requests": len(sample),
            "served_by_request": [float(g.max()) for g in gp["served"]],
            "control_by_request": [float(g.max()) for g in gp["control"]],
            "control_median": float(torch.tensor(
                [float(x) for g in gp["control"] for x in g]).median())
            if gp["control"] else None}), flush=True)
        del st, run, drv, gp, sample
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
