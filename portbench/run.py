"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  A cell (``BENCHMARK.json``'s ``workloads``)
is a model configuration under a traffic mix.  The run draws the weights
on the card from the seed, serves the mix through the program's
``ServeRuntime`` / ``Engine`` / ``ModelExecutor`` for the mix's warm-up
and then ``--seconds``, checks the served tokens against the plain
reference, and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones read from a profiler trace of the window.  The numbers
compared in the check are the last lines on standard error and the
result's last key.  Without a CUDA card it exits 2 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches at fixed paths inside the checkout; the checkout's packages
    first on the path."""
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from portbench.harness.bench import run_cell
    from portbench.harness.spec import load_cell

    chips = load_cell(ROOT, args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch sees {have}", file=sys.stderr)
        return 2
    res = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), device="cuda", t_process=T_PROCESS,
                   log=lambda *a: print(*a, file=sys.stderr, flush=True))
    return report(res, args.workload, args.seed)


def report(res: dict, workload: str, seed: int) -> int:
    """Print the numbers compared on standard error and the result line
    last on standard output; or, where modules of JAX or the JAX package
    are loaded by now (a metric reader, the check), name them and print
    no result (exit 3)."""
    from portbench.harness.bench import forbidden_modules

    e2e = res["_e2e"]
    print(f"portbench: {workload} seed {seed}: "
          f"{json.dumps(e2e['_counts'])} setup_s={e2e['setup_s']:.3f} "
          f"check_s={res['_check_s']:.3f} "
          f"generator_late_s={res['_max_late']:.4f}", file=sys.stderr)
    found = sorted(set(res["_found"]) | set(forbidden_modules()))
    if found:
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{found}", file=sys.stderr)
        return 3
    for k, v in res["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    line = {k: v for k, v in res.items() if not k.startswith("_")}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
