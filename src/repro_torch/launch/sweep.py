"""Sweep CLI: scenario sweeps on the card (DESIGN.md §13).

Expand a registered scenario into a ``SweepSpec`` (knob axes × seeds),
run every replica as one row of a batched loop on the sweep datapath
(``sim/devicepath.py``; on the card the whole loop of each scheduler
group is one launch of the CUDA kernel ``kernels/csrc/sweep_scan.cu``),
and dump per-replica summary rows.

    PYTHONPATH=src python -m repro_torch.launch.sweep fig9_congestor_victim \
        --axis tenants.0.priority=1,2,4 --seeds 8 --out /tmp/sweep.json
    PYTHONPATH=src python -m repro_torch.launch.sweep fig9_congestor_victim \
        --axis scheduler='"wlbvt","rr"' --seeds 8 --precision fast
    PYTHONPATH=src python -m repro_torch.launch.sweep --spec /tmp/plan.json
    PYTHONPATH=src python -m repro_torch.launch.sweep fig9_congestor_victim \
        --set duration_us=10 --seeds 2 --device cpu

Runs on the card unless ``--device cpu``; without a card it raises.
Axis values parse as JSON where possible (``--axis scheduler='"rr"'``
sweeps a string knob; bare numbers need no quoting).  ``--spec`` loads a
serialized ``SweepSpec`` instead of expanding one from the registry.
Timelines are a host-observability feature, so the base spec always runs
with ``record_timeline=False`` here.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _parse_axis(arg: str):
    """``path=v1,v2,...`` -> SweepAxis; each value JSON-parsed if valid."""
    from repro_torch.api import SweepAxis
    if "=" not in arg:
        raise SystemExit(f"--axis expects path=v1,v2,..., got {arg!r}")
    knob, raw = arg.split("=", 1)
    values = []
    for tok in raw.split(","):
        try:
            values.append(json.loads(tok))
        except json.JSONDecodeError:
            values.append(tok)
    if not values:
        raise SystemExit(f"--axis {knob!r} has no values")
    return SweepAxis(knob=knob, values=tuple(values))


def build_sweep(name: str, params, axes, seeds: int):
    """Registry scenario + parsed axes -> SweepSpec (timeline off)."""
    from repro_torch.api import SweepSpec, get_scenario
    from repro_torch.api.registry import scenario_params
    unknown = set(params) - scenario_params(name)
    if unknown:
        raise SystemExit(
            f"scenario {name!r} takes no parameter(s) "
            f"{', '.join(sorted(unknown))}")
    base = get_scenario(name, **params).replace(record_timeline=False)
    return SweepSpec(name=name, base=base, axes=tuple(axes),
                     seeds=tuple(range(seeds)))


def run_sweep(sweep, *, impl: str = "", precision: str = "exact",
              device="cuda"):
    """Expand + launch; returns ``(summary_rows, elapsed_seconds)``.

    One batched loop per (tenant-count, scheduler) group — a
    ``scheduler`` axis runs one loop per value; every other knob shares
    a single loop.  Row order follows ``replicas()``.
    """
    from repro_torch.serving.serve_step import require_device
    from repro_torch.sim.devicepath import (DevicePathError, device_eligible,
                                            run_sweep_specs)
    dev = require_device(device)
    why = device_eligible(sweep.base)
    if why is not None:
        raise DevicePathError(f"sweep base not device-eligible: {why}")
    pairs = list(sweep.replicas())
    groups = {}
    for idx, (_, spec) in enumerate(pairs):
        groups.setdefault((len(spec.tenants), spec.scheduler),
                          []).append(idx)
    rows = [None] * len(pairs)
    t0 = time.perf_counter()
    for idxs in groups.values():
        results = run_sweep_specs([pairs[i][1] for i in idxs],
                                  impl=impl, precision=precision,
                                  device=dev)
        for i, res in zip(idxs, results):
            rows[i] = res.summary_row(pairs[i][0])
    elapsed = time.perf_counter() - t0
    return rows, elapsed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run a scenario sweep on the sweep datapath")
    ap.add_argument("scenario", nargs="?", default="",
                    help="registered base scenario name")
    ap.add_argument("--spec", default="", metavar="JSON",
                    help="load a serialized SweepSpec instead of a "
                         "registry scenario")
    ap.add_argument("--axis", action="append", default=[],
                    metavar="PATH=V1,V2,...",
                    help="sweep a dotted knob path over values "
                         "(repeatable; e.g. tenants.0.priority=1,2,4)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds 0..N-1 per axis combination (default 1)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="scenario factory parameter (repeatable)")
    ap.add_argument("--impl", default="",
                    choices=["", "jnp", "jnp_ref", "pallas"],
                    help="WLBVT select impl, the JAX package's names: "
                         "'' auto (the CUDA kernel on the card), "
                         "'pallas' the kernel, 'jnp'/'jnp_ref' the plain "
                         "versions (CPU only)")
    ap.add_argument("--precision", default="exact",
                    choices=["exact", "fast"],
                    help="exact = float64 host-parity, fast = float32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the sweep runs (default: the card)")
    ap.add_argument("--out", default="",
                    help="write the sweep summary JSON to this path")
    args = ap.parse_args(argv)

    from repro_torch.api import SweepSpec
    from repro_torch.launch.scenario import _parse_sets

    if args.spec:
        with open(args.spec) as f:
            sweep = SweepSpec.from_dict(json.load(f))
    elif args.scenario:
        sweep = build_sweep(args.scenario, _parse_sets(args.set),
                            [_parse_axis(a) for a in args.axis],
                            args.seeds)
    else:
        raise SystemExit("scenario name or --spec required")

    n = len(sweep)
    axes_desc = " x ".join(f"{ax.knob}[{len(ax.values)}]"
                           for ax in sweep.axes) or "1 combo"
    print(f"sweep {sweep.name}: {n} replica(s) = "
          f"{axes_desc} x {len(sweep.seeds)} seed(s) on {args.device}")
    rows, elapsed = run_sweep(sweep, impl=args.impl,
                              precision=args.precision, device=args.device)
    rate = n / elapsed if elapsed > 0 else float("inf")
    print(f"{n} scenario(s) in {elapsed:.3f}s = {rate:.1f} scenarios/sec "
          f"(includes kernel build on first use)")
    doc = {"sweep": sweep.name, "replicas": n, "elapsed_s": elapsed,
           "scenarios_per_sec": rate, "impl": args.impl,
           "precision": args.precision, "device": args.device,
           "rows": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
    else:
        for row in rows[:8]:
            print(json.dumps(row, sort_keys=True))
        if len(rows) > 8:
            print(f"... {len(rows) - 8} more row(s) (use --out)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
