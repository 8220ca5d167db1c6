"""Multi-tenant serving with OSMOSIS: the paper's Congestor/Victim
experiment (Figs. 9/12) run through the unified runtime API + a real
model.

Three tenants with different SLOs share one continuous-batching engine
(the registered ``serve_three_class`` scenario):
  * tenant 0 "batch"        — long prompts, long outputs (the Congestor)
  * tenant 1 "interactive"  — short prompts, short outputs (the Victim)
  * tenant 2 "premium"      — like interactive but 2x priority

Run with --scheduler rr --arbiter fifo to see the baseline starve the
interactive tenants behind the congestor's prefill fragments.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving
    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \
        --scheduler rr --arbiter fifo --device cpu

The model runs on the card (the default; without a card it raises),
every decode step through the hand-written decode-attention kernel
(``attn_impl="pallas"``); ``--device cpu`` runs its plain version.
"""
import argparse
import dataclasses
import sys

from repro_torch.api import RunReport, ServeRuntime, get_scenario
from repro_torch.configs import smoke_config
from repro_torch.core.events import EventKind
from repro_torch.serving.engine import ModelExecutor


def run(arch: str = "qwen3-8b", scheduler: str = "wlbvt",
        arbiter: str = "dwrr", requests: int = 6, device="cuda",
        cfg=None, params=None) -> RunReport:
    """``serve_three_class`` over ``arch``'s smoke config (or ``cfg``) with
    ``params`` (default: the executor's own random weights, seed 0)."""
    if cfg is None:
        cfg = dataclasses.replace(smoke_config(arch), attn_impl="pallas")
    spec = get_scenario("serve_three_class", scheduler=scheduler,
                        arbiter=arbiter, requests=requests)
    rt = ServeRuntime.from_spec(
        spec, executor=lambda ecfg: ModelExecutor(cfg, ecfg, params=params,
                                                  device=device))
    return rt.run(spec).validate()


def show(rep: RunReport) -> None:
    """The per-tenant console lines."""
    print(f"policy: {rep.scheduler}+{rep.arbiter}   "
          f"Jain(time-avg)={rep.jain_pu:.3f}   steps={rep.duration:.0f}")
    names = {0: "batch(congestor)", 1: "interactive", 2: "premium(2x)"}
    admitted = EventKind.ADMITTED.value
    for t in sorted(rep.tenants):
        r = rep.tenants[t]
        evs = [e["kind"] for e in rep.events
               if e["tenant"] == t and e["kind"] != admitted]
        print(f"  {names[t]:18s} done={r.completed:2d} killed={r.killed} "
              f"mean_fct={r.extra['mean_fct']:6.1f} steps  events={evs[:3]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--scheduler", default="wlbvt", choices=["wlbvt", "rr"])
    ap.add_argument("--arbiter", default="dwrr", choices=["dwrr", "fifo"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    show(run(args.arch, args.scheduler, args.arbiter, args.requests,
             args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
