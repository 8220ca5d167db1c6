"""Serving CLI: multi-tenant OSMOSIS engine over a real model, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \
        --tenants 3 --requests 12 --scheduler wlbvt

Runs a registered serving ScenarioSpec (default ``serve_mixed_slo``: a
2x-priority tenant, a long-prompt congestor, interactive victims)
through the runtime API over a real model executor, with random weights
drawn from ``--seed``, and prints the portable RunReport.  ``--arch`` is
any architecture of ``repro_torch.configs.list_archs()``: the dense
(qwen3-8b, codeqwen1.5-7b, gemma-7b, gemma2-27b), vision-language
(qwen2-vl-72b, text only), MoE/MLA (deepseek-v2-lite-16b,
llama4-maverick-400b-a17b, whose 1.6 TB of f32 parameters fit no card:
``--smoke`` only), recurrent (mamba2-370m, recurrentgemma-2b) and
encoder-decoder (whisper-large-v3: the engine passes no frames, so its
decoder attends the zero cross K/V of a fresh cache, as the JAX
package's engine does) ones.  Under ``attn_impl="pallas"`` the
hand-written CUDA kernels run: decode attention (every attention layer's
decode but MLA's, whose absorbed decode takes the plain path; Whisper's
cross-attention too, over every frame), the SSD scan of Mamba2's prefill
and the RG-LRU scan of RecurrentGemma's prefill.

    --smoke                         # the reduced model
    --device cpu                    # plain versions on the CPU
    --json report.json              # dump the RunReport
"""
from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scenario", default="serve_mixed_slo",
                    help="registered serving scenario to run")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--scheduler", default="wlbvt",
                    choices=["wlbvt", "rr"])
    ap.add_argument("--arbiter", default="dwrr", choices=["dwrr", "fifo"])
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    ap.add_argument("--json", default="",
                    help="dump the RunReport JSON to this path")
    ap.add_argument("--telemetry-report", action="store_true",
                    help="print the per-tenant telemetry plane report")
    args = ap.parse_args(argv)

    from repro_torch.api import ServeRuntime, get_scenario
    from repro_torch.api.registry import scenario_params
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serving.engine import ModelExecutor
    from repro_torch.serving.serve_step import require_device

    device = require_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, attn_impl="pallas")
    # forward each CLI knob only if the scenario's factory takes it;
    # warn when an explicitly-set flag has no effect on this scenario
    knobs = dict(scheduler=args.scheduler, arbiter=args.arbiter,
                 seed=args.seed, tenants=args.tenants,
                 requests=args.requests, max_slots=args.max_slots,
                 max_len=args.max_len, prefill_chunk=args.prefill_chunk,
                 vocab=cfg.vocab_size)
    accepted = scenario_params(args.scenario)
    params = {k: v for k, v in knobs.items() if k in accepted}
    for k in sorted(set(knobs) - accepted - {"vocab"}):
        if getattr(args, k) != ap.get_default(k):
            print(f"warning: --{k.replace('_', '-')} is ignored by "
                  f"scenario {args.scenario!r}")
    spec = get_scenario(args.scenario, **params)
    if "serve" not in spec.backends:
        raise SystemExit(f"scenario {args.scenario!r} has no serving "
                         f"projection (backends: {spec.backends})")

    rt = ServeRuntime.from_spec(
        spec, executor=lambda ecfg: ModelExecutor(
            cfg, ecfg, rng_seed=args.seed, device=device))
    rep = rt.run(spec).validate()

    print(rep.summary())
    print(f"  prefill_chunks={rep.extras['prefill_chunks']}  "
          f"decode_steps={rep.extras['decode_steps']}")
    for t in sorted(rep.tenants):
        r = rep.tenants[t]
        print(f"  {r.name}: done={r.completed} killed={r.killed} "
              f"mean_fct={r.extra['mean_fct']:.1f} steps")
    if args.json:
        rep.save(args.json)
        print(f"wrote {args.json}")
    if args.telemetry_report:
        from repro_torch.telemetry import format_console
        print(format_console(rt.engine.telemetry_report(),
                             time_unit=rep.time_unit))
    return 0


if __name__ == "__main__":
    sys.exit(main())
