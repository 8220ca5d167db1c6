#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; without a card it exits non-zero and
prints no result.  Phases, each of which raises on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all at once), printing ``-Xptxas -v``;
  3. hold each kernel against its plain PyTorch version on the card:
     decode attention at the serving shapes (B 8, T 256, 32 query heads
     on 8 KV heads of dim 128) in bf16 and fp32, lengths 0, 1, T and
     ragged, plus windowed, soft-capped and T % 32 != 0 cases
     (tolerances 2e-5 fp32, 2e-2 bf16);
  4. time each kernel (CUDA events over many launches after warm-up, K/V
     rotated through more buffers than the 50 MB L2 holds, as the 36
     layers' caches are on the main path) beside its least time from
     bytes, its plain version, and one PyTorch call that computes the same
     function (``scaled_dot_product_attention`` with an explicit mask,
     timed here only), at T 256 and T 4096;
  5. the main path: full-width, full-depth Qwen3-8B with random weights
     from a seed serves ``serve_mixed_slo`` (3 tenants, 12 requests,
     8 slots, max_len 256, prefill chunk 32) through ``ServeRuntime`` +
     ``ModelExecutor``; every request must end done and the decode kernel
     must have run 36 times per decode step;
  6. correctness of the served model: on a small fp32 model the kernel
     path gives the plain path's logits (1e-4) and greedy tokens; at full
     width one decode step's logits are finite, of shape (8, 151936), and
     agree with the plain path's;
  7. a profile of one full-width decode step: device time by kernel;
  8. the WLBVT dispatch kernel against its plain version, bit for bit
     on picks, ql' and co': float32 and float64, R 1/7/256/4096, T
     2/8/128, max_picks 1/4/16/128, random and integer priorities, ties
     (every metric 0), free_k 0, empty rows; T 129 and max_picks 129
     raise;
  9. its time (CUDA events around CUDA-graph replays, and launched
     eagerly from Python) beside its plain version and its least time
     from bytes, at the sweep shape (R 256, T 8, max_picks 1, float64
     and float32) and at R 4096, T 128, max_picks 32 (float32); no
     single PyTorch call computes it, so it has no library time;
 10. the sweep datapath at full size in exact mode through
     ``launch.sweep.run_sweep``: the JAX package's headline mix (8
     tenants, 24 us, 256 seeds) and ``fig9_congestor_victim`` at its
     published defaults (300 us) under wlbvt and rr, 8 seeds each.  The
     kernel must have run once per wlbvt scan step; every replica's
     arrivals must equal completed + killed + drops (a drained run
     leaves nothing queued); the card's rows must equal the port's CPU
     rows on the first 8 mix replicas and fig9 seed 0 under wlbvt; then
     a profile of scan steps of the mix, launched eagerly and as the
     CUDA-graph replays the sweep runs by default.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.api import (ArrivalSpec, ScenarioSpec, ServeRuntime,  # noqa: E402
                             SweepAxis, SweepSpec, TenantSpec, WorkloadSpec,
                             build_traces, get_scenario)
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                    wlbvt_select_rounds_ref)
from repro_torch.kernels.wlbvt_select import wlbvt_select_cuda  # noqa: E402
from repro_torch.launch import sweep as sweep_cli  # noqa: E402
from repro_torch.launch.sweep import build_sweep, run_sweep  # noqa: E402
from repro_torch.serving.engine import ModelExecutor  # noqa: E402
from repro_torch.serving.request import RequestStatus  # noqa: E402

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2**20
SERVE = dict(B=8, T=256, Hq=32, Hkv=8, D=128)
SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------
def attn_inputs(B, T, Hq, Hkv, D, lengths, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, 1, Hq, D), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def check_decode_attention() -> float:
    """Returns the max |kernel - plain| of the serving case in bf16."""
    S = SERVE
    T = S["T"]
    ragged = [0, 1, T, 7, 100, 129, 64, T - 1]
    cases = [
        ("serve", dict(S), ragged, 0, 0.0),
        ("window", dict(S), ragged, 64, 0.0),
        ("softcap", dict(S), ragged, 0, 30.0),
        ("T%32!=0", dict(S, T=250), [0, 1, 250, 7, 100, 129, 64, 249], 0,
         0.0),
        ("window+cap", dict(S, T=250), [250, 3, 31, 33, 0, 200, 64, 1], 40,
         20.0),
    ]
    serve_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, shp, lengths, win, cap) in enumerate(cases):
            q, k, v, lens = attn_inputs(**shp, lengths=lengths, dtype=dtype,
                                        seed=SEED + i)
            scale = 1.0 / math.sqrt(shp["D"])
            got = decode_attention_cuda(q, k, v, lens, scale=scale,
                                        window=win, cap=cap)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lens, scale=scale,
                                        window=win, cap=cap)
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), atol=TOL[dtype],
                                rtol=TOL[dtype])
            empty_zero = bool(torch.all(got[lens <= 0] == 0))
            log(f"check decode_attention {name:<10} {str(dtype):<15} "
                f"max_abs_err={err:.3e} tol={TOL[dtype]:g} "
                f"empty_rows_zero={empty_zero}")
            if not (ok and empty_zero and torch.isfinite(got).all()):
                raise AssertionError(f"decode_attention {name} {dtype}: "
                                     f"kernel disagrees with plain version")
            if name == "serve" and dtype == torch.bfloat16:
                serve_err = err
    return serve_err


# ---------------------------------------------------------------------------
# phase 4: timing
# ---------------------------------------------------------------------------
def event_ms(fn, argsets, iters) -> float:
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_decode_attention(T: int, iters: int) -> dict:
    S = dict(SERVE, T=T)
    B, Hq, Hkv, D = S["B"], S["Hq"], S["Hkv"], S["D"]
    dtype, G = torch.bfloat16, S["Hq"] // S["Hkv"]
    lengths = [T] * B
    pair_bytes = 2 * B * T * Hkv * D * 2
    nbuf = max(2, math.ceil(4 * L2_BYTES / pair_bytes))
    sets = [attn_inputs(**S, lengths=lengths, dtype=dtype, seed=100 + i)
            for i in range(nbuf)]
    scale = 1.0 / math.sqrt(D)

    def kernel(q, k, v, lens):
        return decode_attention_cuda(q, k, v, lens, scale=scale)

    def plain(q, k, v, lens):
        return decode_attention_ref(q, k, v, lens, scale=scale)

    masks = [(torch.arange(T, device="cuda")[None, :] < lens[:, None])
             [:, None, None, :] for (_, _, _, lens) in sets]
    lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), m)
                for (q, k, v, _), m in zip(sets, masks)]

    def library(q, k, v, mask):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    # the yardstick computes the same function: check it once
    lib_out = library(*lib_sets[0]).transpose(1, 2)
    ker_out = kernel(*sets[0])
    lib_err = (lib_out.float() - ker_out.float()).abs().max().item()
    if lib_err > TOL[dtype]:
        raise AssertionError(f"library yardstick disagrees: {lib_err}")

    ms = event_ms(kernel, sets, iters)
    plain_ms = event_ms(plain, sets, max(iters // 10, 5))
    library_ms = event_ms(library, lib_sets, iters)
    kv_elems = sum(min(n, T) for n in lengths) * Hkv * D   # K (and V) read
    nbytes = 2 * kv_elems * 2 + 2 * (B * Hq * D * 2) + B * 4   # + q, out, lens
    flops = 2 * 2 * G * kv_elems          # one MAC per query row, QK and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(T=T, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf)


# ---------------------------------------------------------------------------
# phases 5-7: the served model
# ---------------------------------------------------------------------------
def serve(cfg, seed: int):
    spec = get_scenario("serve_mixed_slo", tenants=3, requests=12,
                        max_slots=8, max_len=256, prefill_chunk=32,
                        vocab=cfg.vocab_size, seed=seed)
    (rt, init_s) = sync_time(lambda: ServeRuntime.from_spec(
        spec, executor=lambda e: ModelExecutor(cfg, e, rng_seed=seed,
                                               device="cuda")))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rep, wall = sync_time(lambda: rt.run(spec).validate())
    launches = dict(ops.LAUNCHES)
    return rt, rep, wall, init_s, launches


def with_impl(module, impl: str):
    module.cfg = dataclasses.replace(module.cfg, attn_impl=impl)
    return module


def prefill_and_decode(ex, prompts, impl: str, steps: int):
    """Fresh cache; one prefill chunk of ``prompts`` (B, C); ``steps``
    greedy decode steps with ``impl``.  Returns the per-step logits."""
    module, model = ex.params, ex.fns.model
    B, C = prompts.shape
    cache = ex.fns.init_cache()
    lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
    valid_n = torch.full((B,), C, dtype=torch.int32, device="cuda")
    with torch.no_grad():
        with_impl(module, "chunked")
        nxt, _, cache = ex.fns.prefill_chunk(module, cache, prompts, lengths,
                                             valid_n)
        with_impl(module, impl)
        lengths = valid_n.clone()
        active = torch.ones(B, dtype=torch.bool, device="cuda")
        out = []
        for _ in range(steps):
            logits, cache = model.decode_step(module, nxt[:, None], cache,
                                              lengths, valid=active[:, None])
            out.append(logits[:, -1])
            nxt = logits[:, -1].argmax(-1).to(torch.int32)
            lengths = lengths + 1
    with_impl(module, "pallas")
    return out


def check_small_model() -> None:
    """fp32 smoke model on the card: kernel path == plain path."""
    from repro_torch.serving.engine import EngineConfig
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                              num_heads=8, attn_impl="pallas")
    ex = ModelExecutor(cfg, EngineConfig(max_slots=4, max_len=64),
                       rng_seed=SEED, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    prompts = torch.randint(1, cfg.vocab_size, (4, 16), generator=g,
                            device="cuda", dtype=torch.int32)
    ker = prefill_and_decode(ex, prompts, "pallas", steps=4)
    plain = prefill_and_decode(ex, prompts, "naive", steps=4)
    for i, (a, b) in enumerate(zip(ker, plain)):
        err = (a - b).abs().max().item()
        same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
        log(f"check small fp32 model decode {i}: max_abs_err={err:.3e} "
            f"tol=1e-4 greedy_tokens_equal={same}")
        if err > 1e-4 or not same:
            raise AssertionError("small model: kernel path disagrees")


def check_full_width(ex, vocab: int) -> None:
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(1, vocab, (8, 32), generator=g, device="cuda",
                            dtype=torch.int32)
    ker = prefill_and_decode(ex, prompts, "pallas", steps=1)[0]
    plain = prefill_and_decode(ex, prompts, "naive", steps=1)[0]
    if ker.shape != (8, vocab) or not torch.isfinite(ker).all():
        raise AssertionError(f"full-width logits: shape {tuple(ker.shape)}, "
                             f"finite={bool(torch.isfinite(ker).all())}")
    err = (ker - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (ker.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # bf16 through 36 layers: the two paths round q*scale and the
    # probabilities at different points; hold them to 5% of the logit range
    log(f"check full-width decode logits: shape={tuple(ker.shape)} finite "
        f"max_abs_err={err:.4g} max_abs_logit={scale:.4g} "
        f"greedy_agreement={agree:.3f}")
    if err > 0.05 * scale:
        raise AssertionError("full-width decode: kernel path disagrees")


def profile_decode(ex) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = 8
    tokens = np.ones(B, np.int32)
    lengths = np.full(B, 128, np.int32)
    active = np.ones(B, bool)
    ex.decode(tokens, lengths, active)              # warm
    _, wall = sync_time(lambda: [ex.decode(tokens, lengths, active)
                                 for _ in range(5)])
    step_ms = wall / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            ex.decode(tokens, lengths, active)
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 2 / 1e3
    log(f"profile: full-width decode step wall {step_ms:.3f} ms (host "
        f"clock, mean of 5), device time {total:.3f} ms (sum of kernel "
        f"self time, mean of 2 profiled steps), idle share "
        f"{1 - total / step_ms:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile:   {e.self_device_time_total / 2 / 1e3:9.3f} ms  "
            f"{e.count // 2:5d}x  {e.key[:90]}")


# ---------------------------------------------------------------------------
# phases 8-10: the WLBVT dispatch kernel and the sweep datapath
# ---------------------------------------------------------------------------
PEAK_FLOPS_F64 = 34e12               # H100 SXM FP64 outside the tensor cores
SELECT_PUS = 32                      # PsPIN PUs: the sweep's num_pus


def select_inputs(R, T, dtype, seed, kind="rand"):
    """[R, T] round inputs on the card from a numpy seed.  ``kind``:
    rand (random priorities), int (integer priorities), ties (every
    metric 0, as at t = 0), free0 (no PU grantable), empty (half the
    rows have no queued packet)."""
    rng = np.random.RandomState(seed)
    prio = (rng.randint(1, 5, (R, T)) if kind == "int"
            else rng.uniform(0.5, 4.0, (R, T)))
    ql = rng.randint(0, 6, (R, T))
    co = rng.randint(0, 3, (R, T))
    to = rng.uniform(0.0, 5e4, (R, T))
    bvt = rng.uniform(0.0, 2e4, (R, T))
    free = rng.randint(0, SELECT_PUS + 1, (R,))
    if kind == "ties":
        to[:] = 0.0
        bvt[:] = 0.0
    if kind == "free0":
        free[:] = 0
    if kind == "empty":
        ql[::2] = 0

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device="cuda")
    return (dev(prio, dtype), dev(ql, torch.int32), dev(co, torch.int32),
            dev(to, dtype), dev(bvt, dtype), dev(free, torch.int32))


def check_wlbvt_select() -> float:
    """Kernel == plain version, bit for bit, on picks, ql' and co'.
    Returns the max |kernel - plain| over every output (0 when exact)."""
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.float64):
        for R in (1, 7, 256, 4096):
            for T in (2, 8, 128):
                for mp in (1, 4, 16, 128):
                    kinds = ["rand", "int"] if R > 1 else ["rand"]
                    if R == 256 and mp == 4:
                        kinds += ["ties", "free0", "empty"]
                    for kind in kinds:
                        args = select_inputs(R, T, dtype,
                                             seed=R * 1000 + T + mp,
                                             kind=kind)
                        got = wlbvt_select_cuda(*args, num_pus=SELECT_PUS,
                                                max_picks=mp)
                        torch.cuda.synchronize()
                        want = wlbvt_select_rounds_ref(
                            *args, num_pus=SELECT_PUS, max_picks=mp)
                        err = max((a.long() - b.long()).abs().max().item()
                                  for a, b in zip(got, want))
                        worst = max(worst, float(err))
                        n += 1
                        if err != 0:
                            raise AssertionError(
                                f"wlbvt_select {dtype} R={R} T={T} "
                                f"max_picks={mp} {kind}: kernel != plain "
                                f"(max |diff| {err})")
    for T, mp in ((129, 1), (8, 129)):
        args = select_inputs(2, T, torch.float32, seed=0)
        try:
            wlbvt_select_cuda(*args, num_pus=SELECT_PUS, max_picks=mp)
        except ValueError as e:
            log(f"check wlbvt_select T={T} max_picks={mp} raises: {e}")
        else:
            raise AssertionError(f"wlbvt_select T={T} max_picks={mp} "
                                 "did not raise")
    log(f"check wlbvt_select: {n} cases (float32 and float64, R 1/7/256/"
        f"4096, T 2/8/128, max_picks 1/4/16/128, random/integer "
        f"priorities, ties, free_k 0, empty rows) bit-exact, "
        f"max_abs_err={worst:g}")
    return worst


def graph_ms(fn, per_graph: int, replays: int) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    launch cost is out of the measurement."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def time_wlbvt_select(R, T, mp, dtype, iters) -> dict:
    """Device time per call (CUDA-graph replays, as the sweep runs it)
    and the time per call launched eagerly from Python (CUDA events over
    ``iters`` launches after warm-up).  The inputs stay in L2, as in the
    sweep step, where the ops just before the kernel wrote them."""
    args = select_inputs(R, T, dtype, seed=1)

    def kernel():
        return wlbvt_select_cuda(*args, num_pus=SELECT_PUS, max_picks=mp)

    def plain():
        return wlbvt_select_rounds_ref(*args, num_pus=SELECT_PUS,
                                       max_picks=mp)

    picks = kernel()[0]
    ms = graph_ms(kernel, 100, 20)
    plain_ms = graph_ms(plain, max(100 // mp, 2), 10)
    eager_ms = event_ms(kernel, [()], iters)
    fsize = torch.finfo(dtype).bits // 8
    # three float and two int32 [R,T] arrays and free_k read once; picks,
    # ql' and co' written once
    nbytes = 3 * R * T * fsize + 2 * R * T * 4 + R * 4 + R * mp * 4 \
        + 2 * R * T * 4
    # picks this run's data needs: a row stops at its first -1
    granted = (picks >= 0).sum(dim=1)
    evaluated = torch.clamp(granted + 1, max=mp).sum().item()
    # per lane: 2 divisions for the hoisted metric; per evaluated pick
    # and lane: the psum add, mul, div, sub, ceil, the limit compare and
    # the argmin compare
    flops = R * T * 2 + evaluated * T * 7
    peak = PEAK_FLOPS_F64 if dtype == torch.float64 else PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(R=R, T=T, max_picks=mp, dtype=str(dtype).split(".")[-1],
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, library_ms=None)


def mix_spec(T: int, duration_us: float, seed: int = 0):
    """The JAX package's headline sweep mix (benchmarks/sweep_throughput.py
    ``_mix_spec``): distinct cost slope, packet size and priority per
    tenant, so no two scheduler lanes look alike."""
    tens = tuple(
        TenantSpec(
            f"t{i}",
            workload=WorkloadSpec(name=f"w{i}", compute_base=40.0,
                                  compute_per_byte=0.3 + 0.05 * (i % 7)),
            arrival=ArrivalSpec(size=256 + 64 * (i % 5), share=1.0 / T,
                                seed_offset=i),
            priority=1.0 + (i % 3))
        for i in range(T))
    return ScenarioSpec(name=f"sweep_mix_T{T}", tenants=tens,
                        duration_us=duration_us, seed=seed)


def scan_steps(specs) -> tuple:
    """(S, packets) of one batched loop: S = 2 max(n_live) + 2 steps, as
    the sweep datapath sizes it, and the packets of all replicas."""
    n = [len(build_traces(s, arrays=True)) for s in specs]
    return 2 * max(n) + 2, sum(n)


def run_sweep_leg(name, sweep):
    """The main path: ``run_sweep`` on the card, launches counted."""
    pairs = list(sweep.replicas())
    groups = {}
    for _, spec in pairs:
        groups.setdefault(spec.scheduler, []).append(spec)
    steps = {k: scan_steps(v) for k, v in groups.items()}
    ops.reset_launches()
    (rows, wall) = sync_time(lambda: run_sweep(sweep, device="cuda")[0])
    launches = ops.LAUNCHES["wlbvt_select"]
    want = steps.get("wlbvt", (0, 0))[0]
    S_all = sum(S for S, _ in steps.values())
    pkts = sum(p for _, p in steps.values())
    log(f"sweep {name}: {len(rows)} replicas, {S_all} scan steps "
        f"({', '.join(f'{k} S={v[0]}' for k, v in steps.items())}), "
        f"{pkts} packets, wall_s={wall:.3f} scenarios_per_s="
        f"{len(rows) / wall:.3f} packets_per_s={pkts / wall:.1f} "
        f"ms_per_scan_step={wall / S_all * 1e3:.4f} "
        f"wlbvt_select_launches={launches}")
    if launches != want:
        raise AssertionError(f"{name}: wlbvt_select launches {launches} != "
                             f"wlbvt scan steps {want}")
    for (knobs, spec), row in zip(pairs, rows):
        arrivals = np.bincount(build_traces(spec, arrays=True).tenants,
                               minlength=len(spec.tenants))
        for i, t in enumerate(row["tenants"]):
            queued = arrivals[i] - (t["completed"] + t["killed"]
                                    + t["drops"])
            if queued != 0 or not all(
                    math.isfinite(t[k]) for k in ("throughput_gbps",
                                                  "p50_kernel_ns",
                                                  "p99_kernel_ns")):
                raise AssertionError(
                    f"{name} {knobs} tenant {i}: {arrivals[i]} arrivals "
                    f"!= completed + killed + drops ({t}); a drained run "
                    f"leaves nothing queued")
    return rows, launches, wall, S_all


def check_rows_against_cpu(name, sweep, rows) -> None:
    """The card's exact rows == the port's CPU run of the same code."""
    cpu_rows = run_sweep(sweep, device="cpu")[0]
    for i, (got, want) in enumerate(zip(rows, cpu_rows)):
        if got != want:
            raise AssertionError(f"{name} replica {i}: card row {got} != "
                                 f"CPU row {want}")
    log(f"check {name}: card rows == CPU rows, field for field, on "
        f"{len(cpu_rows)} replica(s) {[r['knobs'] for r in cpu_rows]}")


def profile_sweep_step() -> None:
    """Where the mix's sweep time goes.  First the whole sweep in the
    stages of ``devicepath._run_batch``, each on the host clock: traces
    and replica arrays (host numpy), the copy to the card, the scan loop
    (capture included), the results back to the host and their
    materialisation.  Then device time by kernel over scan steps launched
    eagerly and as CUDA-graph replays (the sweep's default); a replayed
    step's wall time is the difference of two runs of different lengths
    over their difference in steps, so the capture's one-off cost
    cancels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import devicepath as DP
    specs = [dataclasses.replace(mix_spec(8, 24.0), seed=s)
             for s in range(256)]
    per_spec, t_arrays = sync_time(
        lambda: [DP._spec_arrays(s, np.float64) for s in specs])
    (data, n_arr, NB), t_copy = sync_time(
        lambda: DP._stack_data(per_spec, np.float64, "cuda"))
    C = max(1, min(max(s.fifo_capacity for s in specs), NB))
    P = DP.PSPIN.num_pus
    B = DP.GRAPH_STEPS
    S = 2 * max(a["n_live"] for a in per_spec) + 2

    def run(steps, graph_steps):
        state = DP._init_state(len(specs), 8, P, C, NB, n_arr, np.float64,
                               "cuda")
        with torch.inference_mode():
            return DP._build_launch(8, P, C, steps, "wlbvt", "",
                                    graph_steps=graph_steps)(state, data)

    (fin, ys), t_loop = sync_time(lambda: run(S, B))

    def results():
        fin_np = {k: v.cpu().numpy() for k, v in fin.items()}
        ys_np = tuple(y.cpu().numpy() for y in ys)
        return [DP._materialize(s, per_spec[r], fin_np, ys_np, r, False)
                for r, s in enumerate(specs)]

    _, t_results = sync_time(results)
    log(f"profile: sweep mix R=256 T=8 float64 S={S}, stages (host clock): "
        f"traces and replica arrays {t_arrays:.3f} s, copy to card "
        f"{t_copy:.3f} s, scan loop {t_loop:.3f} s ({t_loop / S * 1e3:.4f} "
        f"ms/step, capture included), results to host and materialised "
        f"{t_results:.3f} s")
    for name, steps, gs, short in (("eager", 200, 0, 0),
                                   ("graph", 2 + 20 * B, B, 2 + 4 * B)):
        run(steps, gs)
        _, wall = sync_time(lambda: run(steps, gs))
        step_s = wall / steps
        if short:
            _, wall_short = sync_time(lambda: run(short, gs))
            step_s = (wall - wall_short) / (steps - short)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(steps, gs)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        # self_device_time_total is in us: seconds of device time per step
        dev_s = sum(e.self_device_time_total for e in rows) / 1e6 / steps
        sel_s = sum(e.self_device_time_total for e in rows
                    if "wlbvt_select" in e.key) / 1e6 / steps
        launches = sum(e.count for e in rows)
        log(f"profile: sweep mix R=256 T=8 float64, {steps} scan steps "
            f"{name}: wall {step_s * 1e3:.4f} ms/step (host clock), "
            f"device {dev_s * 1e6:.2f} us/step over {launches / steps:.1f} "
            f"kernels/step, idle share {1 - dev_s / step_s:.3f}, "
            f"wlbvt_select share of device time {sel_s / dev_s:.3f} "
            f"({sel_s * 1e6:.2f} us/step)")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"profile:   {e.self_device_time_total / steps:8.3f} "
                f"us/step  {e.count / steps:5.1f}x  {e.key[:90]}")


def sweep_phase():
    """Phase 10: the sweep datapath at full size, exact mode, on the card."""
    mix = SweepSpec(name="sweep_mix_T8", base=mix_spec(8, 24.0),
                    seeds=tuple(range(256)))
    fig9 = build_sweep("fig9_congestor_victim", {},
                       [SweepAxis("scheduler", ("wlbvt", "rr"))], 8)
    mix_rows, mix_launches, _, _ = run_sweep_leg("mix", mix)
    fig9_rows, fig9_launches, _, _ = run_sweep_leg("fig9", fig9)
    for sched in ("wlbvt", "rr"):
        jain = [r["jain_pu_timeavg"] for r in fig9_rows
                if r["knobs"]["scheduler"] == sched]
        log(f"sweep fig9 {sched}: jain_pu_timeavg per seed "
            f"{[round(j, 6) for j in jain]} mean {np.mean(jain):.6f}")
    # the CLI runs on the card by default
    out = ROOT / "build" / "chip_smoke_sweep.json"
    sweep_cli.main(["fig9_congestor_victim", "--set", "duration_us=10",
                    "--axis", "tenants.0.priority=1,2", "--seeds", "2",
                    "--out", str(out)])
    doc = json.loads(out.read_text())
    if doc["device"] != "cuda" or len(doc["rows"]) != 4:
        raise AssertionError(f"sweep CLI: {doc['device']}, "
                             f"{len(doc['rows'])} rows")
    check_rows_against_cpu(
        "mix", dataclasses.replace(mix, seeds=tuple(range(8))), mix_rows[:8])
    check_rows_against_cpu(
        "fig9", dataclasses.replace(fig9, axes=(
            SweepAxis("scheduler", ("wlbvt",)),), seeds=(0,)), fig9_rows[:1])
    profile_sweep_step()
    return mix_launches + fig9_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    logs, build_s = sync_time(kbuild.build)
    for name, text in logs.items():
        log(f"build {name}: nvcc -Xptxas -v")
        for line in text.strip().splitlines():
            log(f"  {line}")
    log(f"build: {len(kbuild.sources())} sources in {build_s:.1f} s")

    err = check_decode_attention()
    timings = [time_decode_attention(T, iters)
               for T, iters in ((256, 2000), (4096, 200))]
    for t in timings:
        log("time decode_attention bf16 B=8 Hq=32 Hkv=8 D=128 " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in t.items()))
    check_small_model()

    cfg = dataclasses.replace(get_config("qwen3-8b"), attn_impl="pallas")
    rt, rep, wall, init_s, launches = serve(cfg, SEED)
    done = rt.engine.done
    decode_steps = rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    peak = torch.cuda.max_memory_allocated()
    log(f"serve qwen3-8b: layers={cfg.num_layers} d_model={cfg.d_model} "
        f"init_s={init_s:.2f} steps={int(rep.duration)} "
        f"prefill_chunks={rep.extras['prefill_chunks']} "
        f"decode_steps={decode_steps} wall_s={wall:.3f} "
        f"generated_tokens={generated} tokens_per_s={generated / wall:.2f} "
        f"max_memory_allocated={peak}")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError("not every request ended done: " + str(
            [(r.rid, r.status.value) for r in done]))
    if launches["decode_attention"] != cfg.num_layers * decode_steps:
        raise AssertionError(f"decode_attention launches "
                             f"{launches['decode_attention']} != "
                             f"{cfg.num_layers} x {decode_steps}")
    ex = rt.engine.exe
    check_full_width(ex, cfg.vocab_size)
    profile_decode(ex)
    del rt, ex
    torch.cuda.empty_cache()

    sel_err = check_wlbvt_select()
    sel_times = [time_wlbvt_select(256, 8, 1, torch.float64, 5000),
                 time_wlbvt_select(256, 8, 1, torch.float32, 5000),
                 time_wlbvt_select(4096, 128, 32, torch.float32, 500)]
    for st in sel_times:
        log("time wlbvt_select (ms: CUDA-graph replays; eager_ms: launched "
            "from Python) " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in st.items()))
    sel_launches = sweep_phase()

    t = timings[0]
    st = sel_times[0]
    log(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:23",
        "launches": launches["decode_attention"], "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}, {
        "name": "wlbvt_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wlbvt_select.cu",
        "replaces": "src/repro/kernels/wlbvt_select.py:114",
        "launches": sel_launches, "max_abs_err": sel_err,
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
