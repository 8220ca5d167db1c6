#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the card.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; without a card it exits non-zero and
prints no result.  Phases, each of which raises on failure:

  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
     nvcc per source, all at once), printing ``-Xptxas -v`` and, for every
     head-dim-256 kernel, its registers and spills; count the HGMMA
     (``wgmma``) instructions of the flash libraries with ``cuobjdump
     --dump-sass`` and fail if a bf16 flash kernel has none (the forward
     at head dims 16-256, the backward at 16-128: at 256 the bf16
     backward is the scalar kernel);
  3. hold each kernel against its plain PyTorch version on the card:
     decode attention at the serving shapes (B 8, T 256, 32 query heads
     on 8 KV heads of dim 128) in bf16 and fp32, lengths 0, 1, T and
     ragged, plus windowed, soft-capped and T % 32 != 0 cases, and
     RecurrentGemma-2B's heads (10 on 1 KV head of 256, window 2048) by
     index and by stored positions, wrapped rings of 64 entries with
     stored positions, RecurrentGemma's full 2048-entry ring wrapped
     (lengths 2049-4000) and Qwen3's heads over T 4096 (tolerances 2e-5
     fp32, 2e-2 bf16; empty rows exactly 0);
  4. time the decode kernel and one PyTorch call that computes the same
     function (``scaled_dot_product_attention`` with an explicit mask,
     timed here only; the kernels it ran, from a profile, are logged) as
     CUDA-graph replays (``ms``, ``library_ms``) and launched eagerly
     from Python (``eager_ms``, ``library_eager_ms``), K/V rotated through
     more buffers than the 50 MB L2 holds (as the layers' caches are on
     the main path), beside its least time from bytes and its plain
     version: Qwen3's heads at T 256 and T 4096, RecurrentGemma's at T
     256 and on its wrapped 2048-entry ring (stored positions);
  5. the main path: full-width, full-depth Qwen3-8B with random weights
     from a seed serves ``serve_mixed_slo`` (3 tenants, 12 requests,
     8 slots, max_len 256, prefill chunk 32) through ``ServeRuntime`` +
     ``ModelExecutor``; every request must end done and the decode kernel
     must have run 36 times per decode step;
  6. correctness of the served model: on a small fp32 model the kernel
     path gives the plain path's logits (1e-4) and greedy tokens; at full
     width one decode step's logits are finite, of shape (8, 151936), and
     agree with the plain path's;
  7. a profile of one full-width decode step: device time by kernel, and
     the decode kernel's time per launch and share of the step;
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

 11. the flash-attention kernels against their plain versions on the card:
     the forward (output and log-sum-exp) and the backward (dq, dk, dv,
     against the plain backward and against autograd of the plain
     forward) on the cases of tests/test_kernels.py, causal off, the bf16
     kernels' edges (S * G and T off their 128-row tiles, G = 3 and 8,
     head dims 16 to 128, a window shorter than a tile, a cap with a
     window, non-causal T != S), head dim 256 with RecurrentGemma-2B's
     10 heads on 1 (ragged, a window, a cap with a window, and its
     cache-free shape S 4096, window 2048), q/k/v as slices of one fused
     buffer, and Qwen3-8B's heads (32 on 8 KV heads of dim 128) at S
     1024, in bf16
     (the wgmma kernels) and fp32 (the scalar kernels) (forward 2e-5
     fp32 / 2e-2 bf16 absolute, lse 1e-4; gradients max |diff| <= 1e-4
     fp32 / 2e-2 bf16 times max |reference|); a head dim of 48 and a
     misaligned address raise;
 12. their times at the training shape (B 4, S = T 1024, 32 / 8 heads of
     dim 128, causal, bf16) and at RecurrentGemma-2B's cache-free
     attention (B 1, S = T 4096, 10 / 1 heads of 256, window 2048):
     forward, backward and forward + backward of the kernels, the plain
     versions and ``scaled_dot_product_attention`` (timed here only),
     each beside its least time, with the achieved TFLOP/s and the share
     of the bound;
 13. the training path: Qwen3-8B's published widths with the depth cut
     to 8 of 36 layers, random weights from seed 0, f32 parameters and
     bf16 compute, AdamW, full remat, ``SyntheticLM`` batches of 4 x 1024,
     5 steps through ``launch.train.run_training``; every attention call
     goes through the two kernels (2 x 8 forward and 8 backward launches
     a step under full remat); the first loss is finite and near
     ln(151936); then the same first 2 steps on the plain ``chunked``
     attention give the same losses (1e-2 relative);
 14. (run after phase 7) the SSD scan kernel against its plain version:
     tests/test_kernels.py's three shapes (groups, ragged chunks; B/C in
     fp32) with and without an initial state, Mamba2-370M's serve shape
     (B 8, S 32, 32 heads of 64, state 128, chunk 256: Q 32) with a
     state, and a cache-free run at its widths (B 4, S 1024: four chunks
     of 256 rows, sub-tiled), in bf16 and fp32 (5e-2 / 1e-3); the RG-LRU
     scan kernel on tests/test_kernels.py's three shapes with and
     without h0 and the serve shape (B 8, S 32, W 2560) with h0 (1e-5);
 15. their device times (CUDA-graph replays, inputs rotated past the
     L2) and eager times, beside their plain versions and their least
     time from bytes or operations; no single PyTorch call computes
     either, so neither has a library time;
 16. small fp32 Mamba2 and RecurrentGemma models on the card: the kernel
     path gives the ``chunked`` path's logits (1e-4) over a ragged
     two-chunk prefill and 16 decode steps that wrap the local ring;
 17. the recurrent families' main path: Mamba2-370M and RecurrentGemma-2B
     at full width and depth, random weights from a seed, serve
     ``serve_mixed_slo`` as in phase 5; every request must end done and
     the launches must be exactly ssd_scan = 48 x prefill chunks,
     rglru_scan = 18 x prefill chunks and decode_attention = 8 x decode
     steps (RecurrentGemma's local layers); the kernel path's prefill and
     decode logits against the ``chunked`` path's at full width; a
     profile of a prefill and of a decode step; peak memory;
 18. (run after phase 17) RecurrentGemma-2B's cache-free forward at full
     width and depth, ``module(tokens, positions)`` under ``pallas`` on
     1 x 4096 tokens, so the 2048 window binds: exactly 8 flash_attention
     (head dim 256) and 18 rglru_scan launches, finite bf16 logits, and
     fp32 logits within 2e-3 of their range of the ``chunked`` path's.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
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
from repro_torch.configs import (  # noqa: E402
    GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD, get_config, smoke_config)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.ref import (decode_attention_ref,  # noqa: E402
                                    flash_attention_bwd_ref,
                                    flash_attention_ref, rglru_scan_ref,
                                    ssd_scan_ref, wlbvt_select_rounds_ref)
from repro_torch.kernels.rglru_scan import rglru_scan_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_cuda  # noqa: E402
from repro_torch.kernels.wlbvt_select import wlbvt_select_cuda  # noqa: E402
from repro_torch.launch import sweep as sweep_cli  # noqa: E402
from repro_torch.launch.sweep import build_sweep, run_sweep  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serving.engine import ModelExecutor  # noqa: E402
from repro_torch.serving.request import RequestStatus  # noqa: E402

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
L2_BYTES = 50 * 2**20
SERVE = dict(B=8, T=256, Hq=32, Hkv=8, D=128)
RG_DECODE = dict(B=8, T=256, Hq=10, Hkv=1, D=256)   # RecurrentGemma-2B
# a wrapped 2048-entry ring: every row has seen 2049-4000 tokens
RG_RING_LENGTHS = [2049, 4000, 2817, 3500, 2100, 3999, 2560, 3072]
SEED = 0


def log(*a) -> None:
    print(*a, flush=True)


def fields(d: dict) -> str:
    return " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in d.items())


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


def ring_positions(lengths, T: int, seed: int) -> torch.Tensor:
    """(B, T) int32 stored positions of a ring cache of T entries that
    has seen ``lengths[b]`` tokens: index t holds the latest position
    p < length with p = t mod T, or -1; two random entries of each row
    filled past 2 are -1, as a ragged prefill's pad rows leave them."""
    rng = np.random.default_rng(seed)
    pos = np.full((len(lengths), T), -1, np.int32)
    for b, n in enumerate(lengths):
        t = np.arange(T)
        last = t + ((n - 1 - t) // T) * T
        pos[b] = np.where(t <= n - 1, last, -1)
        if n > 2:
            pos[b, rng.choice(T, 2, replace=False)] = -1
    return torch.tensor(pos, device="cuda")


def check_decode_attention() -> float:
    """Returns the max |kernel - plain| of the serving case in bf16."""
    S = SERVE
    T = S["T"]
    ragged = [0, 1, T, 7, 100, 129, 64, T - 1]
    ring = [0, 1, 64, 65, 100, 200, 37, 130]
    cases = [
        ("serve", dict(S), ragged, 0, 0.0, False),
        ("window", dict(S), ragged, 64, 0.0, False),
        ("softcap", dict(S), ragged, 0, 30.0, False),
        ("T%32!=0", dict(S, T=250), [0, 1, 250, 7, 100, 129, 64, 249], 0,
         0.0, False),
        ("window+cap", dict(S, T=250), [250, 3, 31, 33, 0, 200, 64, 1], 40,
         20.0, False),
        # RecurrentGemma-2B's local layers: MQA, 10 heads of 256, window
        # 2048 over a 256-entry cache, masked by the stored positions
        ("rg_d256", dict(RG_DECODE), ragged, 2048, 0.0, False),
        ("rg_d256_pos", dict(RG_DECODE), ragged, 2048, 0.0, True),
        # rings of 64 entries that wrapped, window the ring or less
        ("ring", dict(S, T=64), ring, 64, 0.0, True),
        ("ring_w48", dict(RG_DECODE, T=64), ring, 48, 0.0, True),
        # RecurrentGemma-2B's full 2048-entry ring, wrapped in every row
        ("rg_ring2048", dict(RG_DECODE, T=2048), RG_RING_LENGTHS, 2048, 0.0,
         True),
        # Qwen3-8B's heads over a 4096-entry cache, ragged
        ("qwen3_t4096", dict(S, T=4096),
         [4096, 1, 0, 3000, 2049, 4095, 17, 1024], 0, 0.0, False),
    ]
    serve_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, shp, lengths, win, cap, ring_pos) in enumerate(cases):
            q, k, v, lens = attn_inputs(**shp, lengths=lengths, dtype=dtype,
                                        seed=SEED + i)
            pos = (ring_positions(lengths, shp["T"], SEED + i) if ring_pos
                   else None)
            scale = 1.0 / math.sqrt(shp["D"])
            got = decode_attention_cuda(q, k, v, lens, scale=scale,
                                        window=win, cap=cap, positions=pos)
            torch.cuda.synchronize()
            want = decode_attention_ref(q, k, v, lens, scale=scale,
                                        window=win, cap=cap, positions=pos)
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


def library_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` runs (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:80] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def time_decode_attention(T: int, calls: int, shape=None, window: int = 0,
                          ring: bool = False, lengths=None) -> dict:
    """Device time per call of the kernel and of SDPA (CUDA-graph replays
    of ``calls`` calls, K/V rotated through more buffers than the 50 MB L2
    holds, as the layers' caches are on the main path), the same launched
    eagerly from Python (``eager_ms``, ``library_eager_ms``), and the
    plain version's eager time.  Full caches (length T in every row)
    unless ``lengths`` is given; ``ring``: the kernel masks by stored
    positions, as RecurrentGemma's local layers call it (a wrapped ring
    when a length exceeds T)."""
    S = dict(shape or SERVE, T=T)
    B, Hq, Hkv, D = S["B"], S["Hq"], S["Hkv"], S["D"]
    dtype, G = torch.bfloat16, S["Hq"] // S["Hkv"]
    lengths = lengths or [T] * B
    pair_bytes = 2 * B * T * Hkv * D * 2
    nbuf = max(2, math.ceil(4 * L2_BYTES / pair_bytes))
    sets = [attn_inputs(**S, lengths=lengths, dtype=dtype, seed=100 + i)
            for i in range(nbuf)]
    scale = 1.0 / math.sqrt(D)
    pos = ring_positions(lengths, T, SEED) if ring else None
    kw = dict(scale=scale, window=window, positions=pos)

    def kernel(q, k, v, lens):
        return decode_attention_cuda(q, k, v, lens, **kw)

    def plain(q, k, v, lens):
        return decode_attention_ref(q, k, v, lens, **kw)

    # the keys that count, as the kernel masks them
    kpos = (pos.long() if ring else torch.arange(T, device="cuda")[None, :])
    lens = sets[0][3].long()[:, None]
    mask = (kpos >= 0) & (kpos < lens)
    if window:
        mask &= lens - kpos <= window
    lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 mask[:, None, None, :]) for (q, k, v, _) in sets]

    def library(q, k, v, m):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=m,
                                              scale=scale, enable_gqa=True)

    # the yardstick computes the same function: check it once
    lib_out = library(*lib_sets[0]).transpose(1, 2)
    ker_out = kernel(*sets[0])
    lib_err = (lib_out.float() - ker_out.float()).abs().max().item()
    if lib_err > TOL[dtype]:
        raise AssertionError(f"library yardstick disagrees: {lib_err}")
    lib_kernels = library_kernels(lambda: library(*lib_sets[0]))

    ms = graph_ms(kernel, calls, 20, sets)
    library_ms = graph_ms(library, calls, 20, lib_sets)
    eager_ms = event_ms(kernel, sets, 20 * calls)
    library_eager_ms = event_ms(library, lib_sets, 20 * calls)
    plain_ms = event_ms(plain, sets, max(calls // 5, 5))
    counted = int(mask.sum().item())
    kv_elems = counted * Hkv * D               # K (and V) read
    nbytes = 2 * kv_elems * 2 + 2 * (B * Hq * D * 2) + B * 4 \
        + (B * T * 4 if ring else 0)          # + q, out, lens, positions
    flops = 2 * 2 * G * kv_elems          # one MAC per query row, QK and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(B=B, T=T, Hq=Hq, Hkv=Hkv, D=D, window=window, ring=ring,
                counted_keys=counted, ms=ms, library_ms=library_ms,
                eager_ms=eager_ms, library_eager_ms=library_eager_ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf,
                library_kernels="|".join(lib_kernels))


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


def prefill_decode_logits(cfg, module, max_len: int, prompts,
                          decode_tokens):
    """``module`` run as ``cfg`` (its dtype and attention implementation)
    on a fresh cache: one prefill of ``prompts`` (B, C), then one decode
    step per column of ``decode_tokens`` (B, n).  Returns [prefill last
    logits, decode logits...]."""
    model = build_model(cfg)
    B, C = prompts.shape
    cache = model.init_cache(B, max_len, "cuda")
    lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
    active = torch.ones((B, 1), dtype=torch.bool, device="cuda")
    served = module.cfg
    module.cfg = cfg
    try:
        with torch.no_grad():
            logits, cache = model.prefill(module, prompts, cache, lengths)
            out = [logits[:, -1]]
            lengths = lengths + C
            for i in range(decode_tokens.shape[1]):
                logits, cache = model.decode_step(
                    module, decode_tokens[:, i:i + 1], cache, lengths,
                    valid=active)
                out.append(logits[:, -1])
                lengths = lengths + 1
    finally:
        module.cfg = served
    return out


def check_small(arch: str, prompt_len: int, steps: int, **changes) -> None:
    """fp32 smoke model on the card: the kernel path gives the plain
    (``chunked``) path's logits (1e-4) and greedy tokens over a prefill
    of ``prompt_len`` tokens and ``steps`` decode steps."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                              attn_impl="pallas", **changes)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    module = build_model(cfg).init(gen)
    prompts = torch.randint(1, cfg.vocab_size, (4, prompt_len), generator=gen,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (4, steps), generator=gen,
                         device="cuda", dtype=torch.int32)
    ops.reset_launches()
    ker = prefill_decode_logits(cfg, module, 64, prompts, toks)
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    plain = prefill_decode_logits(
        dataclasses.replace(cfg, attn_impl="chunked"), module, 64, prompts,
        toks)
    err = max((a - b).abs().max().item() for a, b in zip(ker, plain))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(ker, plain))
    log(f"check small fp32 {arch}: prefill of {prompt_len} + {steps} decode "
        f"steps, kernels {launched}, max_abs_err={err:.3e} tol=1e-4 "
        f"greedy_tokens_equal={same}")
    if err > 1e-4 or not same or not launched:
        raise AssertionError(f"small {arch}: kernel path disagrees")


def check_full_width(module, cfg) -> None:
    """Full-width Qwen3-8B: one decode step's logits through the kernel
    against the plain path's (``chunked``: its decode is
    ``naive_attention``), after the same prefill."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    prompts = torch.randint(1, cfg.vocab_size, (8, 32), generator=g,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (8, 1), generator=g,
                         device="cuda", dtype=torch.int32)
    ker = prefill_decode_logits(cfg, module, 256, prompts, toks)[1]
    plain = prefill_decode_logits(dataclasses.replace(
        cfg, attn_impl="chunked"), module, 256, prompts, toks)[1]
    if ker.shape != (8, cfg.vocab_size) or not torch.isfinite(ker).all():
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
    B = 8
    tokens = np.ones(B, np.int32)
    lengths = np.full(B, 128, np.int32)
    active = np.ones(B, bool)
    profile_step("qwen3-8b full-width decode step",
                 lambda: ex.decode(tokens, lengths, active),
                 kernel="decode_attention")


# ---------------------------------------------------------------------------
# phases 11-13: flash attention and the training path
# ---------------------------------------------------------------------------
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# B, S, T, Hq, Hkv, D, window, cap, causal: tests/test_kernels.py's cases,
# causal off, and the training path's shape (TRAIN: Qwen3-8B's heads)
# the bf16 kernels' edges: S * G and T not multiples of their 128-row and
# 128-key tiles, G = 3 and 8, every head dim, a window shorter than a tile,
# a cap with a window, non-causal with T != S
FLASH_CASES = [
    ("mha", (2, 128, 128, 4, 4, 64, 0, 0.0, True)),
    ("gqa4", (2, 256, 256, 8, 2, 64, 0, 0.0, True)),
    ("mqa_unaligned", (2, 192, 192, 4, 1, 128, 0, 0.0, True)),
    ("window96", (2, 256, 256, 8, 4, 64, 96, 0.0, True)),
    ("cap50", (2, 128, 128, 4, 4, 64, 0, 50.0, True)),
    ("win_cap_odd", (2, 320, 320, 2, 2, 32, 64, 30.0, True)),
    ("noncausal", (1, 64, 96, 2, 2, 32, 0, 0.0, False)),
    ("g3_ragged", (2, 200, 200, 6, 2, 64, 0, 0.0, True)),
    ("d16", (2, 130, 130, 4, 2, 16, 0, 0.0, True)),
    ("win20_d128", (1, 300, 300, 8, 2, 128, 20, 0.0, True)),
    ("noncausal_ragged", (1, 300, 200, 4, 2, 64, 0, 0.0, False)),
    ("g8_cap_win", (1, 260, 260, 8, 1, 32, 50, 20.0, True)),
    # head dim 256 with RecurrentGemma-2B's grouping (10 heads on 1): S * G
    # off the tiles, a window, a cap with a window, and its cache-free
    # forward's shape (S 4096, window 2048)
    ("g10_d256", (1, 200, 200, 10, 1, 256, 0, 0.0, True)),
    ("g10_d256_win", (2, 300, 300, 10, 1, 256, 100, 0.0, True)),
    ("g10_d256_cap_win", (1, 260, 260, 10, 1, 256, 64, 30.0, True)),
    ("rg_cache_free", (1, 4096, 4096, 10, 1, 256, 2048, 0.0, True)),
    ("qwen3", (4, 1024, 1024, 32, 8, 128, 0, 0.0, True)),
]
TRAIN = dict(B=4, S=1024, Hq=32, Hkv=8, D=128)
# RecurrentGemma-2B's local attention, cache-free (B 1, S 4096)
RG_FLASH = dict(B=1, S=4096, Hq=10, Hkv=1, D=256, window=2048)
assert FLASH_CASES[-1][1] == (TRAIN["B"], TRAIN["S"], TRAIN["S"], TRAIN["Hq"],
                              TRAIN["Hkv"], TRAIN["D"], 0, 0.0, True)


def flash_inputs(case, dtype, seed, fused=False):
    """q, k, v, dO of a case; ``fused``: q, k, v are strided slices of one
    (B, S, Hq + 2 Hkv, D) buffer, as a fused projection gives them."""
    B, S, T, Hq, Hkv, D, win, cap, causal = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    if fused:
        assert S == T
        x = rnd(B, S, Hq + 2 * Hkv, D)
        q, k, v = x[:, :, :Hq], x[:, :, Hq:Hq + Hkv], x[:, :, Hq + Hkv:]
    else:
        q, k, v = rnd(B, S, Hq, D), rnd(B, T, Hkv, D), rnd(B, T, Hkv, D)
    do = rnd(B, S, Hq, D)
    kw = dict(scale=1.0 / math.sqrt(D), causal=causal, window=win, cap=cap)
    return q, k, v, do, kw


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


# q, k, v as slices of one fused buffer (bf16 only)
FLASH_FUSED = [("fused_qwen3", (2, 256, 256, 32, 8, 128, 0, 0.0, True)),
               ("fused_g3", (1, 200, 200, 6, 2, 64, 0, 0.0, True))]


def check_flash_attention():
    """Both kernels against their plain versions on every case.  Returns
    the qwen3 case's errors in bf16: max |o - plain|, max |grad - plain|
    over dq, dk, dv, and the worst relative gradient error."""
    out = {}
    runs = [(name, case, dtype, False, SEED + i)
            for dtype in (torch.bfloat16, torch.float32)
            for i, (name, case) in enumerate(FLASH_CASES)]
    runs += [(name, case, torch.bfloat16, True, SEED + len(FLASH_CASES) + i)
             for i, (name, case) in enumerate(FLASH_FUSED)]
    for name, case, dtype, fused, seed in runs:
        q, k, v, do, kw = flash_inputs(case, dtype, seed, fused)
        o, lse = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want_o, want_lse = flash_attention_ref(q, k, v, **kw)
        err = (o.float() - want_o.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        grads = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        gerr = [rel_err(a, b) for a, b in zip(grads, want)]
        gabs = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(grads, want))
        # autograd of the plain forward: the gradient's second oracle
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        ref_o, _ = flash_attention_ref(*leaves, **kw)
        auto = torch.autograd.grad(ref_o, leaves, do)
        aerr = [rel_err(a, b) for a, b in zip(grads, auto)]
        del ref_o, auto, leaves
        ok = (err <= TOL[dtype] and lse_err <= 1e-4
              and max(gerr + aerr) <= GRAD_TOL[dtype]
              and all(torch.isfinite(x).all() for x in (o, *grads)))
        log(f"check flash_attention {name:<16} {str(dtype):<15} "
            f"fwd max_abs_err={err:.3e} (tol {TOL[dtype]:g}) "
            f"lse_err={lse_err:.3e} bwd rel_err dq/dk/dv="
            f"{'/'.join(f'{e:.2e}' for e in gerr)} vs autograd of "
            f"plain {'/'.join(f'{e:.2e}' for e in aerr)} "
            f"(tol {GRAD_TOL[dtype]:g})")
        if not ok:
            raise AssertionError(f"flash_attention {name} {dtype}: "
                                 "kernel disagrees with plain version")
        if name == "qwen3" and dtype == torch.bfloat16:
            out = dict(fwd_err=err, bwd_err=gabs, bwd_rel_err=max(gerr))
    x = torch.zeros((1, 8, 6, 64), device="cuda", dtype=torch.bfloat16)
    for what, args in (
            ("head dim 48", [torch.zeros((1, 8, 2, 48), device="cuda")] * 3),
            # slices starting one element in: 2-byte aligned addresses
            ("a misaligned address", [x[:, :, 2 * i:2 * i + 2, 1:33]
                                      for i in range(3)])):
        try:
            flash_attention_cuda(*args, scale=1.0)
        except ValueError as e:
            log(f"check flash_attention {what} raises: {e}")
        else:
            raise AssertionError(f"flash_attention: {what} did not raise")
    return out


def time_flash_attention(iters: int, shape=None) -> dict:
    """CUDA-event times at the training shape (or ``shape``, causal, with
    its window).  At the training shape q, k, v and o together (84 MB)
    exceed the 50 MB L2, so no buffers are rotated."""
    T = shape or TRAIN
    B, S, Hq, Hkv, D = T["B"], T["S"], T["Hq"], T["Hkv"], T["D"]
    win = T.get("window", 0)
    dtype = torch.bfloat16
    case = (B, S, S, Hq, Hkv, D, win, 0.0, True)
    q, k, v, do, kw = flash_inputs(case, dtype, 200)
    # SDPA takes a window only as an explicit mask
    qp = torch.arange(S, device="cuda")
    lib_mask = ((qp[None, :] <= qp[:, None])
                & (qp[:, None] - qp[None, :] < win)) if win else None
    o, lse = flash_attention_cuda(q, k, v, **kw)
    lq, lk, lv = (x.detach().transpose(1, 2).clone().requires_grad_(True)
                  for x in (q, k, v))
    ldo = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lib_mask,
                                              is_causal=lib_mask is None,
                                              scale=kw["scale"],
                                              enable_gqa=True)
    # the yardstick computes the same function: check it once
    lib_err = (sdpa().transpose(1, 2).float() - o.float()).abs().max().item()
    if lib_err > TOL[dtype]:
        raise AssertionError(f"library yardstick disagrees: {lib_err}")
    lib_out = sdpa()

    def lib_fwd_bwd():
        torch.autograd.grad(sdpa(), (lq, lk, lv), ldo)

    def lib_bwd():
        torch.autograd.grad(lib_out, (lq, lk, lv), ldo, retain_graph=True)

    gq, gk, gv = (x.detach().requires_grad_(True) for x in (q, k, v))

    def ker_fwd_bwd():
        torch.autograd.grad(ops.flash_attention(gq, gk, gv, **kw),
                            (gq, gk, gv), do)

    def plain_fwd_bwd():
        po, plse = flash_attention_ref(q, k, v, **kw)
        flash_attention_bwd_ref(q, k, v, po, plse, do, **kw)

    few = max(iters // 10, 3)
    r = dict(
        fwd_ms=event_ms(lambda: flash_attention_cuda(q, k, v, **kw), [()],
                        iters),
        bwd_ms=event_ms(lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                         **kw), [()], iters),
        fwd_bwd_ms=event_ms(ker_fwd_bwd, [()], iters),
        plain_fwd_ms=event_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              [()], few),
        plain_bwd_ms=event_ms(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, **kw), [()], few),
        plain_fwd_bwd_ms=event_ms(plain_fwd_bwd, [()], few),
        library_fwd_ms=event_ms(sdpa, [()], iters),
        library_bwd_ms=event_ms(lib_bwd, [()], iters),
        library_fwd_bwd_ms=event_ms(lib_fwd_bwd, [()], iters))
    # causal: every (query, key) pair with key <= query (and within the
    # window), counted exactly
    pairs = B * Hq * sum(min(s + 1, win or S) for s in range(S))
    elt = 2
    fwd_bytes = (2 * B * S * Hq * D + 2 * B * S * Hkv * D) * elt \
        + B * Hq * S * 4                                # q, o, k, v, lse
    bwd_bytes = (3 * B * S * Hq * D + 2 * B * S * Hkv * D) * elt \
        + B * Hq * S * 4 + (B * S * Hq * D + 2 * B * S * Hkv * D) * elt
    for name, flops, nbytes in (("fwd", 4 * D * pairs, fwd_bytes),
                                ("bwd", 10 * D * pairs, bwd_bytes)):
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS[dtype] * 1e3
        r[f"{name}_bound_ms"] = max(t_b, t_o)
        r[f"{name}_bound_by"] = "bytes" if t_b >= t_o else "operations"
        r[f"{name}_flops"] = flops
        r[f"{name}_bytes"] = nbytes
        # achieved rate and share of the bound, kernel and library call
        r[f"{name}_tflops"] = flops / r[f"{name}_ms"] / 1e9
        r[f"{name}_bound_share"] = r[f"{name}_bound_ms"] / r[f"{name}_ms"]
        r[f"library_{name}_tflops"] = flops / r[f"library_{name}_ms"] / 1e9
    r["library_max_abs_diff"] = lib_err
    if shape is not None:
        return r
    # the same shape without the causal mask: every block walks all 8 KV
    # tiles and no tile is masked, which shows what the causal blocks'
    # shortness and diagonal tiles cost
    nq, nk, nv, ndo, nkw = flash_inputs((B, S, S, Hq, Hkv, D, 0, 0.0, False),
                                        dtype, 201)
    no, nlse = flash_attention_cuda(nq, nk, nv, **nkw)
    for name, per_pair, fn in (
            ("fwd", 4, lambda: flash_attention_cuda(nq, nk, nv, **nkw)),
            ("bwd", 10, lambda: flash_attention_bwd_cuda(
                nq, nk, nv, no, nlse, ndo, **nkw))):
        ms = event_ms(fn, [()], iters)
        r[f"noncausal_{name}_ms"] = ms
        r[f"noncausal_{name}_tflops"] = (per_pair * D * B * Hq * S * S
                                         / ms / 1e9)
    return r


def check_tensor_cores() -> dict:
    """Count the HGMMA (wgmma) instructions of every function in the two
    flash libraries with ``cuobjdump --dump-sass``; each bf16 kernel must
    have some.  Returns the count per library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    for lib, kernel in (("flash_attention", "flash_fwd_sm90"),
                        ("flash_attention_bwd", "flash_bwd_sm90")):
        sass = subprocess.run([tool, "--dump-sass",
                               str(kbuild.lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        per, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                per[fn] = 0
            elif fn is not None and "HGMMA" in line:
                per[fn] += 1
        ours = {int(re.search(r"ILi(\d+)E", f).group(1)): c
                for f, c in per.items() if kernel in f}
        others = sum(c for f, c in per.items() if kernel not in f)
        log(f"tensor cores: {lib} HGMMA instructions, bf16 {kernel} by "
            f"head dim {dict(sorted(ours.items()))}, every other function "
            f"{others}")
        # the backward runs the scalar kernel at D 256 (flash_attention_bwd.cu)
        dims = [16, 32, 64, 128] + ([256] if lib == "flash_attention" else [])
        if sorted(ours) != dims or min(ours.values()) == 0:
            raise AssertionError(f"{lib}: a bf16 kernel has no HGMMA "
                                 f"instruction: {ours}")
        counts[lib] = sum(ours.values())
    return counts


def ptxas_report(logs: dict, pattern: str) -> list:
    """(library, function, registers, spill stores, spill loads) of every
    entry function whose mangled name matches ``pattern``, from the
    ``-Xptxas -v`` build logs."""
    out = []
    for lib, text in logs.items():
        fn, spill = None, (0, 0)
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None and re.search(pattern, fn):
                out.append((lib, fn, int(m.group(1)), *spill))
                fn = None
    return out


def profile_train_step(cfg, state) -> None:
    """Device time by kernel over one more training step of ``state``
    (after the measured run), against the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.trainer import build_trainer
    trainer = build_trainer(cfg, total_steps=5, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             next(SyntheticLM(cfg, 1024, 4, seed=SEED + 1)).items()}
    state, _ = trainer.train_step(state, batch)        # warm
    (state, _), wall = sync_time(lambda: trainer.train_step(state, batch))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    attn = sum(e.self_device_time_total for e in rows
               if "flash_" in e.key) / 1e3
    log(f"profile: train step wall {wall * 1e3:.3f} ms (host clock, "
        f"unprofiled), device time {total:.3f} ms over "
        f"{sum(e.count for e in rows)} kernels, idle share "
        f"{1 - total / (wall * 1e3):.3f}, flash kernels {attn:.3f} ms "
        f"({attn / total:.3f} of device time)")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.3f} ms  "
            f"{e.count:5d}x  {e.key[:90]}")


def train_phase() -> dict:
    """Phase 13: Qwen3-8B's widths at 8 layers, 5 steps on the kernels,
    then 2 steps on the plain chunked attention from the same seed."""
    base = dataclasses.replace(get_config("qwen3-8b"), num_layers=8,
                               remat="full")
    run = dict(seq_len=1024, global_batch=4, seed=SEED, log_every=1,
               device="cuda", log=log)
    cfg = dataclasses.replace(base, attn_impl="pallas")
    log(f"train qwen3-8b widths: layers={cfg.num_layers} (of 36) "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads}x"
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"param_dtype={cfg.param_dtype} dtype={cfg.dtype} "
        f"optimizer={cfg.optimizer} remat={cfg.remat} batch 4x1024")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (state, hist), wall = sync_time(lambda: run_training(cfg, steps=5, **run))
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in state.params.parameters())
    profile_train_step(cfg, state)
    log(f"train: params={n_params} wall_s={wall:.3f} "
        f"max_memory_allocated={peak} launches flash_attention="
        f"{launches['flash_attention']} flash_attention_bwd="
        f"{launches['flash_attention_bwd']} (per step "
        f"{launches['flash_attention'] / 5:g} / "
        f"{launches['flash_attention_bwd'] / 5:g}; layers "
        f"{cfg.num_layers})")
    del state
    torch.cuda.empty_cache()
    # random init: the final hidden has unit RMS and the tied embedding
    # std 0.02, so the logits have variance d_model * 0.02^2 and the
    # expected loss is ln V + var / 2 (+ the z-loss, ~0.016)
    first = hist[0]["loss"]
    ln_v = math.log(cfg.vocab_size)
    want_first = ln_v + cfg.d_model * 0.02 ** 2 / 2
    log(f"check train first loss {first:.4f}: ln V = {ln_v:.4f}, ln V + "
        f"d_model * 0.02^2 / 2 = {want_first:.4f} (tol 0.25)")
    if not (all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist) and abs(first - want_first) < 0.25):
        raise AssertionError(f"train: losses {[h['loss'] for h in hist]}, "
                             f"first should be near {want_first:.3f}")
    if (launches["flash_attention"] != 2 * cfg.num_layers * 5
            or launches["flash_attention_bwd"] != cfg.num_layers * 5):
        raise AssertionError(f"train: launches {launches}, want 2 x "
                             f"{cfg.num_layers} forward and "
                             f"{cfg.num_layers} backward per step")
    plain_cfg = dataclasses.replace(base, attn_impl="chunked")
    ops.reset_launches()
    (pstate, phist), pwall = sync_time(
        lambda: run_training(plain_cfg, steps=2, **run))
    del pstate
    torch.cuda.empty_cache()
    if ops.LAUNCHES["flash_attention"] or ops.LAUNCHES["flash_attention_bwd"]:
        raise AssertionError("chunked training launched a flash kernel")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(hist[:2], phist)]
    # under the warmup the first steps barely move the weights, so the
    # losses hold the forward; the grad norms hold the backward kernel
    gdiffs = [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
              for a, b in zip(hist[:2], phist)]
    log(f"check train kernels vs chunked: losses "
        f"{[h['loss'] for h in hist[:2]]} vs {[h['loss'] for h in phist]} "
        f"rel diff {[f'{d:.2e}' for d in diffs]} (tol 1e-2); grad norms "
        f"{[h['grad_norm'] for h in hist[:2]]} vs "
        f"{[h['grad_norm'] for h in phist]} rel diff "
        f"{[f'{d:.2e}' for d in gdiffs]} (tol 1e-2); chunked "
        f"wall_s={pwall:.3f} step_s {[round(h['step_s'], 4) for h in phist]}")
    if max(diffs) > 1e-2:
        raise AssertionError("train: the kernel path's losses disagree with "
                             "the chunked path's")
    if max(gdiffs) > 1e-2:
        raise AssertionError("train: the kernel path's grad norms disagree "
                             "with the chunked path's")
    return dict(hist=hist, launches=launches, peak=peak, wall=wall)


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


def graph_ms(fn, per_graph: int, replays: int, argsets=((),)) -> float:
    """Device time per call: ``per_graph`` calls (cycling through
    ``argsets``) captured in one CUDA graph, replayed ``replays`` times
    between CUDA events, so the host's launch cost is out of the
    measurement."""
    fn(*argsets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(per_graph):
            fn(*argsets[i % len(argsets)])
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

# ---------------------------------------------------------------------------
# phases 14-17: the SSD and RG-LRU scan kernels and the recurrent families
# ---------------------------------------------------------------------------
SCAN_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
RGLRU_TOL = 1e-5
# B, S, H, P, G, N, chunk: tests/test_kernels.py's three (groups, ragged
# chunks), the serve shape (one prefill chunk of Mamba2-370M: Q = 32) and
# a cache-free run at its widths (4 chunks of 256 rows: the sub-tiling)
SSD_CASES = [
    ("k128", (2, 128, 4, 32, 1, 16, 64)),
    ("k200_groups", (2, 200, 4, 32, 2, 16, 64)),
    ("k96", (2, 96, 2, 64, 1, 32, 32)),
    ("serve", (8, 32, 32, 64, 1, 128, 256)),
    ("cache_free", (4, 1024, 32, 64, 1, 128, 256)),
]
SSD_SERVE = dict(SSD_CASES)["serve"]
# B, S, W: tests/test_kernels.py's three and the serve shape (one prefill
# chunk of RecurrentGemma-2B)
RGLRU_CASES = [("k128", (2, 128, 128)), ("k100x96", (2, 100, 96)),
               ("k64x256", (2, 64, 256)), ("serve", (8, 32, 2560))]
RGLRU_SERVE = dict(RGLRU_CASES)["serve"]


def ssd_inputs(case, xdtype, bcdtype, state: bool, seed: int):
    B, S, H, P, G, N, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    args = ((rnd(B, S, H, P) * 0.5).to(xdtype), F.softplus(rnd(B, S, H)),
            torch.log(torch.linspace(1.0, 16.0, H, device="cuda")),
            (rnd(B, S, G, N) * 0.3).to(bcdtype),
            (rnd(B, S, G, N) * 0.3).to(bcdtype))
    return args, (rnd(B, H, P, N) * 0.5 if state else None)


def check_ssd_scan() -> float:
    """The SSD kernel against its plain version; returns the serve case's
    max |kernel - plain| (y and state) in bf16.  The test shapes read B/C
    in fp32 (as tests/test_kernels.py), the serve and cache-free shapes
    in x's dtype (as the model path)."""
    serve_err = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, case) in enumerate(SSD_CASES):
            model_path = name in ("serve", "cache_free")
            states = {"serve": (True,), "cache_free": (False,)}.get(
                name, (False, True))
            for state in states:
                args, st = ssd_inputs(case, dtype,
                                      dtype if model_path else torch.float32,
                                      state, SEED + i)
                y, last = ssd_scan_cuda(*args, chunk=case[-1],
                                        init_state=st)
                torch.cuda.synchronize()
                wy, wlast = ssd_scan_ref(*args, init_state=st)
                tol = SCAN_TOL[dtype]
                ey = (y.float() - wy.float()).abs().max().item()
                es = (last - wlast).abs().max().item()
                ok = (torch.allclose(y.float(), wy.float(), atol=tol,
                                     rtol=tol)
                      and torch.allclose(last, wlast, atol=tol, rtol=tol)
                      and bool(torch.isfinite(y).all())
                      and bool(torch.isfinite(last).all()))
                log(f"check ssd_scan {name:<11} {str(dtype):<15} "
                    f"B/C {str(args[3].dtype):<15} init_state={state!s:<5} "
                    f"y max_abs_err={ey:.3e} state max_abs_err={es:.3e} "
                    f"(max |y| {wy.float().abs().max().item():.3g}) "
                    f"tol={tol:g}")
                if not ok:
                    raise AssertionError(f"ssd_scan {name} {dtype}: kernel "
                                         "disagrees with plain version")
                if name == "serve" and dtype == torch.bfloat16:
                    serve_err = max(ey, es)
    return serve_err


def ssd_cost(case, xbytes: int, state: bool):
    """(bytes, flops) the chunked SSD scan needs: each input read once
    and each output written once; per chunk of q rows the q(q+1)/2
    scores over N and products over P, the state update, and the
    inter-chunk term where a state comes in."""
    B, S, H, P, G, N, chunk = case
    Q = min(chunk, S)
    nbytes = (2 * B * S * H * P * xbytes + B * S * H * 4 + H * 4
              + 2 * B * S * G * N * xbytes + B * H * P * N * 4 * (1 + state))
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        flops += 2 * tri * (N + P) + 2 * q * P * N
        if state or c0 > 0:
            flops += 2 * q * P * N
    return nbytes, flops * B * H


def time_ssd_scan(case, state: bool, calls: int, plain_calls: int) -> dict:
    """Device times in bf16 (x and B/C, as the model path) from CUDA-graph
    replays (``ms``, ``plain_ms``) and the time launched eagerly from
    Python (``eager_ms``), inputs rotated through more sets than the 50
    MB L2 holds (the 48 layers' states are on the main path)."""
    dtype = torch.bfloat16
    nbytes, flops = ssd_cost(case, 2, state)
    nbuf = max(2, math.ceil(4 * L2_BYTES / nbytes))
    sets = [ssd_inputs(case, dtype, dtype, state, 300 + i)
            for i in range(nbuf)]
    chunk = case[-1]

    def kernel(args, st):
        return ssd_scan_cuda(*args, chunk=chunk, init_state=st)

    def plain(args, st):
        return ssd_scan_ref(*args, init_state=st)

    ms = graph_ms(kernel, calls, 5, sets)
    eager_ms = event_ms(kernel, sets, 10 * calls)
    plain_ms = graph_ms(plain, plain_calls, 2, sets)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    B, S, H, P, G, N, _ = case
    return dict(B=B, S=S, H=H, P=P, G=G, N=N, chunk=chunk,
                init_state=state, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf, library_ms=None)


def rglru_inputs(case, h0: bool, seed: int):
    B, S, W = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.sigmoid(torch.randn((B, S, W), generator=g, device="cuda"))
    b = torch.randn((B, S, W), generator=g, device="cuda") * 0.1
    h = torch.randn((B, W), generator=g, device="cuda") if h0 else None
    return a, b, h


def check_rglru_scan() -> float:
    """The RG-LRU kernel against its plain version (tol 1e-5); returns
    the serve case's max |kernel - plain|."""
    serve_err = None
    for i, (name, case) in enumerate(RGLRU_CASES):
        for h0 in ((True,) if name == "serve" else (False, True)):
            a, b, h = rglru_inputs(case, h0, SEED + i)
            got, got_last = rglru_scan_cuda(a, b, h)
            torch.cuda.synchronize()
            want, want_last = rglru_scan_ref(a, b, h)
            err = max((got - want).abs().max().item(),
                      (got_last - want_last).abs().max().item())
            ok = (torch.allclose(got, want, atol=RGLRU_TOL, rtol=RGLRU_TOL)
                  and torch.allclose(got_last, want_last, atol=RGLRU_TOL,
                                     rtol=RGLRU_TOL))
            log(f"check rglru_scan {name:<8} h0={h0!s:<5} "
                f"max_abs_err={err:.3e} tol={RGLRU_TOL:g}")
            if not ok:
                raise AssertionError(f"rglru_scan {name}: kernel disagrees "
                                     "with plain version")
            if name == "serve":
                serve_err = err
    return serve_err


def time_rglru_scan(case, calls: int) -> dict:
    """As ``time_ssd_scan``, in fp32, with h0."""
    B, S, W = case
    nbytes = 3 * B * S * W * 4 + 2 * B * W * 4     # a, b, h; h0, h_last
    flops = 2 * B * S * W
    nbuf = max(2, math.ceil(4 * L2_BYTES / nbytes))
    sets = [rglru_inputs(case, True, 400 + i) for i in range(nbuf)]
    ms = graph_ms(rglru_scan_cuda, calls, 5, sets)
    eager_ms = event_ms(rglru_scan_cuda, sets, 10 * calls)
    plain_ms = graph_ms(rglru_scan_ref, max(calls // 10, 2), 2, sets)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
    return dict(B=B, S=S, W=W, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, buffers=nbuf, library_ms=None)


def check_full_width_recurrent(module, cfg) -> None:
    """At full width and depth, a prefill of 8 x 32 tokens and 2
    teacher-forced decode steps: through the kernels in bf16 (as served)
    the logits are finite and of shape (8, vocab); in fp32 the kernel
    path's logits agree with the ``chunked`` path's to 2e-3 of their
    range.  bf16 is not held across paths: they sum in other orders, and
    48 layers of random weights grow a bf16 rounding difference to ~20 %
    of the logit range even between the two plain versions (PERF.md)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    prompts = torch.randint(1, cfg.vocab_size, (8, 32), generator=g,
                            device="cuda", dtype=torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (8, 2), generator=g,
                         device="cuda", dtype=torch.int32)
    served = prefill_decode_logits(cfg, module, 256, prompts, toks)
    for what, a in zip(("prefill", "decode 0", "decode 1"), served):
        if a.shape != (8, cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{cfg.name} full-width bf16 {what} "
                                 f"logits: shape {tuple(a.shape)}, finite="
                                 f"{bool(torch.isfinite(a).all())}")
    f32 = dataclasses.replace(cfg, dtype="float32")
    ker = prefill_decode_logits(f32, module, 256, prompts, toks)
    plain = prefill_decode_logits(
        dataclasses.replace(f32, attn_impl="chunked"), module, 256, prompts,
        toks)
    for what, a, b, c in zip(("prefill", "decode 0", "decode 1"), ker,
                             plain, served):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        log(f"check {cfg.name} full-width {what}: bf16 kernel path shape="
            f"{tuple(c.shape)} finite; fp32 kernel vs chunked max_abs_err="
            f"{err:.4g} max_abs_logit={scale:.4g} (tol 2e-3 of it) "
            f"greedy_agreement={agree:.3f}")
        if err > 2e-3 * scale:
            raise AssertionError(f"{cfg.name} full-width {what}: kernel "
                                 "path disagrees with chunked")


def profile_step(label: str, step, kernel: str = "") -> None:
    """Wall time of ``step`` (host clock, mean of 5) against its device
    time by kernel (profiler, mean of 2 steps): the idle share; with
    ``kernel``, that kernel's device time per launch and its share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()                                      # warm
    _, wall = sync_time(lambda: [step() for _ in range(5)])
    step_ms = wall / 5 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 2 / 1e3
    log(f"profile: {label} wall {step_ms:.3f} ms (host clock, mean of 5), "
        f"device time {total:.3f} ms (sum of kernel self time, mean of 2 "
        f"profiled steps) over {sum(e.count for e in rows) // 2} kernels, "
        f"idle share {1 - total / step_ms:.3f}")
    if kernel:
        mine = [e for e in rows if kernel in e.key]
        t = sum(e.self_device_time_total for e in mine) / 2 / 1e3
        n = sum(e.count for e in mine) // 2
        log(f"profile: {label} {kernel}: {n} launches a step, "
            f"{t:.4f} ms a step, {t / max(n, 1) * 1e3:.3f} us a launch, "
            f"{t / total:.4f} of device time")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile:   {e.self_device_time_total / 2 / 1e3:9.3f} ms  "
            f"{e.count // 2:5d}x  {e.key[:90]}")


def serve_recurrent(arch: str) -> dict:
    """Phase 16/17: serve ``arch`` at full width and depth through the
    kernels; exact launch counts; full-width check; profile of a prefill
    step."""
    cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
    rt, rep, wall, init_s, launches = serve(cfg, SEED)
    done = rt.engine.done
    pc, ds = rep.extras["prefill_chunks"], rep.extras["decode_steps"]
    generated = sum(len(r.generated) for r in done)
    peak = torch.cuda.max_memory_allocated()
    ex = rt.engine.exe
    n_params = sum(p.numel() for p in ex.params.parameters())
    kinds = cfg.pattern_for_layers()
    want = {"decode_attention": (kinds.count(LOCAL_ATTN)
                                 + kinds.count(GLOBAL_ATTN)) * ds,
            "flash_attention": 0, "flash_attention_bwd": 0,
            "wlbvt_select": 0, "ssd_scan": kinds.count(SSD) * pc,
            "rglru_scan": kinds.count(RGLRU) * pc}
    log(f"serve {arch}: layers={cfg.num_layers} ({kinds.count(SSD)} ssd, "
        f"{kinds.count(RGLRU)} rglru, {kinds.count(LOCAL_ATTN)} local) "
        f"d_model={cfg.d_model} params={n_params} init_s={init_s:.2f} "
        f"steps={int(rep.duration)} prefill_chunks={pc} decode_steps={ds} "
        f"wall_s={wall:.3f} generated_tokens={generated} "
        f"tokens_per_s={generated / wall:.2f} max_memory_allocated={peak} "
        f"launches={launches}")
    log(rep.summary())
    if len(done) != 12 or any(r.status != RequestStatus.DONE for r in done):
        raise AssertionError(f"{arch}: not every request ended done: " + str(
            [(r.rid, r.status.value) for r in done]))
    if launches != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    check_full_width_recurrent(ex.params, cfg)
    B, C = 8, 32
    tokens = np.ones((B, C), np.int32)
    zeros, full = np.zeros(B, np.int32), np.full(B, C, np.int32)
    profile_step(f"{arch} full-width prefill step (8 x 32 tokens)",
                 lambda: ex.prefill(tokens, zeros, full))
    active = np.ones(B, bool)
    profile_step(f"{arch} full-width decode step",
                 lambda: ex.decode(tokens[:, 0], full, active),
                 kernel="decode_attention")
    del rt, ex
    torch.cuda.empty_cache()
    return dict(launches=launches, peak=peak, wall=wall)


def rg_cache_free_phase() -> dict:
    """Phase 18: RecurrentGemma-2B at full width and depth, random weights
    from a seed, one cache-free forward ``module(tokens, positions)`` of
    1 x 4096 tokens under ``pallas``, so the 2048 window binds: every
    local-attention layer runs the flash forward at head dim 256 and every
    RG-LRU layer the scan kernel, exactly once.  The bf16 logits are
    finite; in fp32 the kernel path's logits agree with the ``chunked``
    path's to 2e-3 of their range (phase 17's tolerance)."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("recurrentgemma-2b"),
                              attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    module = build_model(cfg).init(gen)
    B, S = 1, 4096
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda", dtype=torch.int32)
    positions = transformer.make_positions(B, S, "cuda")
    kinds = cfg.pattern_for_layers()
    want = dict(ops.LAUNCHES, decode_attention=0, flash_attention_bwd=0,
                wlbvt_select=0, ssd_scan=0,
                flash_attention=kinds.count(LOCAL_ATTN),
                rglru_scan=kinds.count(RGLRU))

    def forward(c):
        module.cfg = c
        with torch.no_grad():
            return module(tokens, positions)[0][:, -64:].float()
    ops.reset_launches()
    served, wall = sync_time(lambda: forward(cfg))
    launches = dict(ops.LAUNCHES)
    f32 = dataclasses.replace(cfg, dtype="float32")
    ker = forward(f32)
    ops.reset_launches()
    plain = forward(dataclasses.replace(f32, attn_impl="chunked"))
    plain_launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    module.cfg = cfg
    err = (ker - plain).abs().max().item()
    scale = plain.abs().max().item()
    agree = (ker.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"rg cache-free forward: layers={cfg.num_layers} "
        f"({kinds.count(RGLRU)} rglru, {kinds.count(LOCAL_ATTN)} local, "
        f"window {cfg.window_size}, head dim {cfg.head_dim}) B={B} S={S} "
        f"bf16 wall_s={wall:.3f} launches={launches}; logits of the last 64 "
        f"positions: bf16 finite={bool(torch.isfinite(served).all())}, "
        f"fp32 kernel vs chunked max_abs_err={err:.4g} max_abs_logit="
        f"{scale:.4g} (tol 2e-3 of it) greedy_agreement={agree:.3f}; "
        f"chunked launched {plain_launches}")
    del module
    torch.cuda.empty_cache()
    if launches != want:
        raise AssertionError(f"rg cache-free: launches {launches}, want "
                             f"{want}")
    if not torch.isfinite(served).all() or served.shape != (
            B, 64, cfg.vocab_size):
        raise AssertionError("rg cache-free: bf16 logits not finite or of "
                             "the wrong shape")
    if err > 2e-3 * scale or plain_launches.get("flash_attention"):
        raise AssertionError("rg cache-free: kernel path disagrees with "
                             "chunked")
    return dict(launches=launches, wall=wall, err=err, scale=scale)


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
    for lib, fn, regs, st, ld in ptxas_report(logs, r"Li256E"):
        log(f"build {lib}: head dim 256 {fn}: {regs} registers, {st} bytes "
            f"spill stores, {ld} bytes spill loads")
    check_tensor_cores()

    err = check_decode_attention()
    timings = [time_decode_attention(256, 100),
               time_decode_attention(256, 100, shape=RG_DECODE, window=2048,
                                     ring=True),
               time_decode_attention(4096, 20),
               time_decode_attention(2048, 50, shape=RG_DECODE, window=2048,
                                     ring=True, lengths=RG_RING_LENGTHS)]
    for t in timings:
        log("time decode_attention bf16 (ms, library_ms: CUDA-graph "
            "replays; eager_ms, library_eager_ms, plain_ms: launched from "
            "Python) " + fields(t))
    # Qwen3: GQA with G = 2 on the smoke config's 4 KV heads
    check_small("qwen3-8b", 16, 4, num_heads=8)

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
    check_full_width(ex.params, cfg)
    profile_decode(ex)
    del rt, ex
    torch.cuda.empty_cache()

    ssd_err = check_ssd_scan()
    ssd_t = time_ssd_scan(SSD_SERVE, True, 200, 10)
    ssd_cf = time_ssd_scan(dict(SSD_CASES)["cache_free"], False, 10, 2)
    for t in (ssd_t, ssd_cf):
        log("time ssd_scan bf16 (ms, plain_ms: CUDA-graph replays; "
            "eager_ms: launched from Python) " + fields(t))
    rg_err = check_rglru_scan()
    rg_t = time_rglru_scan(RGLRU_SERVE, 200)
    log("time rglru_scan fp32 (ms, plain_ms: CUDA-graph replays; eager_ms: "
        "launched from Python) " + fields(rg_t))
    # a ragged second SSD chunk (16 + 8), decode past the 32-entry ring
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        check_small(arch, 24, 16)
    mamba = serve_recurrent("mamba2-370m")
    rgemma = serve_recurrent("recurrentgemma-2b")
    rg_free = rg_cache_free_phase()

    sel_err = check_wlbvt_select()
    sel_times = [time_wlbvt_select(256, 8, 1, torch.float64, 5000),
                 time_wlbvt_select(256, 8, 1, torch.float32, 5000),
                 time_wlbvt_select(4096, 128, 32, torch.float32, 500)]
    for st in sel_times:
        log("time wlbvt_select (ms: CUDA-graph replays; eager_ms: launched "
            "from Python) " + fields(st))
    sel_launches = sweep_phase()

    flash_err = check_flash_attention()
    ft = time_flash_attention(20)
    log("time flash_attention bf16 B=4 S=T=1024 Hq=32 Hkv=8 D=128 causal "
        + fields(ft))
    frg = time_flash_attention(10, RG_FLASH)
    log("time flash_attention bf16 B=1 S=T=4096 Hq=10 Hkv=1 D=256 causal "
        "window=2048 " + fields(frg))
    tr = train_phase()
    for h in tr["hist"]:
        log(f"train step {h['step']}: loss={h['loss']:.6f} "
            f"grad_norm={h['grad_norm']:.6f} step_s={h['step_s']:.4f} "
            f"tokens_per_s={h['tokens_per_s']:.1f}")

    t = timings[0]
    st = sel_times[0]
    log(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:23",
        "launches": launches["decode_attention"]
        + rgemma["launches"]["decode_attention"], "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}, {
        "name": "wlbvt_select", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wlbvt_select.cu",
        "replaces": "src/repro/kernels/wlbvt_select.py:114",
        "launches": sel_launches, "max_abs_err": sel_err,
        "ms": st["ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": tr["launches"]["flash_attention"],
        "max_abs_err": flash_err["fwd_err"], "ms": ft["fwd_ms"],
        "plain_ms": ft["plain_fwd_ms"], "bound_ms": ft["fwd_bound_ms"],
        "bound_by": ft["fwd_bound_by"], "library_ms": ft["library_fwd_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28 (its "
                    "gradient; no Pallas backward)",
        "launches": tr["launches"]["flash_attention_bwd"],
        "max_abs_err": flash_err["bwd_err"], "ms": ft["bwd_ms"],
        "plain_ms": ft["plain_bwd_ms"], "bound_ms": ft["bwd_bound_ms"],
        "bound_by": ft["bwd_bound_by"],
        "library_ms": ft["library_bwd_ms"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:22",
        "launches": mamba["launches"]["ssd_scan"], "max_abs_err": ssd_err,
        "ms": ssd_t["ms"], "plain_ms": ssd_t["plain_ms"],
        "bound_ms": ssd_t["bound_ms"], "bound_by": ssd_t["bound_by"],
        "library_ms": None}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:20",
        "launches": rgemma["launches"]["rglru_scan"], "max_abs_err": rg_err,
        "ms": rg_t["ms"], "plain_ms": rg_t["plain_ms"],
        "bound_ms": rg_t["bound_ms"], "bound_by": rg_t["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
