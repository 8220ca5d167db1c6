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
  7. a profile of one full-width decode step: device time by kernel.

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

from repro_torch.api import ServeRuntime, get_scenario  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.ref import decode_attention_ref  # noqa: E402
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

    t = timings[0]
    log(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:23",
        "launches": launches["decode_attention"], "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
