"""Flash attention: the port's plain forward and backward against the JAX
package's Pallas kernel (interpret mode), its oracle and ``jax.vjp`` of
the oracle; the ``autograd.Function`` against autograd of the plain
forward; and, on the card, the CUDA kernels against the plain versions
(bf16 goes to the wgmma kernels, fp32 to the scalar ones), on the JAX
package's cases and on the edges of the bf16 kernels' tiles.

Forward tolerances are those of tests/test_kernels.py: 2e-5 in float32,
2e-2 in bfloat16, absolute (both sides round the same bf16 inputs, then
sum in another order).  Gradients are held to max |diff| <= 1e-4 *
max |reference| in float32: the backward forms P from the saved
log-sum-exp and sums in another order than XLA's gradient.  JAX is
imported inside the tests that use it, so the ``gpu`` tests also collect
where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}

# B, S, T, Hq, Hkv, D, window, cap, causal: the cases of
# tests/test_kernels.py, then causal off, four query heads per KV head
# at head dim 128 (Qwen3-8B's grouping) and MHA at head dim 256
# (Gemma-7B's: G = 1, S off the bf16 backward's 64-row tiles)
CASES = [
    (2, 128, 128, 4, 4, 64, 0, 0.0, True),       # MHA
    (2, 256, 256, 8, 2, 64, 0, 0.0, True),       # GQA 4:1
    (2, 192, 192, 4, 1, 128, 0, 0.0, True),      # MQA, unaligned S
    (2, 256, 256, 8, 4, 64, 96, 0.0, True),      # sliding window
    (2, 128, 128, 4, 4, 64, 0, 50.0, True),      # gemma2 soft-cap
    (2, 320, 320, 2, 2, 32, 64, 30.0, True),     # window + cap + unaligned
    (1, 64, 96, 2, 2, 32, 0, 0.0, False),        # causal off, T != S
    (1, 160, 160, 8, 2, 128, 0, 0.0, True),      # G = 4 at D 128
    (2, 100, 100, 4, 4, 256, 0, 0.0, True),      # MHA at D 256, ragged
]
IDS = ["mha", "gqa4", "mqa_unaligned", "window", "softcap", "win_cap_odd",
       "noncausal", "g4_d128", "mha_d256"]

# On the card only: the edges of the bf16 kernels' 128-row / 128-key tiles
# (S * G and T not multiples of 128), G = 3 and 8, head dim 16, a window
# shorter than a tile at head dim 128, a cap with a window, non-causal
# with T < S.
EDGE_CASES = [
    (2, 200, 200, 6, 2, 64, 0, 0.0, True),       # G = 3, S * G = 600
    (2, 130, 130, 4, 2, 16, 0, 0.0, True),       # head dim 16, ragged
    (1, 300, 300, 8, 2, 128, 20, 0.0, True),     # window 20 < one tile
    (1, 300, 200, 4, 2, 64, 0, 0.0, False),      # non-causal, T < S
    (1, 260, 260, 8, 1, 32, 50, 20.0, True),     # G = 8, cap + window
    # head dim 256 with RecurrentGemma-2B's grouping (10 heads on 1 KV
    # head): the bf16 forward's 64-key tiles and m64n256 output, the bf16
    # backward's rows by cp.async (G = 10 does not divide its 64-row
    # tiles), the fp32 backward's 32 x 32 tiles
    (1, 200, 200, 10, 1, 256, 0, 0.0, True),     # S * G = 2000, ragged
    (2, 300, 300, 10, 1, 256, 100, 0.0, True),   # window
    (1, 260, 260, 10, 1, 256, 64, 30.0, True),   # cap + window
    # Whisper's encoder: non-causal, S = T = 1500 (ragged last tiles)
    (1, 1500, 1500, 20, 20, 64, 0, 0.0, False),
]
EDGE_IDS = ["g3_ragged", "d16_ragged", "win20_d128", "noncausal_t_lt_s",
            "g8_cap_win", "g10_d256_ragged", "g10_d256_window",
            "g10_d256_cap_win", "whisper_enc"]

# head dim 256 on the CPU: RecurrentGemma-2B's grouping, a window shorter
# than S, causal
D256_CASE = (1, 96, 96, 10, 1, 256, 32, 0.0, True)


def _inputs(case, seed=0):
    B, S, T, Hq, Hkv, D, win, cap, causal = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    kw = dict(scale=float(1.0 / np.sqrt(D)), causal=causal, window=win,
              cap=cap)
    return q, k, v, do, kw


def _torch(x, dtype, device="cpu"):
    return torch.from_numpy(x).to(getattr(torch, dtype)).to(device)


def _rel_err(got, want):
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_forward_matches_jax_kernel_and_oracle(case, dtype):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    q, k, v, _, kw = _inputs(case)
    before = dict(tops.LAUNCHES)
    got = tops.flash_attention(*(_torch(x, dtype) for x in (q, k, v)), **kw)
    assert tops.LAUNCHES == before          # the plain version, no kernel
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype))
                  for x in (q, k, v))
    want_kernel = jops.flash_attention(jq, jk, jv, bq=64, bk=64,
                                       interpret=True, **kw)
    want_ref = jref.flash_attention_ref(jq, jk, jv, **kw)
    got = got.float().numpy()
    for want in (want_kernel, want_ref):
        err = np.abs(got - np.asarray(want.astype(jnp.float32))).max()
        assert err < TOL[dtype], err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_forward_at_head_dim_256_matches_jax_kernel_and_oracle(dtype):
    """The shape the kernels now take at head dim 256 (RecurrentGemma-2B's
    local attention): the plain forward against the JAX package's Pallas
    kernel in interpret mode and its oracle."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    q, k, v, _, kw = _inputs(D256_CASE, seed=7)
    got = tops.flash_attention(*(_torch(x, dtype) for x in (q, k, v)), **kw)
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype))
                  for x in (q, k, v))
    want_kernel = jops.flash_attention(jq, jk, jv, bq=64, bk=64,
                                       interpret=True, **kw)
    want_ref = jref.flash_attention_ref(jq, jk, jv, **kw)
    got = got.float().numpy()
    for want in (want_kernel, want_ref):
        err = np.abs(got - np.asarray(want.astype(jnp.float32))).max()
        assert err < TOL[dtype], err


@pytest.mark.parametrize("case", CASES + [D256_CASE],
                         ids=IDS + ["g10_d256"])
def test_plain_backward_matches_jax_vjp(case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, k, v, do, kw = _inputs(case, seed=1)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention_ref(tq, tk, tv, **kw)
    got = tref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    out, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c,
                                                                **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=2e-5,
                               rtol=2e-5)
    for name, g, w in zip("qkv", got, vjp(jnp.asarray(do))):
        err = _rel_err(g.numpy(), w)
        assert err <= GRAD_RTOL["float32"], (name, err)


@pytest.mark.parametrize("case", CASES + [D256_CASE],
                         ids=IDS + ["g10_d256"])
def test_autograd_function_matches_autograd_of_plain_forward(case):
    q, k, v, do, kw = _inputs(case, seed=2)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(tops.LAUNCHES)
    out = tops.flash_attention(*a, **kw)
    (out * torch.from_numpy(do)).sum().backward()
    want, _ = tref.flash_attention_ref(*b, **kw)
    (want * torch.from_numpy(do)).sum().backward()
    assert tops.LAUNCHES == before
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    for name, x, y in zip("qkv", a, b):
        err = _rel_err(x.grad.numpy(), y.grad.numpy())
        assert err <= GRAD_RTOL["float32"], (name, err)


@pytest.mark.parametrize("causal,window,cap", [(True, 3, 5.0), (False, 0, 0.0),
                                              (True, 0, 0.0)])
def test_gradcheck_float64(causal, window, cap):
    rng = np.random.default_rng(3)
    shapes = [(1, 5, 4, 4), (1, 5, 2, 4), (1, 5, 2, 4)]
    args = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
            for s in shapes]

    def f(q, k, v):
        return tops.flash_attention(q, k, v, scale=0.7, causal=causal,
                                    window=window, cap=cap)
    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-6)


def test_lse_is_the_folded_row_logsumexp():
    q, k, v, _, kw = _inputs(CASES[1])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = tref.flash_attention_ref(tq, tk, tv, **kw)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s = torch.einsum("bshd,bthd->bhst", tq * kw["scale"],
                     tk.repeat_interleave(G, dim=2))        # (B,Hq,S,T)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -1e30)
    want = torch.logsumexp(s, dim=-1)                       # (B,Hq,S)
    want = want.reshape(B, Hkv, G, S).permute(0, 1, 3, 2).reshape(B, Hkv, -1)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v, do, kw = _inputs(CASES[0])
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(tq, tk, tv, **kw)
    o, lse = tref.flash_attention_ref(tq, tk, tv, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(tq, tk, tv, o, lse, tdo, **kw)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel."""

    @property
    def device(self):
        return torch.device("xpu")


def test_ops_refuses_other_devices():
    x = torch.zeros((1, 2, 2, 16)).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="no kernel"):
        tops.flash_attention(x, x, x, scale=1.0)
    # the meta device computes nothing: the dry run's shapes (its work
    # goes to ``ops.PLAN_COUNTER``)
    m = torch.zeros((1, 2, 2, 16), device="meta")
    out = tops.flash_attention(m, m, m, scale=1.0)
    assert out.device.type == "meta" and out.shape == m.shape


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _check_on_card(tq, tk, tv, tdo, kw, dtype):
    """Both kernels against the plain versions on the same inputs."""
    o, lse = flash_attention_cuda(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    want_o, want_lse = tref.flash_attention_ref(tq, tk, tv, **kw)
    tol = TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    got = flash_attention_bwd_cuda(tq, tk, tv, o, lse, tdo, **kw)
    torch.cuda.synchronize()
    want = tref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for name, g, w in zip("qkv", got, want):
        err = _rel_err(g.float().cpu().numpy(), w.float().cpu().numpy())
        assert err <= GRAD_RTOL[dtype], (name, err)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + EDGE_CASES, ids=IDS + EDGE_IDS)
def test_kernels_match_plain_on_card(case, dtype):
    _need_card()
    q, k, v, do, kw = _inputs(case, seed=4)
    _check_on_card(*(_torch(x, dtype, "cuda") for x in (q, k, v, do)), kw,
                   dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [CASES[7], EDGE_CASES[0]],
                         ids=["g4_d128", "g3_ragged"])
def test_kernels_read_slices_of_a_fused_buffer_on_card(case):
    """q, k, v as strided slices of one (B, S, Hq + 2 Hkv, D) buffer, as a
    fused projection gives them: the kernels read them through strides."""
    _need_card()
    B, S, T, Hq, Hkv, D, *_ = case
    q, k, v, do, kw = _inputs(case, seed=6)
    fused = torch.cat([_torch(x, "bfloat16", "cuda") for x in (q, k, v)],
                      dim=2)
    tq, tk, tv = (fused[:, :, :Hq], fused[:, :, Hq:Hq + Hkv],
                  fused[:, :, Hq + Hkv:])
    assert not tq.is_contiguous() and tk.stride(1) == (Hq + 2 * Hkv) * D
    _check_on_card(tq, tk, tv, _torch(do, "bfloat16", "cuda"), kw,
                   "bfloat16")


@pytest.mark.gpu
def test_kernels_raise_on_a_misaligned_address_or_stride():
    """TMA and the 16-byte copies need every address and byte stride to be
    a multiple of 16: a slice one element in, or a head stride of 20
    elements, raises instead of reading wrong rows."""
    _need_card()
    x = torch.zeros((1, 8, 6, 64), device="cuda", dtype=torch.bfloat16)
    shifted = [x[:, :, 2 * i:2 * i + 2, 1:33] for i in range(3)]
    z = torch.zeros((1, 8, 40), device="cuda",
                    dtype=torch.bfloat16).view(1, 8, 2, 20)[..., :16]
    assert z.stride() == (320, 40, 20, 1)         # 40-byte head stride
    for args in (shifted, [z] * 3):
        with pytest.raises(ValueError, match="multiples of 16"):
            flash_attention_cuda(*args, scale=1.0)


@pytest.mark.gpu
def test_model_qkv_pass_the_kernels_checks(monkeypatch):
    """The model's own q, k, v (reshaped projections after the q/k norm and
    RoPE) meet the kernels' layout and alignment rules: a bf16 forward of
    the smoke Qwen3 on the card runs the forward kernel once a layer."""
    _need_card()
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), attn_impl="pallas",
                              num_heads=8, num_kv_heads=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    module = transformer.init_model(cfg, gen)
    seen = []

    def spy(q, k, v, **kw):
        fa._check(q, k, v)
        seen.append((q.dtype, q.stride(), k.stride()))
        return fa.flash_attention_cuda(q, k, v, **kw)
    monkeypatch.setattr(tops, "flash_attention_cuda", spy)
    tokens = torch.arange(2 * 40, device="cuda").reshape(2, 40) % 257
    positions = transformer.make_positions(cfg, 2, 40, "cuda")
    with torch.no_grad():
        logits, _, _ = module(tokens, positions)
    assert torch.isfinite(logits.float()).all()
    assert len(seen) == cfg.num_layers
    assert all(dt == torch.bfloat16 for dt, _, _ in seen)


@pytest.mark.gpu
def test_ops_on_card_launches_both_kernels():
    _need_card()
    q, k, v, do, kw = _inputs(CASES[1], seed=5)
    args = [_torch(x, "float32", "cuda").requires_grad_(True)
            for x in (q, k, v)]
    tops.reset_launches()
    out = tops.flash_attention(*args, **kw)
    out.backward(_torch(do, "float32", "cuda"))
    assert tops.LAUNCHES["flash_attention"] == 1
    assert tops.LAUNCHES["flash_attention_bwd"] == 1


@pytest.mark.gpu
def test_kernel_raises_on_a_head_dim_it_was_not_built_for():
    _need_card()
    x = torch.zeros((1, 8, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(x, x, x, scale=1.0)
