"""Decode attention: the port's plain version against the JAX package's
oracle and its Pallas kernel (interpret mode), and the CUDA kernel
against the plain version on the card.

Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 (both sides round the same inputs to bf16, then sum in another
order).  JAX is imported inside the tests that use it, so the ``gpu``
tests also collect where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_cuda

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# B, T, Hq, Hkv, D, window, cap, lengths
CASES = [
    (4, 40, 8, 2, 16, 0, 0.0, [0, 1, 40, 17]),       # empty, one, full, ragged
    (3, 64, 4, 4, 32, 16, 0.0, [64, 30, 5]),         # sliding window
    (2, 33, 4, 1, 16, 0, 30.0, [33, 12]),            # soft-cap, MQA, odd T
    (2, 50, 8, 2, 16, 8, 20.0, [50, 9]),             # window + cap
]


def _inputs(case, dtype, seed=0):
    B, T, Hq, Hkv, D, win, cap, lens = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    lengths = np.asarray(lens, np.int32)
    return q, k, v, lengths, 1.0 / np.sqrt(D), win, cap


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_oracle_and_pallas_kernel(case, dtype):
    q, k, v, lengths, scale, win, cap = _inputs(case, dtype)
    got = tref.decode_attention_ref(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(lengths), scale=scale, window=win, cap=cap)
    got = got.float().numpy()
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    jq, jk, jv = (jnp.asarray(x).astype(getattr(jnp, dtype))
                  for x in (q, k, v))
    want_ref = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths),
                                         scale=scale, window=win, cap=cap)
    want_kernel = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths),
                                        scale=scale, window=win, cap=cap,
                                        bk=16, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, np.asarray(want_ref, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(got, np.asarray(want_kernel, np.float32),
                               atol=tol, rtol=tol)
    empty = lengths <= 0
    assert np.all(got[empty] == 0.0) and np.isfinite(got).all()


def test_ops_on_cpu_takes_the_plain_version():
    q, k, v, lengths, scale, win, cap = _inputs(CASES[0], "float32")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(lengths)
    before = dict(tops.LAUNCHES)
    out = tops.decode_attention(tq, tk, tv, tl, scale=scale)
    want = tref.decode_attention_ref(tq, tk, tv, tl, scale=scale)
    assert torch.equal(out, want)
    assert tops.LAUNCHES == before          # no kernel ran


def test_plain_reads_strided_cache_views():
    """The kernel reads K/V through their strides; the plain version
    gives the same answer on a strided view as on a copy."""
    q, k, v, lengths, scale, _, _ = _inputs(CASES[0], "float32")
    big = torch.from_numpy(np.concatenate([k, k], axis=2))   # Hkv doubled
    kv = big[:, :, : k.shape[2]]
    assert not kv.is_contiguous()
    tq, tl = torch.from_numpy(q), torch.from_numpy(lengths)
    a = tref.decode_attention_ref(tq, kv, kv, tl, scale=scale)
    b = tref.decode_attention_ref(tq, kv.contiguous(), kv.contiguous(), tl,
                                  scale=scale)
    assert torch.equal(a, b)


# B, T, Hq, Hkv, D, window, lengths: rings of T entries that have seen
# ``lengths`` tokens (wrapped past T), window the ring or less
RING_CASES = [
    (4, 32, 8, 2, 16, 32, [0, 20, 45, 70]),
    (4, 32, 10, 1, 32, 24, [1, 32, 33, 90]),
]


def _ring_positions(lengths, T, seed=0):
    """Stored positions of a ring: index t holds the latest position
    p < length with p = t mod T (-1 if none); two entries of each row
    past 2 tokens are -1, as a ragged prefill's pad rows leave them."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    pos = np.stack([np.where(t <= n - 1, t + ((n - 1 - t) // T) * T, -1)
                    for n in lengths]).astype(np.int32)
    for b, n in enumerate(lengths):
        if n > 2:
            pos[b, rng.choice(T, 2, replace=False)] = -1
    return pos


@pytest.mark.parametrize("case", RING_CASES)
def test_plain_with_positions_matches_jax_naive_attention(case):
    """With ring positions the plain version masks as the JAX package's
    ``naive_attention`` does for the query at position length - 1
    (keys with pos >= 0, pos <= q_pos, q_pos - pos < window)."""
    import jax.numpy as jnp
    from repro.models.attention import naive_attention as jax_naive
    B, T, Hq, Hkv, D, win, lens = case
    q, k, v, _, scale, _, _ = _inputs((B, T, Hq, Hkv, D, win, 0.0, lens),
                                      "float32")
    lengths = np.asarray(lens, np.int32)
    pos = _ring_positions(lens, T)
    got = tref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths), scale=scale, window=win,
        positions=torch.from_numpy(pos))
    qpos = jnp.asarray(lengths - 1)[:, None]
    want = jax_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qpos,
                     jnp.asarray(pos), scale=scale, window=win,
                     k_valid=jnp.asarray(pos >= 0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert np.all(got.numpy()[lengths <= 0] == 0.0)


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v, lengths, scale, _, _ = _inputs(CASES[0], "float32")
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths),
                              scale=scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + [
    (8, 256, 32, 8, 128, 0, 0.0, [0, 1, 256, 7, 100, 129, 64, 255]),
])
def test_kernel_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    q, k, v, lengths, scale, win, cap = _inputs(case, dtype)
    dev = torch.device("cuda")
    tq, tk, tv = (_torch(x, dtype).to(dev) for x in (q, k, v))
    tl = torch.from_numpy(lengths).to(dev)
    got = decode_attention_cuda(tq, tk, tv, tl, scale=scale, window=win,
                                cap=cap)
    torch.cuda.synchronize()
    want = tref.decode_attention_ref(tq, tk, tv, tl, scale=scale,
                                     window=win, cap=cap)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(got[tl <= 0] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", RING_CASES + [
    (8, 256, 10, 1, 256, 2048, [0, 1, 256, 7, 100, 129, 64, 255]),
])
def test_kernel_with_positions_matches_plain_on_card(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, T, Hq, Hkv, D, win, lens = case
    q, k, v, lengths, scale, _, _ = _inputs((B, T, Hq, Hkv, D, win, 0.0,
                                             lens), dtype)
    dev = torch.device("cuda")
    tq, tk, tv = (_torch(x, dtype).to(dev) for x in (q, k, v))
    tl = torch.from_numpy(lengths).to(dev)
    pos = torch.from_numpy(_ring_positions(lens, T)).to(dev)
    got = decode_attention_cuda(tq, tk, tv, tl, scale=scale, window=win,
                                positions=pos)
    torch.cuda.synchronize()
    want = tref.decode_attention_ref(tq, tk, tv, tl, scale=scale,
                                     window=win, positions=pos)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.all(got[tl <= 0] == 0)
