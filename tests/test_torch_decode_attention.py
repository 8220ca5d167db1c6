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
from repro_torch.kernels.decode_attention import (MAX_SPLITS, TILE_KEYS,
                                                  decode_attention_cuda,
                                                  num_splits)

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


# ---------------------------------------------------------------------------
# the kernel's split form (split-K across a cluster), the plain way
# ---------------------------------------------------------------------------
SPLITS = [1, 3, 8]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", CASES)
def test_split_plain_matches_plain_and_jax_oracle(case, splits):
    """The split form gives decode_attention_ref's and the JAX oracle's
    answer (fp32, 2e-5), and exactly 0 on a row of length 0."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    q, k, v, lengths, scale, win, cap = _inputs(case, "float32", seed=3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(lengths)
    got = tref.decode_attention_split_ref(tq, tk, tv, tl, scale=scale,
                                          window=win, cap=cap, splits=splits)
    want = tref.decode_attention_ref(tq, tk, tv, tl, scale=scale, window=win,
                                     cap=cap)
    oracle = jref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(lengths),
                                       scale=scale, window=win, cap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=2e-5)
    assert np.all(got.numpy()[lengths <= 0] == 0.0)


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", RING_CASES)
def test_split_plain_on_a_wrapped_ring_matches_jax_naive_attention(case,
                                                                   splits):
    import jax.numpy as jnp
    from repro.models.attention import naive_attention as jax_naive
    B, T, Hq, Hkv, D, win, lens = case
    q, k, v, _, scale, _, _ = _inputs((B, T, Hq, Hkv, D, win, 0.0, lens),
                                      "float32", seed=4)
    lengths = np.asarray(lens, np.int32)
    pos = _ring_positions(lens, T)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl, tp = torch.from_numpy(lengths), torch.from_numpy(pos)
    got = tref.decode_attention_split_ref(tq, tk, tv, tl, scale=scale,
                                          window=win, positions=tp,
                                          splits=splits)
    want = tref.decode_attention_ref(tq, tk, tv, tl, scale=scale, window=win,
                                     positions=tp)
    qpos = jnp.asarray(lengths - 1)[:, None]
    oracle = jax_naive(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), qpos,
                       jnp.asarray(pos), scale=scale, window=win,
                       k_valid=jnp.asarray(pos >= 0))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-5,
                               rtol=2e-5)
    assert np.all(got.numpy()[lengths <= 0] == 0.0)


@pytest.mark.parametrize("window", [0, 6])
def test_split_plain_with_more_splits_than_live_keys(window):
    """Rows of 0, 1 and 3 live keys over 8 splits: most splits see no
    counted key (m = -inf, l = 0) and must weigh nothing; a row with no
    counted key at all is exactly 0."""
    case = (4, 40, 8, 2, 16, window, 0.0, [0, 1, 3, 40])
    q, k, v, lengths, scale, win, cap = _inputs(case, "float32", seed=5)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tl = torch.from_numpy(lengths)
    want = tref.decode_attention_ref(tq, tk, tv, tl, scale=scale, window=win)
    for splits in (8, 40):
        got = tref.decode_attention_split_ref(tq, tk, tv, tl, scale=scale,
                                              window=win, splits=splits)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
        assert torch.all(got[0] == 0) and torch.isfinite(got).all()


@pytest.mark.parametrize("T,rows,window,positions,want", [
    (256, 64, 0, False, 2),          # Qwen3-8B serving: B 8 x 8 KV heads
    (256, 8, 2048, True, 8),         # RecurrentGemma-2B: B 8 x 1, a ring
    (4096, 64, 0, False, 2),
    (2048, 8, 2048, True, 8),
    (40, 8, 0, False, 2),            # at most one split per 32 keys
    (4096, 64, 16, False, 1),        # by index the window bounds the keys
    (4096, 4096, 0, False, 1),       # enough (b, h) pairs to fill the card
])
def test_num_splits(T, rows, window, positions, want):
    got = num_splits(T, rows, 132, window=window, positions=positions)
    assert got == want
    assert 1 <= got <= MAX_SPLITS and got <= -(-T // TILE_KEYS)


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
    # Qwen3-8B's heads over a 4096-entry cache: 8 splits of up to 512 keys
    (8, 4096, 32, 8, 128, 0, 0.0, [4096, 1, 0, 3000, 2049, 4095, 17, 1024]),
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
    # RecurrentGemma-2B's full 2048-entry ring, wrapped in every row
    (8, 2048, 10, 1, 256, 2048, [2049, 4000, 2817, 3500, 2100, 3999, 2560,
                                 3072]),
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_replays_in_a_cuda_graph_with_new_lengths(dtype):
    """``ops.decode_attention`` captured in a CUDA graph and replayed after
    the lengths (and the ring's positions) were changed in place gives the
    plain version's answer for the new lengths: nothing about the lengths
    is read on the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, T, Hq, Hkv, D, win = 8, 256, 10, 1, 256, 64
    q, k, v, _, scale, _, _ = _inputs((B, T, Hq, Hkv, D, win, 0.0, [T] * B),
                                      dtype, seed=8)
    dev = torch.device("cuda")
    tq, tk, tv = (_torch(x, dtype).to(dev) for x in (q, k, v))
    old, new = [T] * B, [0, 1, 5, 256, 300, 33, 1000, 2]
    lens = torch.tensor(old, dtype=torch.int32, device=dev)
    pos = torch.from_numpy(_ring_positions(old, T)).to(dev)
    for positions, window in ((None, 0), (pos, win)):
        out = tops.decode_attention(tq, tk, tv, lens, scale=scale,
                                    window=window, positions=positions)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tops.decode_attention(tq, tk, tv, lens, scale=scale,
                                        window=window, positions=positions)
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        pos.copy_(torch.from_numpy(_ring_positions(new, T, seed=1)))
        graph.replay()
        torch.cuda.synchronize()
        want = tref.decode_attention_ref(tq, tk, tv, lens, scale=scale,
                                         window=window, positions=positions)
        tol = TOL[dtype]
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)
        assert torch.all(out[lens <= 0] == 0)
        lens.copy_(torch.tensor(old, dtype=torch.int32))
        pos.copy_(torch.from_numpy(_ring_positions(old, T)))
