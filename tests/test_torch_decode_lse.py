"""The decode kernel's log-sum-exp output, which the length-sharded
serving cache merges by (``models/attention.py``).

On the CPU: the plain version's lse is the log-sum-exp of the counted,
scaled, soft-capped scores (NEG_INF for a row that counts none), and the
attentions of disjoint position slices of a cache, merged by their lse
(``ServeLayout.merge_lse``'s arithmetic), give the whole cache's
attention: windows, soft-cap, wrapped ring positions and inactive rows
included.  On the card (``gpu``): the kernel's output and lse against
the plain version's at Qwen3-8B's tensor-parallel shapes, 1e-5 in fp32
and phase 4's 2e-2 in bf16 (lse 1e-5 / 1e-2).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

NEG_INF = ref.NEG_INF


def _inputs(B, T, Hq, Hkv, D, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, Hkv, D)).astype(np.float32))
    return [t.to(device=device, dtype=dtype) for t in (q, k, v)]


def _ring(lengths, T, seed):
    """Stored positions of a ring of T entries after ``lengths`` tokens
    (position p at index p mod T; -1 where none was written), a few
    entries then blanked as a ragged prefill leaves them."""
    rng = np.random.default_rng(seed)
    pos = np.full((len(lengths), T), -1, np.int32)
    for b, n in enumerate(lengths):
        for p in range(max(0, n - T), n):
            pos[b, p % T] = p
        pos[b, rng.integers(0, T, 2)] = -1
    return torch.from_numpy(pos)


CASES = [  # B, T, Hq, Hkv, D, window, cap, lengths
    (4, 64, 8, 2, 16, 0, 0.0, [64, 30, 1, 0]),
    (4, 64, 8, 2, 16, 24, 0.0, [100, 64, 7, 0]),
    (3, 32, 4, 4, 32, 0, 30.0, [40, 20, 32]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plain_lse_is_the_log_sum_exp_of_the_counted_scores(case):
    B, T, Hq, Hkv, D, win, cap, lengths = CASES[case]
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=case)
    pos = _ring(lengths, T, seed=case)
    lens = torch.tensor(lengths, dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    o, lse = ops.decode_attention(q, k, v, lens, scale=scale, window=win,
                                  cap=cap, positions=pos, return_lse=True)
    assert torch.equal(o, ops.decode_attention(q, k, v, lens, scale=scale,
                                               window=win, cap=cap,
                                               positions=pos))
    G = Hq // Hkv
    for b in range(B):
        for h in range(Hq):
            s = (q[b, 0, h] * scale) @ k[b, :, h // G].T
            if cap:
                s = cap * torch.tanh(s / cap)
            n = lengths[b]
            keep = (pos[b] >= 0) & (pos[b] < n)
            if win:
                keep &= n - pos[b] <= win
            want = (torch.logsumexp(s[keep], 0).item() if keep.any()
                    else NEG_INF)
            assert lse[b, h].item() == pytest.approx(want, rel=1e-6,
                                                     abs=1e-5)


def _merge(parts):
    """(o, lse) of disjoint key sets -> one attention (merge_lse's sum)."""
    os_ = torch.stack([o.float() for o, _ in parts])
    ls = torch.stack([lse for _, lse in parts])[:, :, None, :]
    w = torch.exp(ls - ls.amax(dim=0))
    return (w[..., None] * os_).sum(0) / w.sum(0)[..., None]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_slices_merged_by_lse_are_the_whole_cache(case, n):
    B, T, Hq, Hkv, D, win, cap, lengths = CASES[case]
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=10 + case)
    pos = _ring(lengths, T, seed=case)
    lens = torch.tensor(lengths, dtype=torch.int32)
    kw = dict(scale=1.0 / math.sqrt(D), window=win, cap=cap)
    whole = ops.decode_attention(q, k, v, lens, positions=pos, **kw)
    Tl = T // n
    parts = [ops.decode_attention(
        q, k[:, r * Tl:(r + 1) * Tl], v[:, r * Tl:(r + 1) * Tl], lens,
        positions=pos[:, r * Tl:(r + 1) * Tl], return_lse=True, **kw)
        for r in range(n)]
    torch.testing.assert_close(_merge(parts), whole, rtol=1e-5, atol=1e-6)
    # a row no slice attends (length 0) stays exactly 0
    for b, L in enumerate(lengths):
        if L == 0:
            assert torch.equal(_merge(parts)[b], torch.zeros_like(whole[b]))


# Qwen3-8B (32 query heads on 8 kv heads, D 128) at tensor-parallel
# degrees 2, 4, 8: the local heads; and the length-sharded case, every
# head over a sixteenth of T 256 with stored positions
TP_SHAPES = [(8, 256, 16, 4), (8, 256, 8, 2), (8, 256, 4, 1),
             (8, 16, 32, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", TP_SHAPES)
def test_kernel_lse_matches_plain_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    B, T, Hq, Hkv = shape
    D = 128
    q, k, v = _inputs(B, T, Hq, Hkv, D, seed=3, dtype=dtype, device="cuda")
    lengths = [T, T - 5, 1, 0, T // 2, 3, T, 7] if T > 16 else \
        [130, 200, 17, 0, 256, 5, 90, 241]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    pos = None if T > 16 else torch.stack([
        torch.arange(T, dtype=torch.int32) + 16 * r for r in
        (0, 3, 1, 0, 15, 0, 5, 15)]).cuda()
    kw = dict(scale=1.0 / math.sqrt(D), positions=pos)
    o, lse = decode_attention_cuda(q, k, v, lens, return_lse=True, **kw)
    wo, wl = ref.decode_attention_ref(q, k, v, lens, return_lse=True, **kw)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), wo.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, wl, rtol=1e-5 if tol == 1e-5 else 1e-2,
                               atol=1e-5 if tol == 1e-5 else 1e-2)
