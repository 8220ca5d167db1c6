"""The RG-LRU scan: the port's plain version and prefix-scan model path
against the JAX package's oracle, Pallas kernel (interpret mode) and
``associative_scan`` model path, and the CUDA kernel against the plain
version on the card.

Shapes are tests/test_kernels.py's (ragged sequence and width tiles),
each with and without h0.  Tolerance 1e-5 (tests/test_kernels.py's): a
recurrence of FMAs in float32 with |a| < 1, where only the rounding of
each step differs.  JAX is imported inside the tests that use it, so the
``gpu`` tests also collect where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as krg
from repro_torch.kernels.rglru_scan import rglru_scan_cuda
from repro_torch.models.rglru import prefix_scan

TOL = 1e-5

# S, W: tests/test_kernels.py's sweep
CASES = [(128, 128), (100, 96), (64, 256)]


def _inputs(case, seed=0, B=2, h0=True):
    S, W = case
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    b = rng.standard_normal((B, S, W)) * 0.1
    h = rng.standard_normal((B, W)) if h0 else None
    return tuple(None if t is None else t.astype(np.float32)
                 for t in (a, b, h))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_pallas_kernel_and_oracle(case, h0):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    a, b, h = _inputs(case, h0=h0)
    got, got_last = tops.rglru_scan(_t(a), _t(b), _t(h))
    jh = None if h is None else jnp.asarray(h)
    for name, (want, want_last) in (
            ("Pallas kernel", jops.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                              jh, interpret=True)),
            ("oracle", jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                                           jh))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=name)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                                   atol=TOL, rtol=TOL, err_msg=name)


# B, S, W at the kernel's segment geometry: one block of 8 warps of 4
# steps (a serve chunk's S), S 1, 3 blocks a cluster over a ragged tile,
# 8 blocks over 1000 steps of 33 channels, and phase 18's S (four tiles
# of a cluster of 8)
SEG_CASES = [(2, 32, 96), (2, 1, 40), (2, 300, 128), (1, 1000, 33),
             (1, 4096, 64)]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("case", SEG_CASES)
def test_segmented_order_matches_plain_and_jax_pallas_kernel(case, h0):
    """The kernel's order of operations (``ref.rglru_scan_segments_ref``
    at the lengths ``geometry`` gives it) against the sequential plain
    version and the JAX Pallas kernel in interpret mode, 1e-5; h_last is
    the h of the last step, bit for bit."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    B, S, W = case
    a, b, h = _inputs((S, W), seed=3, B=B, h0=h0)
    seg_len, cluster = krg.geometry(S)
    got, got_last = tref.rglru_scan_segments_ref(
        _t(a), _t(b), _t(h), seg_len=seg_len, cluster=cluster,
        warps=krg.WARPS)
    assert torch.equal(got_last, got[:, -1])
    want, want_last = jops.rglru_scan(
        jnp.asarray(a), jnp.asarray(b), None if h is None else jnp.asarray(h),
        interpret=True)
    for name, (w, wl) in (("Pallas kernel", (want, want_last)),
                          ("plain", tref.rglru_scan_ref(_t(a), _t(b),
                                                        _t(h)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)
        np.testing.assert_allclose(got_last.numpy(), np.asarray(wl),
                                   atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("B, S, W", [(8, 32, 2560), (1, 4096, 2560)])
def test_geometry_fills_the_card(B, S, W):
    """At both main-path shapes (a RecurrentGemma-2B serve chunk, phase
    18's cache-free forward) the launch has at least one block per SM of
    an H100 (132), and a warp's two buffers fit its registers."""
    seg_len, cluster = krg.geometry(S)
    assert seg_len <= krg.MAX_SEG and 1 <= cluster <= krg.MAX_CLUSTER
    assert cluster * krg.WARPS * seg_len >= min(S, krg.MAX_CLUSTER
                                                * krg.WARPS * krg.MAX_SEG)
    assert B * cluster * -(-W // 32) >= 132


@pytest.mark.parametrize("S, want", [(1, (1, 1)), (32, (4, 1)),
                                     (100, (16, 1)), (1000, (16, 8)),
                                     (4096, (16, 8)), (100_000, (16, 8))])
def test_geometry(S, want):
    assert krg.geometry(S) == want


@pytest.mark.parametrize("case", CASES)
def test_prefix_scan_matches_jax_associative_scan(case):
    """The ``chunked`` model path: ``Bc + A h0`` from the doubling scan
    equals the JAX package's ``associative_scan`` form."""
    import jax
    import jax.numpy as jnp
    a, b, h = _inputs(case, seed=1)

    def combine(l, r):
        return (r[0] * l[0], r[0] * l[1] + r[1])
    A, Bc = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                               jnp.asarray(b)), axis=1)
    want = Bc + A * jnp.asarray(h)[:, None, :]
    tA, tBc = prefix_scan(_t(a), _t(b))
    got = tBc + tA * _t(h)[:, None, :]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_ops_on_cpu_takes_the_plain_version():
    a, b, h = (_t(t) for t in _inputs(CASES[1]))
    before = dict(tops.LAUNCHES)
    got = tops.rglru_scan(a, b, h)
    want = tref.rglru_scan_ref(a, b, h)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tops.LAUNCHES == before          # no kernel ran


def test_ops_refuses_inputs_that_require_grad():
    a, b, h = (_t(t) for t in _inputs(CASES[0]))
    with pytest.raises(NotImplementedError, match="backward"):
        tops.rglru_scan(a, b.requires_grad_(True), h)


def test_cuda_wrapper_refuses_cpu_tensors():
    a, b, h = (_t(t) for t in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(a, b, h)


# the serve shape (B 8), S 1, W 33 and phase 18's shape (B 1, S 4096)
CARD_CASES = ([(2, S, W) for S, W in CASES]
              + [(8, 32, 2560), (2, 1, 2560), (2, 1000, 33), (1, 4096, 2560)])


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, h0, strided):
    """``strided``: a and b are the halves of one (B, S, 2W) buffer, read
    through a row stride of 2W."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    B, S, W = case
    a, b, h = (None if t is None else _t(t).cuda()
               for t in _inputs((S, W), seed=2, B=B, h0=h0))
    if strided:
        ab = torch.cat([a, b], dim=-1)
        a, b = ab[..., :W], ab[..., W:]
        assert a.stride(1) == 2 * W
    got, got_last = rglru_scan_cuda(a, b, h)
    torch.cuda.synchronize()
    want, want_last = tref.rglru_scan_ref(a, b, h)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(got_last, want_last, atol=TOL, rtol=TOL)
