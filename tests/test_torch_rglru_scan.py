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


@pytest.mark.gpu
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("case", CASES + [(32, 2560), (1000, 33)])
def test_kernel_matches_plain_on_card(case, h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    a, b, h = (None if t is None else _t(t).cuda()
               for t in _inputs(case, seed=2, B=8 if case[1] == 2560 else 2,
                                h0=h0))
    got, got_last = rglru_scan_cuda(a, b, h)
    torch.cuda.synchronize()
    want, want_last = tref.rglru_scan_ref(a, b, h)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    torch.testing.assert_close(got_last, want_last, atol=TOL, rtol=TOL)
