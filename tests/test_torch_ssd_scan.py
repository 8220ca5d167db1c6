"""The SSD scan: the port's plain version and chunked model path against
the JAX package's oracle, Pallas kernel (interpret mode) and model path,
and the CUDA kernel against the plain version on the card.

Shapes are tests/test_kernels.py's (groups, ragged chunks), each with and
without an initial state.  Tolerances: 1e-4 between the two sequential
oracles in float32 (the same recurrence, summed in another order),
1e-3 between a chunked form and a sequential one in float32 and 5e-2 in
bfloat16 (tests/test_kernels.py's: the chunked forms reassociate the
sums, and bf16 outputs round at 2^-8 of their magnitude).  JAX is
imported inside the tests that use it, so the ``gpu`` tests also collect
where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.models.ssm import ssd_chunked

TOL = {"float32": 1e-3, "bfloat16": 5e-2}
ORACLE_TOL = 1e-4

# S, H, P, G, N, chunk: tests/test_kernels.py's sweep
CASES = [
    (128, 4, 32, 1, 16, 64),
    (200, 4, 32, 2, 16, 64),       # groups + ragged chunks
    (96, 2, 64, 1, 32, 32),
]


def _inputs(case, seed=0, B=2, state=False):
    S, H, P, G, N, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = np.log(np.linspace(1.0, 4.0, H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32) * 0.3
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32) * 0.3
    st = (rng.standard_normal((B, H, P, N)).astype(np.float32) * 0.5
          if state else None)
    return x, dt, A_log, Bm, Cm, st


def _t(a, dtype="float32"):
    return None if a is None else torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def _port(x, dt, A_log, Bm, Cm, st, dtype):
    y, last = tops.ssd_scan(_t(x, dtype), _t(dt), _t(A_log), _t(Bm), _t(Cm),
                            init_state=_t(st))
    return y.float().numpy(), last.numpy()


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_pallas_kernel_and_oracle(case, dtype):
    """No initial state: the Pallas kernel's own contract."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    x, dt, A_log, Bm, Cm, _ = _inputs(case)
    y, last = _port(x, dt, A_log, Bm, Cm, None, dtype)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jargs = (jx, jnp.asarray(dt), jnp.asarray(A_log), jnp.asarray(Bm),
             jnp.asarray(Cm))
    ky, klast = jops.ssd_scan(*jargs, chunk=case[-1], interpret=True)
    ry, rlast = jref.ssd_scan_ref(*jargs)
    tol = TOL[dtype]
    _close(y, ky.astype(jnp.float32), tol, "y vs Pallas kernel")
    _close(last, klast, tol, "state vs Pallas kernel")
    otol = ORACLE_TOL if dtype == "float32" else tol
    _close(y, ry.astype(jnp.float32), otol, "y vs oracle")
    _close(last, rlast, otol, "state vs oracle")


@pytest.mark.parametrize("case", CASES)
def test_plain_with_initial_state_matches_jax_oracle_and_model_path(case):
    """From a carried state: the JAX oracle's and ``ssd_chunked``'s
    ``init_state`` (the serving prefill's contract)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=1, state=True)
    y, last = _port(x, dt, A_log, Bm, Cm, st, "float32")
    jargs = [jnp.asarray(a) for a in (x, dt, A_log, Bm, Cm)]
    ry, rlast = jref.ssd_scan_ref(*jargs, init_state=jnp.asarray(st))
    cy, clast = jax_ssd_chunked(*jargs, chunk=case[-1],
                                init_state=jnp.asarray(st))
    _close(y, ry, ORACLE_TOL, "y vs oracle")
    _close(last, rlast, ORACLE_TOL, "state vs oracle")
    _close(y, cy, TOL["float32"], "y vs ssd_chunked")
    _close(last, clast, TOL["float32"], "state vs ssd_chunked")


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_port_chunked_path_matches_jax_chunked_path(case, state):
    """The port's ``ssd_chunked`` (the ``chunked`` model path) against
    the JAX package's, same chunking: both reassociate alike, so 1e-4."""
    import jax.numpy as jnp
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=2, state=state)
    y, last = ssd_chunked(_t(x), _t(dt), _t(A_log), _t(Bm), _t(Cm),
                          case[-1], init_state=_t(st))
    cy, clast = jax_ssd_chunked(
        *[jnp.asarray(a) for a in (x, dt, A_log, Bm, Cm)], chunk=case[-1],
        init_state=None if st is None else jnp.asarray(st))
    _close(y.numpy(), cy, ORACLE_TOL, "y")
    _close(last.numpy(), clast, ORACLE_TOL, "state")


# S, H, P, G, N, chunk in the tensor-core kernel's shapes: N 128, P 64,
# Q 32 (a serve chunk's), two chunks, a ragged last chunk of 8 rows, 2
# groups, and a 256-row chunk (run as 64-row chunks)
BF16_CASES = [(64, 2, 64, 1, 128, 32), (40, 2, 64, 1, 128, 32),
              (96, 4, 64, 2, 128, 32), (300, 2, 64, 1, 128, 256)]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_order_matches_jax_pallas_kernel(case):
    """The tensor-core kernel's chunking and rounding
    (``ref.ssd_scan_bf16_ref``: bf16 x, B, C; fp32 operands as bf16 hi +
    lo; fp32 sums and state) against the JAX Pallas kernel in interpret
    mode and the JAX oracle, bf16, 5e-2."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    x, dt, A_log, Bm, Cm, _ = _inputs(case, seed=4)
    x, Bm, Cm = (_t(a, "bfloat16") for a in (x, Bm, Cm))
    y, last = tref.ssd_scan_bf16_ref(x, _t(dt), _t(A_log), Bm, Cm,
                                     chunk=case[-1])
    jargs = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
             jnp.asarray(dt), jnp.asarray(A_log),
             jnp.asarray(Bm.float().numpy()).astype(jnp.bfloat16),
             jnp.asarray(Cm.float().numpy()).astype(jnp.bfloat16))
    tol = TOL["bfloat16"]
    for name, (wy, wlast) in (
            ("Pallas kernel", jops.ssd_scan(*jargs, chunk=case[-1],
                                            interpret=True)),
            ("oracle", jref.ssd_scan_ref(*jargs))):
        _close(y.float().numpy(), wy.astype(jnp.float32), tol, "y vs " + name)
        _close(last.numpy(), wlast, tol, "state vs " + name)


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_order_with_initial_state_matches_jax_oracle(case):
    """The same, from a carried state (the serving prefill): against the
    JAX oracle, y at 5e-2; the final state, fp32 throughout but for the
    hi + lo operands, at 1e-3."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=5, state=True)
    x, Bm, Cm = (_t(a, "bfloat16") for a in (x, Bm, Cm))
    y, last = tref.ssd_scan_bf16_ref(x, _t(dt), _t(A_log), Bm, Cm, _t(st),
                                     chunk=case[-1])
    wy, wlast = jref.ssd_scan_ref(
        *(jnp.asarray(a.float().numpy()) for a in (x, _t(dt), _t(A_log), Bm,
                                                   Cm)),
        init_state=jnp.asarray(st))
    _close(y.float().numpy(), wy, TOL["bfloat16"], "y vs oracle")
    _close(last.numpy(), wlast, TOL["float32"], "state vs oracle")


@pytest.mark.parametrize("q", [1, 8, 32, 48, 64])
def test_lane_cumsum_is_the_inclusive_cumsum(q):
    """The tensor-core kernel's cumsum order (``ref._lane_cumsum``: pairs,
    then a doubling scan over 32 lanes) is an inclusive cumsum, to fp32
    rounding."""
    a = torch.from_numpy(np.random.default_rng(q).standard_normal((3, q))
                         .astype(np.float32)) * -5.0
    want = torch.cumsum(a.double(), dim=-1)
    got = tref._lane_cumsum(a)
    assert got.dtype == torch.float32 and got.shape == a.shape
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


STATE_TOL = 1e-4        # the final state's, relative to its largest entry


def _close_state(got, want):
    """fp32 states that differ only in the order of their sums."""
    torch.testing.assert_close(got, want, rtol=STATE_TOL,
                               atol=STATE_TOL * want.abs().max().item())


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_kernel_order_keeps_the_lo_products(case):
    """With the same bf16 x, B and C, the emulation's final state is the
    fp32 plain version's to 1e-4 of its largest entry: the hi + lo pairs
    keep ~16 bits of P, W and the state (bf16 operands alone, 8 bits,
    miss by ~2^-9)."""
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=8, state=True)
    args = [_t(x, "bfloat16"), _t(dt), _t(A_log), _t(Bm, "bfloat16"),
            _t(Cm, "bfloat16")]
    _, last = tref.ssd_scan_bf16_ref(*args, _t(st), chunk=case[-1])
    _, want = tref.ssd_scan_ref(*(a.float() for a in args),
                                init_state=_t(st))
    _close_state(last, want)


def test_ops_on_cpu_takes_the_plain_version():
    x, dt, A_log, Bm, Cm, st = (_t(a) for a in _inputs(CASES[1],
                                                        state=True))
    before = dict(tops.LAUNCHES)
    y, last = tops.ssd_scan(x, dt, A_log, Bm, Cm, chunk=64, init_state=st)
    wy, wlast = tref.ssd_scan_ref(x, dt, A_log, Bm, Cm, init_state=st)
    assert torch.equal(y, wy) and torch.equal(last, wlast)
    assert tops.LAUNCHES == before          # no kernel ran


def test_ops_refuses_inputs_that_require_grad():
    x, dt, A_log, Bm, Cm, _ = (_t(a) for a in _inputs(CASES[0]))
    with pytest.raises(NotImplementedError, match="backward"):
        tops.ssd_scan(x.requires_grad_(True), dt, A_log, Bm, Cm, chunk=64)
    with torch.no_grad():       # no graph is built: the forward runs
        tops.ssd_scan(x, dt, A_log, Bm, Cm, chunk=64)


def test_cuda_wrapper_refuses_cpu_tensors():
    x, dt, A_log, Bm, Cm, _ = (_t(a) for a in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(x, dt, A_log, Bm, Cm, chunk=64)


# the serve shape (one prefill chunk of Mamba2-370M: B 8, S 32, H 32,
# P 64, N 128, chunk 256 -> Q 32), a cache-free chunk of 256 rows, and the
# tensor-core kernel's edges: S 1 with P 32, a ragged last chunk of 8 rows,
# 48-row chunks with 2 groups, N 20 / P 24 (element-by-element loads)
CARD_CASES = CASES + [(32, 32, 64, 1, 128, 256), (512, 4, 64, 1, 128, 256),
                      (1, 4, 32, 1, 16, 64), (40, 4, 64, 1, 128, 32),
                      (100, 4, 64, 2, 64, 48), (50, 4, 24, 1, 20, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_plain_on_card(case, dtype, state):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=3, state=state)
    dev = torch.device("cuda")
    args = [_t(x, dtype).to(dev)] + [_t(a).to(dev)
                                     for a in (dt, A_log, Bm, Cm)]
    st = None if st is None else _t(st).to(dev)
    y, last = ssd_scan_cuda(*args, chunk=case[-1], init_state=st)
    torch.cuda.synchronize()
    wy, wlast = tref.ssd_scan_ref(*args, init_state=st)
    tol = TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(last, wlast, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", CARD_CASES)
def test_tensor_core_kernel_matches_plain_on_card(case, state):
    """x, B and C in bf16, as the model serves them: the tensor-core
    kernel, against the plain version at 5e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=6, state=state,
                                       B=8 if case[1] == 32 else 2)
    dev = torch.device("cuda")
    args = [_t(x, "bfloat16").to(dev), _t(dt).to(dev), _t(A_log).to(dev),
            _t(Bm, "bfloat16").to(dev), _t(Cm, "bfloat16").to(dev)]
    st = None if st is None else _t(st).to(dev)
    y, last = ssd_scan_cuda(*args, chunk=case[-1], init_state=st)
    torch.cuda.synchronize()
    wy, wlast = tref.ssd_scan_ref(*args, init_state=st)
    tol = TOL["bfloat16"]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(last, wlast, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("case", CARD_CASES)
def test_tensor_core_kernel_matches_its_rounding_on_card(case, state):
    """The tensor-core kernel against ``ref.ssd_scan_bf16_ref`` (its
    chunking, cumsum order and hi + lo rounding, run on the CPU) on the
    same inputs: y within one bf16 ulp (2^-7 of its size) and 1e-4, the
    final state within 1e-4 of its largest entry.  A kernel that dropped
    the lo products would miss the state by ~2^-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    x, dt, A_log, Bm, Cm, st = _inputs(case, seed=9, state=state,
                                       B=8 if case[1] == 32 else 2)
    args = [_t(x, "bfloat16"), _t(dt), _t(A_log), _t(Bm, "bfloat16"),
            _t(Cm, "bfloat16")]
    st = None if st is None else _t(st)
    dev = torch.device("cuda")
    y, last = ssd_scan_cuda(*(a.to(dev) for a in args), chunk=case[-1],
                            init_state=None if st is None else st.to(dev))
    torch.cuda.synchronize()
    wy, wlast = tref.ssd_scan_bf16_ref(*args, st, chunk=case[-1])
    torch.testing.assert_close(y.cpu().float(), wy.float(), rtol=2**-7,
                               atol=1e-4)
    _close_state(last.cpu(), wlast)
