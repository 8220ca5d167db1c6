"""WLBVT dispatch round: the port's plain versions against the JAX
package's ``wlbvt_select_rounds`` (its dense ``jnp_ref`` oracle and its
Pallas kernel in interpret mode) and against a row-by-row replay of its
scalar ``core.sched_generic.select_round``; the CUDA kernel against the
plain version on the card.

Every comparison is bit-exact: picks, queue lengths and occupancies are
integers decided by float compares, and the plain version sums in the
kernel's fixed lane order (``core.sched_generic.lane_sum``).  JAX is
imported inside the tests that use it, so the ``gpu`` tests also collect
where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sched_generic as G
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.wlbvt_select import wlbvt_select_cuda


def _rand_round(rng, R, T, num_pus, dtype=np.float32, int_prio=False):
    """Inputs in the style of tests/test_devicepath.py::_rand_round."""
    prio = (rng.randint(1, 5, (R, T)) if int_prio
            else rng.uniform(0.5, 4.0, (R, T))).astype(dtype)
    ql = rng.randint(0, 6, (R, T)).astype(np.int32)
    co = rng.randint(0, 3, (R, T)).astype(np.int32)
    to = rng.uniform(0.0, 5e4, (R, T)).astype(dtype)
    bvt = rng.uniform(0.0, 2e4, (R, T)).astype(dtype)
    free = rng.randint(0, num_pus + 1, (R,)).astype(np.int32)
    return prio, ql, co, to, bvt, free


def _t(args, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in args]


def _np(outs):
    return [o.cpu().numpy() for o in outs]


def _np_jax(outs):
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("max_picks", [1, 4, 16])
def test_plain_versions_match_jax_ref_and_pallas_interpret(max_picks):
    pytest.importorskip("jax")
    from repro.kernels.wlbvt_select import wlbvt_select_rounds
    args = _rand_round(np.random.RandomState(7), R=11, T=5, num_pus=32)
    want = {impl: _np_jax(wlbvt_select_rounds(
        *args, num_pus=32, max_picks=max_picks, impl=impl, interpret=True))
        for impl in ("jnp_ref", "pallas")}
    for impl in ("jnp", "jnp_ref", "pallas"):
        got = _np(tops.wlbvt_select_rounds(*_t(args), num_pus=32,
                                           max_picks=max_picks, impl=impl))
        for jimpl, w in want.items():
            for a, b in zip(got, w):
                np.testing.assert_array_equal(a, b, err_msg=(impl, jimpl))


def test_plain_versions_replay_scalar_select_round():
    """f64 row-by-row replay of the JAX package's
    core.sched_generic.select_round, the kernel the host scheduler steps
    through."""
    pytest.importorskip("jax")
    from repro.core import sched_generic as JG
    num_pus, max_picks = 16, 8
    args = _rand_round(np.random.RandomState(3), R=9, T=4, num_pus=num_pus,
                       dtype=np.float64)
    prio, ql, co, to, bvt, free = args
    for fn in (tref.wlbvt_select_rounds_ref,
               tref.wlbvt_select_rounds_early_exit):
        picks, qlo, coo = _np(fn(*_t(args), num_pus=num_pus,
                                 max_picks=max_picks))
        for r in range(prio.shape[0]):
            q, c = ql[r].copy(), co[r].copy()
            for k in range(max_picks):
                if k < free[r]:
                    idx, q, c = JG.select_round(prio[r], q, c, to[r], bvt[r],
                                                num_pus, np)
                else:
                    idx = -1
                assert picks[r, k] == idx, (fn.__name__, r, k)
            np.testing.assert_array_equal(qlo[r], q)
            np.testing.assert_array_equal(coo[r], c)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("int_prio", [False, True])
def test_early_exit_equals_dense(dtype, int_prio):
    args = _rand_round(np.random.RandomState(11), R=17, T=9, num_pus=32,
                       dtype=dtype, int_prio=int_prio)
    dense = _np(tref.wlbvt_select_rounds_ref(*_t(args), num_pus=32,
                                             max_picks=40))
    early = _np(tref.wlbvt_select_rounds_early_exit(*_t(args), num_pus=32,
                                                    max_picks=40))
    for a, b in zip(dense, early):
        np.testing.assert_array_equal(a, b)


def test_ties_empty_rows_and_no_free_pus():
    """At t = 0 every metric is 0: the lowest eligible lane wins; an
    all-empty row and a row with free_k = 0 grant nothing and keep their
    state."""
    R, T = 3, 6
    prio = torch.ones(R, T, dtype=torch.float64)
    ql = torch.tensor([[0, 2, 2, 1, 0, 3], [0] * T, [1] * T],
                      dtype=torch.int32)
    co = torch.zeros(R, T, dtype=torch.int32)
    to = torch.zeros(R, T, dtype=torch.float64)
    free = torch.tensor([3, 5, 0], dtype=torch.int32)
    picks, qlo, coo = tref.wlbvt_select_rounds_ref(
        prio, ql, co, to, to.clone(), free, num_pus=32, max_picks=4)
    assert picks[0].tolist() == [1, 1, 2, -1]
    assert picks[1].tolist() == [-1] * 4 and picks[2].tolist() == [-1] * 4
    assert torch.equal(qlo[1:], ql[1:]) and torch.equal(coo[1:], co[1:])
    assert qlo[0].tolist() == [0, 0, 1, 1, 0, 3]


def test_lane_sum_order_is_the_kernel_tree():
    """lane_sum = zero-padded warps of 32, halving tree, warps in order:
    the same bits as the tree over 32 lanes for every width."""
    rng = np.random.default_rng(0)
    for T in (1, 2, 3, 5, 8, 17, 32, 33, 100, 128):
        x = torch.from_numpy(rng.uniform(0.5, 4.0, (4, T)).astype(np.float32))
        W = -(-T // 32)
        y = torch.nn.functional.pad(x, (0, W * 32 - T)).reshape(4, W, 32)
        for off in (16, 8, 4, 2, 1):
            y = y[..., :off] + y[..., off:2 * off]
        want = y[:, 0, 0]
        for w in range(1, W):
            want = want + y[:, w, 0]
        assert torch.equal(G.lane_sum(x), want), T


def test_oversize_raises():
    args = _t(_rand_round(np.random.RandomState(0), R=2, T=200, num_pus=8))
    with pytest.raises(ValueError, match="T <= 128"):
        tops.wlbvt_select_rounds(*args, num_pus=8, max_picks=1,
                                 impl="pallas")
    args = _t(_rand_round(np.random.RandomState(0), R=2, T=8, num_pus=8))
    with pytest.raises(ValueError, match="max_picks <= 128"):
        tops.wlbvt_select_rounds(*args, num_pus=8, max_picks=129,
                                 impl="pallas")
    with pytest.raises(ValueError, match="unknown"):
        tops.wlbvt_select_rounds(*args, num_pus=8, max_picks=1, impl="xla")


def test_ops_on_cpu_takes_the_plain_version():
    args = _t(_rand_round(np.random.RandomState(5), R=6, T=4, num_pus=32))
    before = dict(tops.LAUNCHES)
    got = tops.wlbvt_select_rounds(*args, num_pus=32, max_picks=4)
    want = tref.wlbvt_select_rounds_ref(*args, num_pus=32, max_picks=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tops.LAUNCHES == before          # no kernel ran


def test_cuda_wrapper_refuses_cpu_tensors():
    args = _t(_rand_round(np.random.RandomState(1), R=2, T=4, num_pus=32))
    with pytest.raises(ValueError, match="CUDA"):
        wlbvt_select_cuda(*args, num_pus=32, max_picks=1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("R,T,max_picks", [
    (1, 2, 1), (7, 8, 4), (256, 8, 1), (33, 40, 16), (64, 128, 128),
])
def test_kernel_matches_plain_on_card(dtype, R, T, max_picks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for int_prio in (False, True):
        args = _t(_rand_round(np.random.RandomState(R + T), R, T, 32,
                              dtype=dtype, int_prio=int_prio), "cuda")
        got = tops.wlbvt_select_rounds(*args, num_pus=32,
                                       max_picks=max_picks, impl="pallas")
        torch.cuda.synchronize()
        want = tref.wlbvt_select_rounds_ref(*args, num_pus=32,
                                            max_picks=max_picks)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
