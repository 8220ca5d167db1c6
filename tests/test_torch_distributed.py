"""The port's collectives, int8 gradient compression and GPipe against
the JAX package's, on the same numpy inputs.

One group of 4 gloo ranks on the CPU (``tests/_torch_dist_worker.py``
``distributed``) runs the port's side once for the whole file; the
reference runs here on its host meshes of forced CPU devices.  The
tolerances are the reference tests' own: 1e-5 for the collective
matmuls, 2e-4 for GPipe against the sequential stack.  The reference's
compressed all-reduce test fails on jax 0.9, so ``psum_compressed`` is
held against quantize-then-sum with the shared scale, computed from the
reference's own quantizer.
"""
import functools

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_dist_worker as W
from repro_torch.configs import smoke_config
from repro_torch.distributed import compression as Q
from repro_torch.distributed import pipeline as PP
from repro_torch.training.trainer import build_trainer

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    _torch_dist.spawn(WORLD, "distributed", out)
    return [dict(np.load(out / f"distributed_r{r}.npz"))
            for r in range(WORLD)]


def _jax():
    return pytest.importorskip("jax")


@pytest.fixture(scope="module")
def host_mesh():
    """The reference tests' meshes, over CPU devices; skipped where JAX is
    missing or has fewer than 8 CPU devices (another machine's settings),
    where the port's own checks still run."""
    return _torch_dist.jax_cpu_mesh((2, 4), ("data", "model"))


@pytest.fixture(scope="module")
def pod_mesh():
    return _torch_dist.jax_cpu_mesh((2, 2, 2), ("pod", "data", "model"))


def _ref_shard_map(fn, mesh, in_specs, out_specs, *args):
    from repro.distributed.compat import shard_map
    return np.asarray(shard_map(fn, mesh=mesh, in_specs=in_specs,
                                out_specs=out_specs, check_vma=False)(*args))


# ---------------------------------------------------------------------------
# collective matmuls over the model axis (4 ranks)
# ---------------------------------------------------------------------------
def test_collective_matmul_ag_matches_the_reference(ranks, host_mesh):
    _jax()
    from jax.sharding import PartitionSpec as P
    from repro.distributed import collectives as JC
    a = W.inputs()
    want = _ref_shard_map(functools.partial(JC.collective_matmul_ag,
                                            axis_name="model"),
                          host_mesh, (P(), P("model", None)), P(),
                          a["x"], a["w"])
    np.testing.assert_allclose(want, a["x"] @ a["w"], rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["ag"], want, rtol=1e-5, atol=1e-5)


def test_reduce_scatter_matmul_matches_the_reference(ranks, host_mesh):
    _jax()
    from jax.sharding import PartitionSpec as P
    from repro.distributed import collectives as JC
    a = W.inputs()
    want = _ref_shard_map(functools.partial(JC.reduce_scatter_matmul,
                                            axis_name="model"),
                          host_mesh, (P(None, "model"), P("model", None)),
                          P(None, "model"), a["x"], a["w"])
    got = np.concatenate([r["rs"] for r in ranks], axis=-1)
    assert ranks[0]["rs"].shape == (8, 24 // WORLD)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, a["x"] @ a["w"], rtol=1e-5, atol=1e-5)


def test_all_gather_interleaved_matches_the_reference(ranks, host_mesh):
    _jax()
    from jax.sharding import PartitionSpec as P
    from repro.distributed import collectives as JC
    a = W.inputs()

    def body(t):
        return JC.all_gather_interleaved(t[0], "model",
                                         lambda i, s: s * (i + 1))[None]
    want = _ref_shard_map(body, host_mesh, P("model"), P("model"),
                          a["tiles"])
    for k, r in enumerate(ranks):
        np.testing.assert_allclose(r["interleaved"], want[k], rtol=1e-5,
                                   atol=1e-5)


def test_psum_pods_then_data_sums_every_rank(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["pods"], np.full(3, 10.0))


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------
def test_quantize_matches_the_reference():
    jax = _jax()
    from repro.distributed import compression as JQ
    x = (np.random.default_rng(5).standard_normal(1000) * 3.0).astype(
        np.float32)
    c, jc = Q.quantize(torch.from_numpy(x)), JQ.quantize(jax.numpy.asarray(x))
    assert c.q.dtype == torch.int8 and c.pad == jc.pad == 24
    np.testing.assert_array_equal(c.q.numpy(), np.asarray(jc.q))
    # 2 ulps: XLA may divide by 127 through a reciprocal
    np.testing.assert_allclose(c.scale.numpy(), np.asarray(jc.scale),
                               rtol=2.4e-7)
    back = Q.dequantize(c).numpy()
    np.testing.assert_allclose(back, np.asarray(JQ.dequantize(jc)),
                               rtol=1e-6, atol=1e-7)
    assert back.shape == x.shape
    # every element within half its block's step
    step = np.repeat(c.scale.numpy(), Q.BLOCK)[:x.size]
    assert np.all(np.abs(back - x) <= 0.5 * step + 1e-7)


def test_error_feedback_matches_the_reference():
    jax = _jax()
    from repro.distributed import compression as JQ
    g = np.array([0.3, -0.2, 0.7], np.float32)
    e = np.array([0.01, 0.0, -0.02], np.float32)
    comp, err = Q.compress_with_feedback({"w": torch.from_numpy(g)},
                                         {"w": torch.from_numpy(e)})
    jcomp, jerr = JQ.compress_with_feedback({"w": jax.numpy.asarray(g)},
                                            {"w": jax.numpy.asarray(e)})
    np.testing.assert_allclose(err["w"].numpy(), np.asarray(jerr["w"]),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(err["w"].numpy(),
                               g + e - Q.dequantize(comp["w"]).numpy(),
                               rtol=1e-6)


def test_error_feedback_converges_running_sum():
    g = torch.tensor([0.01, -0.003, 0.25, 1.7])
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        comp, e = Q.compress_with_feedback({"g": g}, {"g": err})
        err = e["g"]
        total = total + Q.dequantize(comp["g"])
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=1e-3)


def test_psum_compressed_is_quantize_then_sum_with_the_shared_scale(ranks):
    """Each rank quantizes its row; the all-reduce MAX of the scales is
    the shared scale; the mean is the int sum of the payloads re-quantized
    to it.  Every rank gets the same mean, within a few steps of the true
    one (the reference test's bound)."""
    jax = _jax()
    from repro.distributed import compression as JQ
    xs = W.inputs()["grads"]
    comps = [JQ.quantize(jax.numpy.asarray(x)) for x in xs]
    s_glob = np.max([np.asarray(c.scale) for c in comps], axis=0)
    qsum = sum(np.clip(np.round(
        np.asarray(c.q).reshape(-1, Q.BLOCK).astype(np.float32)
        * np.asarray(c.scale)[:, None] / s_glob[:, None]), -127, 127)
        .astype(np.int32) for c in comps)
    want = (qsum.astype(np.float32) * s_glob[:, None] / WORLD).reshape(-1)
    for k, r in enumerate(ranks):
        np.testing.assert_allclose(r["scale"], np.asarray(comps[k].scale),
                                   rtol=2.4e-7)
        np.testing.assert_allclose(r["psum"], want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(r["psum"], ranks[0]["psum"])
    assert np.max(np.abs(want - xs.mean(0))) < 4 * np.abs(xs).max() / 127


def test_compression_residual_slot_on_the_train_state():
    cfg = smoke_config("qwen3-8b")
    tr = build_trainer(cfg, device="cpu")
    state = tr.init_state(0, compression=True)
    names = dict(state.params.named_parameters())
    assert set(state.err_feedback) == set(names)
    for n, e in state.err_feedback.items():
        assert e.dtype == torch.float32 and e.shape == names[n].shape
        assert not e.any()
    assert tr.init_state(0).err_feedback is None
    b = next(W.SyntheticLM(cfg, 8, 2, seed=0))
    state, _ = tr.train_step(state, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    # the step carries the slot and does not apply compression, as the
    # reference's step does not
    assert all(not e.any() for e in state.err_feedback.values())


# ---------------------------------------------------------------------------
# GPipe over 'pod' (2 stages)
# ---------------------------------------------------------------------------
def test_gpipe_matches_the_reference_and_the_sequential_stack(ranks,
                                                              pod_mesh):
    jax = _jax()
    jnp = jax.numpy
    from repro.distributed import pipeline as JPP
    a = W.inputs()
    Ws, xs = a["ws"], a["xs"]

    def layer_stack(ws, x):
        def body(xc, w):
            return jnp.tanh(xc @ w), None
        out, _ = jax.lax.scan(body, x, ws)
        return out
    S = pod_mesh.shape["pod"]
    want = np.asarray(JPP.gpipe(layer_stack, pod_mesh, axis="pod")(
        JPP.stage_params(jnp.asarray(Ws), S), jnp.asarray(xs)))
    seq = xs
    for w in Ws:
        seq = np.tanh(seq @ w)
    np.testing.assert_allclose(want, seq, rtol=2e-4, atol=2e-4)
    for r in ranks:
        np.testing.assert_allclose(r["gpipe"], want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["gpipe"], seq, rtol=2e-4, atol=2e-4)


def test_stage_params_and_bubble_fraction():
    staged = PP.stage_params({"w": torch.arange(24.).reshape(8, 3)}, 2)
    assert staged["w"].shape == (2, 4, 3)
    torch.testing.assert_close(staged["w"][1, 0], torch.tensor([12., 13.,
                                                                14.]))
    assert PP.bubble_fraction(8, 2) == pytest.approx(1 / 9)
    assert PP.bubble_fraction(1, 4) == pytest.approx(3 / 4)
