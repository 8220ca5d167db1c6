"""Training's tensor-parallel compute and ``seq_parallel`` against the
port's own one-device training.

One group of 4 gloo ranks on the CPU (``tests/_torch_dist_worker.py``
``tp``) trains each ``TP_RUNS`` case for 3 steps: the Qwen3 smoke config
on meshes (data, model) = (1, 4) and (2, 2), with 2 kv heads on (1, 4)
(they do not divide over ``model``: each rank gathers the k/v columns and
keeps the head of its query head), with Adafactor and
``scan_layers=False`` on (2, 2); DeepSeek-V2-Lite (the routed experts
split over ``model``, MLA on its heads) and Mamba2 (the SSD on its
heads) on (2, 2); each
with and without ``seq_parallel``; and under ``pallas`` on (1, 4) (the
flash ``autograd.Function`` on one local head a rank; its plain versions
on the CPU).  Here the one-device port trains the same configs from the
same seed on the same batches.  Losses and grad norms are held at 1e-5
relative, every parameter at 1e-5 absolute, and the first batch's
gradients at 1e-5 of each tensor's largest.  Each rank's compute module
must hold only its ``model`` slice of every weight the blocks compute
tensor-parallel, and a gradient rule that sums the norms' gradients
(complete on every model rank) over ``model`` too must fail the
comparison.  The one-device port is held to
the JAX package by ``tests/test_torch_training.py``; the reference's own
sharded legs fail on jax 0.9, so they are no oracle here.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist
import _torch_dist_worker as W
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.training.trainer import build_trainer

IDS = [f"{n}-{s[0]}x{s[1]}-{'seq' if sp else 'noseq'}"
       for n, s, sp in W.TP_RUNS]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    _torch_dist.spawn(4, "tp", out)
    return out


@pytest.mark.parametrize("name,shape,sp", W.TP_RUNS, ids=IDS)
def test_tp_steps_equal_the_one_device_port(tp_runs, name, shape, sp):
    got = np.load(tp_runs / f"{W.tp_tag(name, shape, sp)}.npz")
    losses, norms, params = W.one_device_run(name)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(got[f"leaf:params.{n}"], p, atol=1e-5,
                                   rtol=0, err_msg=n)
    assert int(got["leaf:step"]) == W.STEPS


@pytest.mark.parametrize("name,shape,sp", W.TP_RUNS, ids=IDS)
def test_tp_gradients_equal_the_one_device_port(tp_runs, name, shape, sp):
    """The first batch's gradients, summed over the ranks and gathered,
    within 1e-5 of each tensor's largest one-device gradient (AdamW's
    update of a gradient near its eps, 1e-8, magnifies rounding; the
    gradients do not)."""
    got = np.load(tp_runs / f"{W.tp_tag(name, shape, sp)}.npz")
    for n, g in W.one_device_grads(name).items():
        np.testing.assert_allclose(got[f"grad:{n}"], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=n)


@pytest.mark.parametrize("name,shape,sp", W.TP_RUNS, ids=IDS)
def test_the_compute_module_holds_model_slices(tp_runs, name, shape, sp):
    """Every rank's compute weights: a weight the blocks compute
    tensor-parallel is its ``model`` slice (the train rules' spec with
    the FSDP axes dropped), every other one whole."""
    with open(tp_runs / f"{W.tp_tag(name, shape, sp)}.shapes.json") as f:
        ranks = json.load(f)
    cfg = W.train_cfg(name)
    sizes = {"data": shape[0], "model": shape[1]}
    full = build_trainer(cfg, device="cpu").init_state(0).params
    specs = SH.param_pspecs(cfg, full, sizes, "train")
    sliced = 0
    for shapes in ranks:
        assert set(shapes) == {n for n, _ in full.named_parameters()}
        for n, p in full.named_parameters():
            want = tuple(p.shape)
            if W.TP_WEIGHTS.search(n):
                only = tuple(e if e == "model" else None for e in specs[n])
                want = SH.local_shape(p.shape, only, sizes)
            sliced += want != tuple(p.shape)
            assert tuple(shapes[n]) == want, (n, shapes[n], want)
    assert sliced > 0


def test_counting_a_replicated_gradient_model_times_fails(tp_runs):
    """The same run as the (1, 4) one without ``seq_parallel``, but the
    norms' gradients, the same full gradient on every model rank, are
    summed over ``model``: the first loss still agrees, the grad norms
    and the parameters do not, and the norms' gradients are ``model``
    times the one-device ones."""
    name, shape, sp = W.TP_WRONG
    right = np.load(tp_runs / f"{W.tp_tag(name, shape, sp)}.npz")
    wrong = np.load(tp_runs / f"{W.tp_tag(name, shape, sp, wrong=True)}"
                    ".npz")
    assert W.agrees(right, name)
    assert not W.agrees(wrong, name)
    losses, norms, _ = W.one_device_run(name)
    assert abs(wrong["losses"][0] - losses[0]) <= 1e-5 * abs(losses[0])
    assert not np.allclose(wrong["norms"][0], norms[0], rtol=1e-5, atol=0)
    g = W.one_device_grads(name)["layers.0.norm1"]
    np.testing.assert_allclose(wrong["grad:layers.0.norm1"], shape[1] * g,
                               rtol=1e-4, atol=1e-5 * np.abs(g).max())


@pytest.fixture
def world_of_one():
    """A gloo group of one in this process, torn down after the test."""
    MESH.init_distributed("cpu")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["qwen3", "deepseek"])
def test_seq_parallel_on_a_mesh_of_one_is_bit_for_bit_one_device(
        world_of_one, name):
    """``model`` 1 computes nothing tensor-parallel and ``seq_parallel``
    is a no-op: the same losses and parameters as the one-device
    trainer, bit for bit; without a mesh too."""
    mesh = MESH.make_mesh((1, 1), ("data", "model"), "cpu")
    cfg = W.train_cfg(name)
    want_losses, _, want = W.one_device_run(name)
    for m in (mesh, None):
        tr = build_trainer(cfg, m, seq_parallel=True, **W.TRAIN_KW)
        state = tr.init_state(0)
        losses = []
        for b in W.batches(cfg):
            state, met = tr.train_step(state, {k: torch.from_numpy(v)
                                               for k, v in b.items()})
            losses.append(float(met["loss"]))
        assert losses == want_losses
        for n, p in state.named_params().items():
            got = p.to_local() if m is not None else p
            assert np.array_equal(got.detach().numpy(), want[n]), n


@pytest.mark.gpu
def test_a_nccl_mesh_of_one_trains_tp_with_seq_parallel_on_card():
    """Phase 27 (a)'s plumbing at smoke width: NCCL at world 1 on the
    card, ``seq_parallel=True``, the flash kernels: the same losses and
    parameters as the one-device trainer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(W.train_cfg("qwen3"), attn_impl="pallas")
    kw = dict(W.TRAIN_KW, device="cuda")
    MESH.init_distributed("cuda")
    try:
        mesh = MESH.make_mesh((1, 1), ("data", "model"), "cuda")
        outs = []
        for m in (mesh, None):
            tr = build_trainer(cfg, m, seq_parallel=m is not None, **kw)
            state = tr.init_state(0)
            losses = []
            for b in W.batches(cfg):
                state, met = tr.train_step(
                    state, {k: torch.from_numpy(v).cuda()
                            for k, v in b.items()})
                losses.append(float(met["loss"]))
            outs.append((losses, {n: (p.to_local() if m is not None else p)
                                  .detach().cpu()
                                  for n, p in state.named_params().items()}))
        (l1, p1), (l2, p2) = outs
        np.testing.assert_allclose(l1, l2, rtol=1e-5)
        for n in p2:
            torch.testing.assert_close(p1[n], p2[n], atol=1e-5, rtol=0)
    finally:
        dist.destroy_process_group()
