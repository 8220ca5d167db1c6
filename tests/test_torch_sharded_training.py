"""Sharded training against the port's own unsharded training.

One group of 4 gloo ranks on the CPU (``tests/_torch_dist_worker.py``
``training``) trains the Qwen3, DeepSeek-V2-Lite (MoE: experts sharded
over ``model``) and Mamba2 smoke configs for 3 steps under ``chunked`` on
meshes (data 2, model 2) and (4, 1), with AdamW (and Adafactor, and
gradient accumulation 2, for Qwen3 on (2, 2)); here the unsharded port
trains the same configs from the same seed on the same batches.  Losses
and grad norms are held at 1e-5 relative, every parameter at 1e-5
absolute: the sums over the batch and the vocabulary run in another
order.  A checkpoint saved on (2, 2) reloads bit for bit on (4, 1), on
(1, 4), with every sharded leaf's axes swapped, and unsharded.  The JAX
package's own sharded legs fail on jax 0.9, so they are no oracle here.
None of this needs JAX.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_dist
import _torch_dist_worker as W
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as train_cli
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.trainer import build_trainer

RUNS = [(n, s, 1) for n in W.ARCHS for s in W.MESHES[n]] + [W.ACCUM_CASE]
IDS = [f"{n}-{s[0]}x{s[1]}-accum{a}" for n, s, a in RUNS]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded")
    _torch_dist.spawn(4, "training", out)
    return out


def _unsharded(name, accum=1):
    cfg = W.train_cfg(name)
    tr = build_trainer(cfg, grad_accum=accum, **W.TRAIN_KW)
    state = tr.init_state(0)
    losses, norms = [], []
    for b in W.batches(cfg):
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


def _tag(name, shape, accum):
    return f"{name}_{shape[0]}x{shape[1]}_a{accum}"


@pytest.mark.parametrize("name,shape,accum", RUNS, ids=IDS)
def test_sharded_steps_equal_the_unsharded_port(sharded, name, shape, accum):
    got = np.load(sharded / f"{_tag(name, shape, accum)}.npz")
    losses, norms, state = _unsharded(name, accum)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5)
    params = state.named_params()
    for n, p in params.items():
        np.testing.assert_allclose(got[f"leaf:params.{n}"],
                                   p.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=n)
    assert int(got["leaf:step"]) == int(state.step) == W.STEPS


@pytest.mark.parametrize("name,shape,accum", RUNS[:len(RUNS) - 1],
                         ids=IDS[:len(RUNS) - 1])
def test_the_state_is_placed_by_the_train_rules(sharded, name, shape, accum):
    with open(sharded / f"{_tag(name, shape, accum)}.placements.json") as f:
        got = json.load(f)
    cfg = W.train_cfg(name)
    sizes = {"data": shape[0], "model": shape[1]}
    module = build_trainer(cfg, device="cpu").init_state(0).params
    want = SH.param_placements(cfg, module, sizes, "train")
    for n, pls in want.items():
        assert got[f"params.{n}"] == [repr(p) for p in pls], n
        slot = "opt_state.slots" if cfg.optimizer == "adafactor" \
            else "opt_state.m"
        assert any(k.startswith(f"{slot}.{n}") for k in got), n
    sharded_leaves = [k for k, v in got.items() if "Shard" in "".join(v)]
    assert any(k.startswith("params.") for k in sharded_leaves)
    assert any(k.startswith("opt_state.") for k in sharded_leaves)
    if name == "deepseek":       # the experts go over 'model'
        w = got["params.layers.1.moe.w_gate"]
        assert w[list(sizes).index("model")] == "Shard(dim=0)" \
            or shape[1] == 1


@pytest.mark.parametrize("target", ["4x1", "1x4", "2x2_swapped"])
def test_checkpoint_saved_on_2x2_reloads_bit_for_bit(sharded, target):
    with open(sharded / "ckpt_report.json") as f:
        rep = json.load(f)[target]
    assert rep["extra"] == {"step": 4}
    assert rep["unequal"] == []
    assert bool(rep["swapped"]) == target.endswith("swapped")


@pytest.mark.parametrize("step", [3, 4])
def test_checkpoint_saved_on_2x2_reloads_unsharded(sharded, step):
    """The sync save (step 3) and the async one (step 4) of the same
    state load into a one-device state bit for bit."""
    want = np.load(sharded / f"{_tag('qwen3', (2, 2), 1)}.npz")
    tr = build_trainer(W.train_cfg("qwen3"), **W.TRAIN_KW)
    state, extra = CKPT.load(str(sharded / "ckpt"), tr.init_state(7), step)
    assert extra == {"step": step}
    leaves = CKPT.state_leaves(state)
    assert {f"leaf:{k}" for k in leaves} == set(want.files) - {"losses",
                                                                "norms"}
    for k, t in leaves.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[f"leaf:{k}"],
                                      err_msg=k)


def test_checkpoint_writes_each_shard_once(sharded):
    d = sharded / "ckpt" / "step_00000004"
    with open(d / "index.json") as f:
        leaves = json.load(f)["leaves"]
    wq = leaves["params.layers.0.mixer.wq"]        # (data, model) sharded
    assert len(wq["shards"]) == 4
    cover = np.zeros(wq["shape"], int)
    for sh in wq["shards"]:
        (a, b), (c, e) = sh["index"]
        cover[a:b, c:e] += 1
        assert (d / sh["file"]).exists()
        assert np.load(d / sh["file"]).shape == (b - a, e - c)
    assert (cover == 1).all()
    assert len(leaves["params.embed"]["shards"]) == 1      # replicated
    assert len(leaves["step"]["shards"]) == 1
    names = sorted(os.listdir(sharded / "ckpt"))
    assert names == ["LATEST", "step_00000003", "step_00000004"]


def _losses(text: str):
    return [float(m) for m in re.findall(r"loss (\d+\.\d+)", text)]


def test_torchrun_mesh_2x2_trains_like_one_device(tmp_path, capsys):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke
    --mesh 2x2 --device cpu`` with a checkpoint: rank 0 logs the same
    losses as the one-device CLI (to the printed digits but the last),
    and the checkpoint commits."""
    args = ["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq-len", "16", "--global-batch", "4", "--log-every", "1"]
    ck = str(tmp_path / "ck")
    env = _torch_dist.rank_env(0, 1, _torch_dist.free_port())
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k)
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-port", str(_torch_dist.free_port()), "-m",
         "repro_torch.launch.train", *args, "--mesh", "2x2",
         "--ckpt-dir", ck, "--ckpt-every", "2"],
        env=env, cwd=_torch_dist.ROOT, capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    got = _losses(run.stdout)
    assert len(got) == 3 and run.stdout.count("step ") == 3
    assert train_cli.main(args) == 0
    want = _losses(capsys.readouterr().out)
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert CKPT.latest_step(ck) == 3
    assert sorted(os.listdir(ck)) == ["LATEST", "step_00000002",
                                      "step_00000003"]


@pytest.fixture
def world_of_one():
    """A gloo group of one in this process, torn down after the test."""
    MESH.init_distributed("cpu")
    yield
    dist.destroy_process_group()


def test_a_mesh_of_one_trains_bit_for_bit_like_one_device(world_of_one):
    mesh = MESH.make_mesh((1, 1), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        MESH.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="axes"):
        MESH.make_mesh((1, 1), ("data", "rows"), "cpu")
    cfg = W.train_cfg("deepseek")
    tr = build_trainer(cfg, mesh, **W.TRAIN_KW)
    state = tr.init_state(0, compression=True)
    losses = []
    for b in W.batches(cfg):
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
    want, _, ref = _unsharded("deepseek")
    assert losses == want
    for n, p in ref.named_params().items():
        assert torch.equal(state.params[n].to_local(), p), n
    assert set(state.err_feedback) == set(state.params)


def test_build_trainer_refuses_what_is_not_a_device_mesh():
    cfg = W.train_cfg("qwen3")
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_trainer(cfg, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_trainer(cfg, mesh={"data": 2}, device="cpu")


def test_a_cuda_mesh_needs_a_card_a_rank(monkeypatch):
    """Without a card a CUDA mesh raises; with fewer cards on this host
    than ranks it raises too (NCCL takes one card a rank), before any
    process group starts."""
    monkeypatch.setenv("WORLD_SIZE", str(torch.cuda.device_count() + 1))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(torch.cuda.device_count() + 1))
    match = "ranks on this host" if torch.cuda.is_available() \
        else "no CUDA device"
    with pytest.raises(RuntimeError, match=match):
        MESH.make_mesh((1, torch.cuda.device_count() + 1),
                       ("data", "model"), "cuda")
    assert not dist.is_initialized()


@pytest.mark.gpu
def test_a_nccl_mesh_of_one_trains_like_one_device_on_card():
    """NCCL at world 1 on the card, the flash kernels under the sharded
    state: the same losses and parameters as the one-device trainer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    cfg = dataclasses.replace(W.train_cfg("qwen3"), attn_impl="pallas")
    kw = dict(W.TRAIN_KW, device="cuda")
    MESH.init_distributed("cuda")
    try:
        mesh = MESH.make_mesh((1, 1), ("data", "model"), "cuda")
        outs = []
        for m in (mesh, None):
            tr = build_trainer(cfg, m, **kw)
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
