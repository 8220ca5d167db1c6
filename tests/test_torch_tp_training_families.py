"""Training's tensor-parallel compute for MLA, the SSD and RG-LRU mixers
and the encoder-decoder against the port's own one-device training.

One group of 4 gloo ranks on the CPU (``tests/_torch_dist_worker.py``
``tp_families``) trains the smoke configs of DeepSeek-V2-Lite (MLA on
its heads: ``wq``, ``w_uk``, ``w_uv`` column-parallel, ``wo``
row-parallel; ``w_dkv`` and ``kv_norm`` whole, their gradients summed
over ``model``), Mamba2-370M (the SSD on its heads; ``w_B`` / ``w_C``
and their convs whole; the gated norm's sum of squares all-reduced over
``model``), RecurrentGemma-2B (the RG-LRU on its channels; the local
attention's single kv head gathered) and Whisper-large-v3 (the encoder's
and decoder's attention, cross-attention and MLPs on their heads, with
seeded random frames) for 3 steps on meshes (data, model) = (2, 2) and
(1, 4), each with and without ``seq_parallel`` (the encoder-decoder's
residual stays whole under it).  Losses and grad norms are held at 1e-5
relative to the one-device port, every parameter at 1e-5 absolute, and
the first batch's gradients at 1e-5 of each tensor's largest.  Each
rank's compute module must hold only its ``model`` slice of every weight
the blocks compute tensor-parallel.  A gated norm that normalises each
rank's channels alone must fail the comparison.  The one-device port is
held to the JAX package by ``tests/test_torch_{moe_mla,recurrent_models,
whisper}.py``.
"""
import json

import numpy as np
import pytest

import _torch_dist
import _torch_dist_worker as W
from repro_torch.distributed import sharding as SH
from repro_torch.training.trainer import build_trainer

IDS = [f"{n}-{s[0]}x{s[1]}-{'seq' if sp else 'noseq'}"
       for n, s, sp in W.TP_FAMILY_RUNS]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_families")
    _torch_dist.spawn(4, "tp_families", out)
    return out


@pytest.mark.parametrize("name,shape,sp", W.TP_FAMILY_RUNS, ids=IDS)
def test_tp_steps_equal_the_one_device_port(tp_runs, name, shape, sp):
    got = np.load(tp_runs / f"{W.tp_tag(name, shape, sp)}.npz")
    losses, norms, params = W.one_device_run(name)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["norms"], norms, rtol=1e-5)
    for n, p in params.items():
        np.testing.assert_allclose(got[f"leaf:params.{n}"], p, atol=1e-5,
                                   rtol=0, err_msg=n)
    assert int(got["leaf:step"]) == W.STEPS


@pytest.mark.parametrize("name,shape,sp", W.TP_FAMILY_RUNS, ids=IDS)
def test_tp_gradients_equal_the_one_device_port(tp_runs, name, shape, sp):
    """The first batch's gradients, summed over the ranks and gathered,
    within 1e-5 of each tensor's largest one-device gradient."""
    got = np.load(tp_runs / f"{W.tp_tag(name, shape, sp)}.npz")
    for n, g in W.one_device_grads(name).items():
        np.testing.assert_allclose(got[f"grad:{n}"], g, rtol=0,
                                   atol=1e-5 * np.abs(g).max(), err_msg=n)


@pytest.mark.parametrize("name,shape,sp", W.TP_FAMILY_RUNS, ids=IDS)
def test_the_compute_module_holds_model_slices(tp_runs, name, shape, sp):
    """Every rank's compute weights: a weight the blocks compute
    tensor-parallel is its ``model`` slice (the train rules' spec with
    the FSDP axes dropped), every other one whole; each family slices
    its mixer."""
    with open(tp_runs / f"{W.tp_tag(name, shape, sp)}.shapes.json") as f:
        ranks = json.load(f)
    cfg = W.train_cfg(name)
    sizes = {"data": shape[0], "model": shape[1]}
    full = build_trainer(cfg, device="cpu").init_state(0).params
    specs = SH.param_pspecs(cfg, full, sizes, "train")
    mixers = set()
    for shapes in ranks:
        assert set(shapes) == {n for n, _ in full.named_parameters()}
        for n, p in full.named_parameters():
            want = tuple(p.shape)
            if W.TP_WEIGHTS.search(n):
                only = tuple(e if e == "model" else None for e in specs[n])
                want = SH.local_shape(p.shape, only, sizes)
            if want != tuple(p.shape) and (".mixer." in n or ".cross." in n):
                mixers.add(n.rsplit(".", 1)[-1])
            assert tuple(shapes[n]) == want, (n, shapes[n], want)
    assert mixers >= {"deepseek": {"wq", "w_uk", "w_uv", "wo"},
                      "mamba2": {"w_z", "w_x", "w_dt", "out_proj",
                                 "gate_norm"},
                      "rgemma": {"w_gate", "w_x", "conv_w", "w_out"},
                      "whisper": {"wq", "wk", "wv", "wo"}}[name], mixers


def test_a_gate_norm_on_its_slice_alone_fails(tp_runs):
    """The (1, 4) Mamba2 run again, with each rank's gated norm
    normalising its own channels alone: it leaves the one-device port
    from the first loss on, while the right run agrees."""
    name, shape, sp = W.GATE_NORM_WRONG
    right = np.load(tp_runs / f"{W.tp_tag(name, shape, sp)}.npz")
    wrong = np.load(tp_runs / f"{W.tp_tag(name, shape, sp, wrong=True)}"
                    ".npz")
    assert W.agrees(right, name)
    assert not W.agrees(wrong, name)
    losses, _, _ = W.one_device_run(name)
    assert abs(wrong["losses"][0] - losses[0]) > 1e-5 * abs(losses[0])
