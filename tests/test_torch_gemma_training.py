"""Gemma-7B trained by the port against the JAX trainer, on the CPU.

Gemma-7B's smoke config with its published head dim, 256, on both sides:
MHA (4 on 4 heads), GeGLU, tied embeddings scaled by sqrt(d_model), the
default AdamW.  The port starts from the reference's own initial state
(``weights.train_state_from_reference``) and takes 3 steps under
``chunked`` and under ``pallas`` (on CPU tensors the flash pair's plain
versions, which the card's kernels are held to: at head dim 256 the bf16
backward is ``flash_bwd_sm90_wide``); the reference takes them under
``chunked``, since its Pallas forward has no gradient.  Tolerances are
``tests/test_torch_training.py``'s: losses 1e-5 relative, grad norms 1e-4
relative, parameters 2e-5 absolute (sums in another order, float32).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import smoke_config as jax_smoke_config
from repro.training import data as jdata
from repro.training.trainer import build_trainer as jax_build_trainer
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.training.trainer import build_trainer
from repro_torch.weights import named_arrays, train_state_from_reference

ARCH = "gemma-7b"
HEAD_DIM = 256
SEQ, BATCH, STEPS = 32, 4, 3
TRAIN_KW = dict(total_steps=10, warmup_steps=2)


def _cfg(smoke, impl):
    return dataclasses.replace(smoke(ARCH), head_dim=HEAD_DIM,
                               dtype="float32", attn_impl=impl)


def _batches(cfg, n):
    src = jdata.SyntheticLM(cfg, SEQ, BATCH, seed=0)
    return [next(src) for _ in range(n)]


def test_smoke_config_keeps_gemmas_shape():
    cfg = _cfg(smoke_config, "pallas")
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (4, 4, 256)
    assert cfg.mlp_act == "gelu" and cfg.tie_embeddings
    assert cfg.scale_embeddings and cfg.optimizer == "adamw"


@pytest.fixture(scope="module")
def reference_run():
    """The JAX trainer's initial state, its 3 steps' losses and grad norms
    and its parameters after them."""
    jcfg = _cfg(jax_smoke_config, "chunked")
    tr = jax_build_trainer(jcfg, donate=False, **TRAIN_KW)
    state = tr.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    losses, norms = [], []
    for b in _batches(jcfg, STEPS):
        state, m = tr.train_step(state, {k: jnp.asarray(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return init, losses, norms, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("port_impl", ["chunked", "pallas"])
def test_gemma_train_steps_match_the_jax_trainer(reference_run, port_impl,
                                                 monkeypatch):
    init, jlosses, jnorms, jparams = reference_run
    tcfg = _cfg(smoke_config, port_impl)
    calls = {"bwd": 0}
    real_bwd = tref.flash_attention_bwd_ref

    def counted(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)
    monkeypatch.setattr(tref, "flash_attention_bwd_ref", counted)
    tr = build_trainer(tcfg, device="cpu", **TRAIN_KW)
    state = train_state_from_reference(init.params, init.opt_state,
                                       init.step, tcfg)
    before = dict(tops.LAUNCHES)
    losses, norms = [], []
    for b in _batches(tcfg, STEPS):
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    assert tops.LAUNCHES == before          # CPU tensors: no kernel
    # pallas: the flash backward's plain version once a layer a step
    want = tcfg.num_layers * STEPS if port_impl == "pallas" else 0
    assert calls["bwd"] == want
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-4)
    assert int(state.step) == STEPS
    want_params = named_arrays(jparams, tcfg)
    got = state.named_params()
    assert set(got) == set(want_params)
    for k, w in want_params.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w, atol=2e-5,
                                   rtol=0, err_msg=k)
