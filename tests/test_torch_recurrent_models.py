"""The port's Mamba2 and RecurrentGemma models against the JAX package's,
from the same weights.

The reference parameter tree goes through numpy into the port
(``weights.params_from_jax``); tokens are drawn from a seed with numpy.
The reference runs its default ``chunked`` path; the port runs
``chunked`` (the plain-torch SSD chunked scan and prefix scan) and
``pallas`` (the scan kernels' entry points, on CPU tensors their plain
sequential versions, and the decode-attention entry point with ring
positions).  float32 throughout: logits at 1e-4, greedy tokens equal.
"""
import numpy as np
import pytest
import torch

# the card's machine has no JAX: there this module, which holds no
# ``gpu`` test, skips as a whole
jax = pytest.importorskip("jax")

import _torch_parity as P
from repro_torch.configs import LOCAL_ATTN, smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.training.data import SyntheticLM
from repro_torch.training.trainer import build_trainer

ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
IMPLS = P.IMPLS


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return (request.param,) + P.ref_params(request.param)


@pytest.mark.parametrize("port_impl", IMPLS)
def test_forward_logits_match(ref, port_impl, monkeypatch):
    """Cache-free logits over 40 tokens: several SSD chunks (16) and,
    for RecurrentGemma, past the local window (32).  Under ``pallas``
    every recurrent layer goes through its scan entry point once."""
    arch, jparams, np_tree = ref
    calls = P.count_calls(monkeypatch, tops, "ssd_scan", "rglru_scan")
    tokens = P.tokens((2, 40), 257, seed=1)
    (want, _), (got, aux) = P.forward_pair(arch, jparams, np_tree,
                                           port_impl, {"tokens": tokens})
    P.close(got, want, "logits")
    assert aux == 0.0
    kinds = P.cfgs(arch, port_impl)[1].pattern_for_layers()
    want_calls = sum(k in ("ssd", "rglru") for k in kinds) \
        if port_impl == "pallas" else 0
    assert len(calls) == want_calls


@pytest.mark.parametrize("port_impl", IMPLS)
def test_ragged_prefill_then_decode_match(ref, port_impl):
    """Prompts of 29 and 17 tokens in chunks of 12: every chunk is ragged
    in one row, then 8 decode steps."""
    arch, jparams, np_tree = ref
    P.check_pairs(P.prefill_then_decode(arch, jparams, np_tree, port_impl,
                                        [29, 17], C=12, steps=8))


@pytest.mark.parametrize("port_impl", IMPLS)
def test_recurrentgemma_decode_past_a_wrapped_ring(port_impl):
    """Local window 32, so the local layers' caches are rings of 32: the
    prefill chunk at 24 writes its pad rows past the ring's end onto
    in-window entries, and 20 decode steps take the 29-token row to 49
    tokens.  Under ``pallas`` the decode kernel's plain version masks by
    the stored positions, as the reference's ``chunked`` path does."""
    arch = "recurrentgemma-2b"
    jparams, np_tree = P.ref_params(arch)
    cache = P.check_pairs(P.prefill_then_decode(arch, jparams, np_tree,
                                                port_impl, [29, 17], C=12,
                                                steps=20))
    tcfg = P.cfgs(arch, port_impl)[1]
    kinds = tcfg.pattern_for_layers()
    ring = [c for c, k in zip(cache, kinds) if k == LOCAL_ATTN][0]
    assert ring["pos"].shape[1] == tcfg.window_size
    assert int(ring["pos"].max()) == 48        # wrapped: position 48 at 16


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slots_gives_a_reassigned_slot_a_fresh_cache(arch):
    """A slot reassigned after ``reset_slots`` gives the logits of a fresh
    cache: its recurrent state, conv windows and KV positions are
    cleared, the other slot's are kept."""
    P.check_reset_slots(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_under_pallas_raises_and_chunked_trains(arch):
    """The scan kernels have no backward kernel: a training step under
    ``pallas`` raises a clear error; under ``chunked`` it runs."""
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticLM(
        smoke_config(arch), 16, 2, seed=0)).items()}
    for impl in IMPLS:
        _, tcfg = P.cfgs(arch, impl)
        tr = build_trainer(tcfg, total_steps=4, warmup_steps=1, device="cpu")
        state = tr.init_state(0)
        if impl == "pallas":
            with pytest.raises(NotImplementedError, match="backward"):
                tr.train_step(state, batch)
        else:
            _, m = tr.train_step(state, batch)
            assert np.isfinite(float(m["loss"]))
