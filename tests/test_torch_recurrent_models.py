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
import dataclasses

import numpy as np
import pytest
import torch

# the card's machine has no JAX: there this module, which holds no
# ``gpu`` test, skips as a whole
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import LOCAL_ATTN, smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.training.data import SyntheticLM
from repro_torch.training.trainer import build_trainer
from repro_torch.weights import params_from_jax

ARCHS = ["mamba2-370m", "recurrentgemma-2b"]
IMPLS = ["chunked", "pallas"]
TOL = 1e-4
MAX_LEN = 64


def _cfgs(arch, port_impl):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               attn_impl="chunked")
    tcfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                               attn_impl=port_impl)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    jcfg, _ = _cfgs(request.param, "chunked")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return request.param, params, jax.tree.map(np.asarray, params)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(
        1, vocab, size=shape, dtype=np.int64).astype(np.int32)


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL, err_msg=what)


@pytest.mark.parametrize("port_impl", IMPLS)
def test_forward_logits_match(ref, port_impl, monkeypatch):
    """Cache-free logits over 40 tokens: several SSD chunks (16) and,
    for RecurrentGemma, past the local window (32).  Under ``pallas``
    every recurrent layer goes through its scan entry point once."""
    arch, jparams, np_tree = ref
    jcfg, tcfg = _cfgs(arch, port_impl)
    tokens = _tokens((2, 40), jcfg.vocab_size, seed=1)
    want = jax_build_model(jcfg).forward(
        jparams, {"tokens": jnp.asarray(tokens)})[0]
    module = params_from_jax(np_tree, tcfg)
    calls = []
    for name in ("ssd_scan", "rglru_scan"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    with torch.no_grad():
        got, aux = build_model(tcfg).forward(
            module, {"tokens": torch.from_numpy(tokens)})
    _close(got.numpy(), want, "logits")
    assert aux.item() == 0.0
    kinds = tcfg.pattern_for_layers()
    want_calls = sum(k in ("ssd", "rglru") for k in kinds) \
        if port_impl == "pallas" else 0
    assert len(calls) == want_calls


def _prefill_then_decode(arch, jparams, np_tree, port_impl, prompts, C,
                         steps):
    """Ragged chunked prefill (C tokens a call; each row's real tokens
    end where its prompt does) and ``steps`` greedy decode steps, through
    both packages' ``Model.prefill`` / ``decode_step``.  Yields (what,
    reference, port) pairs; returns the port's cache at the end."""
    jcfg, tcfg = _cfgs(arch, port_impl)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    module = params_from_jax(np_tree, tcfg)
    B = len(prompts)
    toks = _tokens((B, max(prompts)), jcfg.vocab_size, seed=2)
    jcache, tcache = jm.init_cache(B, MAX_LEN), tm.init_cache(B, MAX_LEN,
                                                               "cpu")
    lengths = np.zeros(B, np.int32)
    prompts = np.asarray(prompts)
    while (lengths < prompts).any():
        n = np.minimum(C, prompts - lengths)
        chunk = np.zeros((B, C), np.int32)
        for r in range(B):
            chunk[r, :n[r]] = toks[r, lengths[r]:lengths[r] + n[r]]
        valid = np.arange(C)[None, :] < n[:, None]
        jl, jcache = jm.prefill(jparams, jnp.asarray(chunk), jcache,
                                jnp.asarray(lengths),
                                valid=jnp.asarray(valid))
        with torch.no_grad():
            tl, tcache = tm.prefill(module, torch.from_numpy(chunk), tcache,
                                    torch.from_numpy(lengths),
                                    valid=torch.from_numpy(valid))
        rows = n > 0
        last = np.maximum(n - 1, 0)
        yield (f"prefill at {lengths.tolist()}",
               np.asarray(jl)[np.arange(B), last][rows],
               tl.numpy()[np.arange(B), last][rows])
        lengths = lengths + n
    nxt = np.asarray(jl)[np.arange(B), last].argmax(-1).astype(np.int32)
    active = np.ones((B, 1), bool)
    for i in range(steps):
        jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt)[:, None],
                                    jcache, jnp.asarray(lengths),
                                    valid=jnp.asarray(active))
        with torch.no_grad():
            tl, tcache = tm.decode_step(module, torch.from_numpy(nxt)[:, None],
                                        tcache, torch.from_numpy(lengths),
                                        valid=torch.from_numpy(active))
        jl, tl = np.asarray(jl)[:, -1], tl.numpy()[:, -1]
        yield f"decode {i}", jl, tl
        yield f"decode {i} tokens", jl.argmax(-1), tl.argmax(-1)
        nxt = jl.argmax(-1).astype(np.int32)
        lengths = lengths + 1
    return tcache


def _check_pairs(gen):
    while True:
        try:
            what, want, got = next(gen)
        except StopIteration as stop:
            return stop.value
        if "tokens" in what:
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            _close(got, want, what)


@pytest.mark.parametrize("port_impl", IMPLS)
def test_ragged_prefill_then_decode_match(ref, port_impl):
    """Prompts of 29 and 17 tokens in chunks of 12: every chunk is ragged
    in one row, then 8 decode steps."""
    arch, jparams, np_tree = ref
    _check_pairs(_prefill_then_decode(arch, jparams, np_tree, port_impl,
                                      [29, 17], C=12, steps=8))


@pytest.mark.parametrize("port_impl", IMPLS)
def test_recurrentgemma_decode_past_a_wrapped_ring(port_impl):
    """Local window 32, so the local layers' caches are rings of 32: the
    prefill chunk at 24 writes its pad rows past the ring's end onto
    in-window entries, and 20 decode steps take the 29-token row to 49
    tokens.  Under ``pallas`` the decode kernel's plain version masks by
    the stored positions, as the reference's ``chunked`` path does."""
    arch = "recurrentgemma-2b"
    jcfg, tcfg = _cfgs(arch, port_impl)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    cache = _check_pairs(_prefill_then_decode(arch, jparams, np_tree,
                                              port_impl, [29, 17], C=12,
                                              steps=20))
    kinds = tcfg.pattern_for_layers()
    ring = [c for c, k in zip(cache, kinds) if k == LOCAL_ATTN][0]
    assert ring["pos"].shape[1] == tcfg.window_size
    assert int(ring["pos"].max()) == 48        # wrapped: position 48 at 16


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_slots_gives_a_reassigned_slot_a_fresh_cache(arch):
    """A slot reassigned after ``reset_slots`` gives the logits of a fresh
    cache: its recurrent state, conv windows and KV positions are
    cleared, the other slot's are kept."""
    _, tcfg = _cfgs(arch, "pallas")
    fns = build_serve_fns(tcfg, batch=2, max_len=MAX_LEN, device="cpu")
    module = fns.init_params(0)
    C = 16
    old = torch.from_numpy(_tokens((2, C), tcfg.vocab_size, seed=3))
    new = torch.from_numpy(_tokens((2, C), tcfg.vocab_size, seed=4))
    zero = torch.zeros(2, dtype=torch.int32)
    only0 = torch.tensor([C, 0], dtype=torch.int32)
    cache = fns.init_cache()
    _, _, cache = fns.prefill_chunk(module, cache, old, zero,
                                    torch.full((2,), C, dtype=torch.int32))
    kept = [{k: t[1].clone() for k, t in layer.items()} for layer in cache]
    cache = fns.reset_slots(cache, torch.tensor([False, True]))
    for layer, k1 in zip(cache, kept):
        for name, t in layer.items():
            assert torch.equal(t[1], k1[name]), name
            if name == "pos":
                assert torch.all(t[0] == -1)
            elif name in ("state", "h") or name.startswith("conv"):
                assert torch.all(t[0] == 0), name
    _, got, _ = fns.prefill_chunk(module, cache, new, zero, only0)
    _, want, _ = fns.prefill_chunk(module, fns.init_cache(), new, zero, only0)
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_under_pallas_raises_and_chunked_trains(arch):
    """The scan kernels have no backward kernel: a training step under
    ``pallas`` raises a clear error; under ``chunked`` it runs."""
    batch = {k: torch.from_numpy(v) for k, v in next(SyntheticLM(
        smoke_config(arch), 16, 2, seed=0)).items()}
    for impl in IMPLS:
        _, tcfg = _cfgs(arch, impl)
        tr = build_trainer(tcfg, total_steps=4, warmup_steps=1, device="cpu")
        state = tr.init_state(0)
        if impl == "pallas":
            with pytest.raises(NotImplementedError, match="backward"):
                tr.train_step(state, batch)
        else:
            _, m = tr.train_step(state, batch)
            assert np.isfinite(float(m["loss"]))
