"""The port's Qwen3 model against the JAX package's, from the same weights.

The reference parameter tree goes through numpy into the port
(``weights.params_from_jax``); inputs are drawn from a seed with numpy.
The reference runs its default attention path (``attn_impl="chunked"``);
the port's decode runs ``"pallas"``, which on CPU tensors is the decode
kernel's plain version.  float32: logits at 1e-4, greedy tokens equal.
bfloat16: logits at 2e-2, the kernels' bf16 tolerance — the two
frameworks round to bf16 at different points (XLA fuses elementwise
chains, torch rounds after each op), so only the float32 leg holds the
algorithm tightly.
"""
import dataclasses

import numpy as np
import pytest
import torch

# the card's machine has no JAX: there these modules, which hold no
# ``gpu`` test, skip as a whole
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.configs import smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.serving.serve_step import build_serve_fns as jax_build_serve_fns
from repro_torch.configs import smoke_config
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.weights import params_from_jax

B, C, MAX_LEN = 4, 8, 32
VALID_N = np.array([8, 5, 0, 3], np.int32)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cfgs(dtype, port_impl="pallas"):
    # 8 query heads on the smoke config's 4 KV heads: GQA with G = 2
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-8b"), dtype=dtype,
                               num_heads=8, attn_impl="chunked")
    tcfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype=dtype,
                               num_heads=8, attn_impl=port_impl)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs("float32")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _np(x):
    return np.asarray(x, np.float32)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(1, vocab, size=shape,
                                                dtype=np.int64).astype(
                                                    np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match(ref_params, dtype):
    jparams, np_tree = ref_params
    jcfg, tcfg = _cfgs(dtype, port_impl="chunked")
    tokens = _tokens((2, 24), jcfg.vocab_size, seed=1)
    want = jax_build_model(jcfg).forward(jparams, {"tokens": jnp.asarray(
        tokens)})[0]
    module = params_from_jax(np_tree, tcfg)
    got, aux = build_model(tcfg).forward(module, {"tokens": torch.from_numpy(
        tokens)})
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), _np(want), atol=tol, rtol=tol)
    assert aux.item() == 0.0          # dense decoder: no MoE aux loss


def test_pallas_forward_without_cache_needs_flash_kernel(ref_params):
    """The cache-free forward under ``pallas`` goes through the flash
    attention entry point (its plain version on CPU tensors) and gives
    the reference's logits."""
    from repro_torch.kernels import ops as tops
    jparams, np_tree = ref_params
    jcfg, tcfg = _cfgs("float32", port_impl="pallas")
    tokens = _tokens((2, 24), jcfg.vocab_size, seed=5)
    want = jax_build_model(jcfg).forward(jparams, {"tokens": jnp.asarray(
        tokens)})[0]
    module = params_from_jax(np_tree, tcfg)
    calls = []
    real = tops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    tops.flash_attention = spy
    try:
        got, _ = build_model(tcfg).forward(module, {"tokens": torch.from_numpy(
            tokens)})
    finally:
        tops.flash_attention = real
    assert len(calls) == tcfg.num_layers
    np.testing.assert_allclose(got.numpy(), _np(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


def _prefill_then_decode(jcfg, tcfg, jparams, np_tree, steps=3):
    """One ragged prefill chunk and ``steps`` decode steps through both
    packages; yields (what, reference, port) pairs of logits/tokens."""
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    jfns = jax_build_serve_fns(jcfg, batch=B, max_len=MAX_LEN,
                               prefill_chunk=C, donate=False)
    tfns = build_serve_fns(tcfg, batch=B, max_len=MAX_LEN, device="cpu")
    module = params_from_jax(np_tree, tcfg)
    tokens = _tokens((B, C), jcfg.vocab_size, seed=2)
    lengths = np.zeros(B, np.int32)
    jcache, tcache = jfns.init_cache(), tfns.init_cache()
    jn, jlast, jcache = jfns.prefill_chunk(
        jparams, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(VALID_N))
    tn, tlast, tcache = tfns.prefill_chunk(
        module, tcache, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(VALID_N))
    yield "prefill logits", _np(jlast)[VALID_N > 0], tlast.numpy()[VALID_N > 0]
    yield "prefill tokens", np.asarray(jn)[VALID_N > 0], \
        tn.numpy()[VALID_N > 0]
    active = VALID_N > 0
    lengths = VALID_N.copy()
    nxt = np.array(jn)
    for i in range(steps):
        jl, jcache = jm.decode_step(jparams, jnp.asarray(nxt)[:, None], jcache,
                                    jnp.asarray(lengths),
                                    valid=jnp.asarray(active)[:, None])
        tl, tcache = tm.decode_step(module, torch.from_numpy(nxt)[:, None],
                                    tcache, torch.from_numpy(lengths),
                                    valid=torch.from_numpy(active)[:, None])
        jl, tl = _np(jl)[:, -1], tl.numpy()[:, -1]
        yield f"decode {i} logits", jl[active], tl[active]
        yield f"decode {i} tokens", jl[active].argmax(-1), tl[active].argmax(-1)
        nxt = jl.argmax(-1).astype(np.int32)
        lengths = lengths + active


@pytest.mark.parametrize("port_impl", ["pallas", "naive"])
def test_prefill_and_decode_match_float32(ref_params, port_impl):
    jparams, np_tree = ref_params
    jcfg, tcfg = _cfgs("float32", port_impl)
    for what, want, got in _prefill_then_decode(jcfg, tcfg, jparams, np_tree):
        if "tokens" in what:
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            np.testing.assert_allclose(got, want, atol=TOL["float32"],
                                       rtol=TOL["float32"], err_msg=what)


def test_prefill_and_decode_match_bfloat16(ref_params):
    jparams, np_tree = ref_params
    jcfg, tcfg = _cfgs("bfloat16")
    for what, want, got in _prefill_then_decode(jcfg, tcfg, jparams, np_tree):
        if "logits" in what:
            np.testing.assert_allclose(got, want, atol=TOL["bfloat16"],
                                       rtol=TOL["bfloat16"], err_msg=what)


def test_serve_decode_tokens_match(ref_params):
    """The serve-step ``decode`` (sampling included) gives the reference's
    greedy tokens; inactive slots are carried without effect."""
    jparams, np_tree = ref_params
    jcfg, tcfg = _cfgs("float32")
    jfns = jax_build_serve_fns(jcfg, batch=B, max_len=MAX_LEN,
                               prefill_chunk=C, donate=False)
    tfns = build_serve_fns(tcfg, batch=B, max_len=MAX_LEN, device="cpu")
    module = params_from_jax(np_tree, tcfg)
    tokens = _tokens((B, C), jcfg.vocab_size, seed=3)
    lengths = np.zeros(B, np.int32)
    jcache, tcache = jfns.init_cache(), tfns.init_cache()
    jn, _, jcache = jfns.prefill_chunk(jparams, jcache, jnp.asarray(tokens),
                                       jnp.asarray(lengths),
                                       jnp.asarray(VALID_N))
    tn, _, tcache = tfns.prefill_chunk(module, tcache,
                                       torch.from_numpy(tokens),
                                       torch.from_numpy(lengths),
                                       torch.from_numpy(VALID_N))
    active = VALID_N > 0
    lengths = VALID_N.copy()
    jn, tn = np.array(jn), tn.numpy()
    for _ in range(3):
        jn, jcache = jfns.decode(jparams, jcache, jnp.asarray(jn),
                                 jnp.asarray(lengths), jnp.asarray(active))
        tn, tcache = tfns.decode(module, tcache, torch.from_numpy(tn),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(active))
        jn, tn = np.array(jn), tn.numpy()
        np.testing.assert_array_equal(tn[active], jn[active])
        lengths = lengths + active


def test_reset_slots_invalidates_exactly_the_dropped_slots(ref_params):
    _, np_tree = ref_params
    _, tcfg = _cfgs("float32")
    tfns = build_serve_fns(tcfg, batch=B, max_len=MAX_LEN, device="cpu")
    module = params_from_jax(np_tree, tcfg)
    cache = tfns.init_cache()
    _, _, cache = tfns.prefill_chunk(
        module, cache, torch.from_numpy(_tokens((B, C), 257, seed=4)),
        torch.zeros(B, dtype=torch.int32),
        torch.full((B,), C, dtype=torch.int32))
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    keep = torch.tensor([True, False, True, False])
    cache = tfns.reset_slots(cache, keep)
    for old, new in zip(before, cache):
        assert torch.equal(new["pos"][keep], old["pos"][keep])
        assert (old["pos"][keep] >= 0).any()
        assert torch.all(new["pos"][~keep] == -1)
        assert torch.equal(new["k"], old["k"]) and torch.equal(new["v"],
                                                                old["v"])
