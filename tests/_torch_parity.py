"""Helpers of the model-parity tests: the port's decoder against the JAX
package's, from the same weights.

The reference parameter tree goes through numpy into the port
(``weights.params_from_jax``); tokens are drawn from a seed with numpy.
The reference runs ``chunked``; the port runs ``chunked`` or ``pallas``
(on CPU tensors the kernels' plain versions).  float32 throughout:
logits at 1e-4, greedy tokens equal.  Import this module after
``pytest.importorskip("jax")``: it imports the JAX package.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import ServeRuntime as JaxServeRuntime
from repro.api import get_scenario as jax_get_scenario
from repro.configs import smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ModelExecutor as JaxModelExecutor
from repro_torch.api import ServeRuntime, get_scenario
from repro_torch.configs import YaRNConfig, smoke_config
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ModelExecutor
from repro_torch.serving.serve_step import build_serve_fns
from repro_torch.weights import params_from_jax

TOL = 1e-4
MAX_LEN = 64
IMPLS = ["chunked", "pallas"]
SCENARIO_KW = dict(tenants=3, requests=6, max_len=MAX_LEN, prefill_chunk=16)


def cfgs(arch, port_impl, **changes):
    """float32 smoke configs of ``arch``: the reference's under
    ``chunked``, the port's under ``port_impl``."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               attn_impl="chunked", **changes)
    tcfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                               attn_impl=port_impl, **changes)
    return jcfg, tcfg


def ref_params(arch, **changes):
    """(reference params, the same tree as numpy) for ``arch``."""
    jcfg, _ = cfgs(arch, "chunked", **changes)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


# fields of the port's config that the reference's lacks, at the values
# that compute what the reference computes
PORT_ONLY = {"yarn": YaRNConfig()}
PORT_ONLY_MOE = {"norm_topk_prob": True, "serve_impl": "gshard"}


def as_reference(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` less the fields the port adds to the
    reference's config (YaRN, the MoE routing and serving options), each
    first checked to hold the value that computes the reference's
    function, so that the dict compares with the reference's whole."""
    d = dataclasses.asdict(cfg)
    for name, want in PORT_ONLY.items():
        assert getattr(cfg, name) == want, name
        del d[name]
    if cfg.moe is not None:
        for name, want in PORT_ONLY_MOE.items():
            assert getattr(cfg.moe, name) == want, name
            del d["moe"][name]
    return d


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(
        1, vocab, size=shape, dtype=np.int64).astype(np.int32)


def close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def forward_pair(arch, jparams, np_tree, port_impl, batch, **changes):
    """Cache-free (logits, aux) of both packages on one numpy batch."""
    jcfg, tcfg = cfgs(arch, port_impl, **changes)
    want = jax_build_model(jcfg).forward(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    module = params_from_jax(np_tree, tcfg)
    with torch.no_grad():
        got = build_model(tcfg).forward(
            module, {k: torch.from_numpy(v) for k, v in batch.items()})
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def prefill_then_decode(arch, jparams, np_tree, port_impl, prompts, C,
                        steps, frames=None, **changes):
    """Ragged chunked prefill (C tokens a call; each row's real tokens
    end where its prompt does) and ``steps`` greedy decode steps, through
    both packages' ``Model.prefill`` / ``decode_step``; ``frames`` (an
    encoder-decoder's numpy (B, T_enc, d)) go with the first prefill
    call.  Yields (what, reference, port) pairs; returns the port's cache
    at the end."""
    jcfg, tcfg = cfgs(arch, port_impl, **changes)
    jm, tm = jax_build_model(jcfg), build_model(tcfg)
    module = params_from_jax(np_tree, tcfg)
    B = len(prompts)
    toks = tokens((B, max(prompts)), jcfg.vocab_size, seed=2)
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
        jkw, tkw = {}, {}
        if frames is not None and not lengths.any():
            jkw["frames"] = jnp.asarray(frames)
            tkw["frames"] = torch.from_numpy(frames)
        jl, jcache = jm.prefill(jparams, jnp.asarray(chunk), jcache,
                                jnp.asarray(lengths),
                                valid=jnp.asarray(valid), **jkw)
        with torch.no_grad():
            tl, tcache = tm.prefill(module, torch.from_numpy(chunk), tcache,
                                    torch.from_numpy(lengths),
                                    valid=torch.from_numpy(valid), **tkw)
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


def check_pairs(gen):
    """Hold every pair of ``prefill_then_decode``; returns its cache."""
    while True:
        try:
            what, want, got = next(gen)
        except StopIteration as stop:
            return stop.value
        if "tokens" in what:
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            close(got, want, what)


def run_model_engines(arch, **scenario_kw):
    """``serve_mixed_slo`` on both engines over the float32 smoke model:
    the port loads the reference's weights and runs ``pallas``, the
    reference ``chunked``.  Returns (jax runtime, its report, port
    runtime, its report)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                               attn_impl="pallas")
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    module = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    kw = dict(SCENARIO_KW, vocab=jcfg.vocab_size)
    kw.update(scenario_kw)
    jspec = jax_get_scenario("serve_mixed_slo", **kw)
    tspec = get_scenario("serve_mixed_slo", **kw)
    jrt = JaxServeRuntime.from_spec(
        jspec, executor=lambda e: JaxModelExecutor(jcfg, e, params=params))
    trt = ServeRuntime.from_spec(
        tspec, executor=lambda e: ModelExecutor(tcfg, e, params=module,
                                                device="cpu"))
    return jrt, jrt.run(jspec), trt, trt.run(tspec)


def count_calls(monkeypatch, module, *names):
    """Replace each ``module.<name>`` by a wrapper that appends the name
    to the returned list, then calls the original."""
    calls = []
    for name in names:
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    return calls


def check_reset_slots(arch):
    """A slot reassigned after ``reset_slots`` gives the logits of a fresh
    cache: its KV positions are cleared (k/v, ckv/krope payloads are
    masked by them) and its recurrent state and conv windows zeroed; the
    other slot's cache is kept."""
    _, tcfg = cfgs(arch, "pallas")
    fns = build_serve_fns(tcfg, batch=2, max_len=MAX_LEN, device="cpu")
    module = fns.init_params(0)
    C = 16
    old = torch.from_numpy(tokens((2, C), tcfg.vocab_size, seed=3))
    new = torch.from_numpy(tokens((2, C), tcfg.vocab_size, seed=4))
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
    return cache
