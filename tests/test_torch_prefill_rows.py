"""A prefill call that computes only the granted slots' rows.

(a) ``ServeFns.prefill_rows`` over 2 of 4 slots against the whole
``prefill_chunk`` on the same cache, one case a family (dense GQA, MLA,
SSD, RG-LRU, encoder-decoder; float32 smoke configs): the same sampled
tokens, the granted rows' last logits within the parity tolerance, the
granted slots' payloads and state close, every slot's ``pos`` bit-equal
(the whole chunk's pad entries in the other slots' rings), and the other
slots' payloads and state bit-identical to before the call.
(b) ``ModelExecutor.prefill`` takes ``prefill_rows`` where some rows or
none are valid, and the whole chunk where every row is valid, for a
model with MoE layers and over a mesh; both paths return the same
tokens at the valid rows.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

# the card's machine has no JAX: there this module, which holds no
# ``gpu`` test, skips as a whole
jax = pytest.importorskip("jax")

import _torch_parity as P
from repro_torch.configs import smoke_config
from repro_torch.serving.engine import EngineConfig, ModelExecutor
from repro_torch.serving.serve_step import build_serve_fns

B, C, MAX_LEN = 4, 16, 24
FIRST = [16, 9, 16, 5]           # the fills before the call under test:
#                                  slots 0 and 2's chunks wrap their rings
GRANTED = [0, 12, 0, 7]          # its valid rows: slots 1 and 3
FAMILIES = {
    "dense_gqa": ("qwen3-8b", {}),
    "mla": ("deepseek-v2-lite-16b", {"moe": None}),
    "ssd": ("mamba2-370m", {}),
    "rglru": ("recurrentgemma-2b", {}),
    "encdec": ("whisper-large-v3", {}),
}


def _cfg(arch, **changes):
    return dataclasses.replace(smoke_config(arch), dtype="float32",
                               **changes)


def _i32(a):
    return torch.tensor(a, dtype=torch.int32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_prefill_rows_equals_the_whole_chunk_on_its_slots(family):
    arch, changes = FAMILIES[family]
    cfg = _cfg(arch, **changes)
    fns = build_serve_fns(cfg, batch=B, max_len=MAX_LEN, prefill_chunk=C,
                          device="cpu")
    assert fns.prefill_rows is not None
    module = fns.init_params(0)
    rng = np.random.default_rng(1)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_audio_frames, cfg.d_model)).astype(np.float32))
    first = torch.from_numpy(P.tokens((B, C), cfg.vocab_size, seed=2))
    _, _, cache = fns.prefill_chunk(module, fns.init_cache(), first,
                                    _i32([0] * B), _i32(FIRST), **kw)
    before = copy.deepcopy(cache)
    whole, rows = copy.deepcopy(cache), cache
    toks = torch.from_numpy(P.tokens((B, C), cfg.vocab_size, seed=3))
    lengths, valid_n = _i32(FIRST), _i32(GRANTED)
    want_tok, want_last, whole = fns.prefill_chunk(module, whole, toks,
                                                   lengths, valid_n)
    s = torch.tensor([1, 3])
    got_tok, got_last, rows = fns.prefill_rows(module, rows, s, toks,
                                               lengths, valid_n)
    assert torch.equal(got_tok, want_tok[s])
    P.close(got_last.numpy(), want_last[s].numpy(), "last logits")
    other = [0, 2]
    for i, (w, g, b) in enumerate(zip(whole, rows, before)):
        assert set(g) == set(b)
        for name, t in g.items():
            what = f"layer {i} {name}"
            if name == "pos":
                assert torch.equal(t, w[name]), what
                continue
            P.close(t[s].float().numpy(), w[name][s].float().numpy(), what)
            assert torch.equal(t[other], b[name][other]), what
    # the pad entries erased live keys of the other slots' rings
    erased = [not torch.equal(b["pos"][other], g["pos"][other])
              for g, b in zip(rows, before) if "pos" in b]
    assert all(erased) if family != "ssd" else not erased


def _arrays(valid_n, vocab):
    valid_n = np.asarray(valid_n, np.int32)
    tokens = P.tokens((B, C), vocab, seed=4)
    tokens[np.arange(C)[None, :] >= valid_n[:, None]] = 0
    return tokens, np.asarray(FIRST, np.int32), valid_n


@pytest.mark.parametrize("arch,valid_n,path", [
    ("qwen3-8b", GRANTED, "prefill_rows"),
    ("qwen3-8b", [C] * B, "prefill_chunk"),
    ("qwen3-8b", [0] * B, "prefill_rows"),
    ("mamba2-370m", [0, 0, 3, 0], "prefill_rows"),
    ("deepseek-v2-lite-16b", GRANTED, "prefill_chunk"),
    ("deepseek-v2-lite-16b", [C] * B, "prefill_chunk"),
], ids=["dense-some", "dense-all", "dense-none", "ssd-one", "moe-some",
        "moe-all"])
def test_executor_prefill_takes_the_rows_it_can(monkeypatch, arch, valid_n,
                                                path):
    """The executor's choice, and the same tokens at the valid rows as
    the whole chunk on a twin executor from the same seed."""
    cfg = _cfg(arch)
    ecfg = EngineConfig(max_slots=B, max_len=MAX_LEN, prefill_chunk=C)
    exe = ModelExecutor(cfg, ecfg, rng_seed=0, device="cpu")
    twin = ModelExecutor(cfg, ecfg, rng_seed=0, device="cpu")
    assert (exe.fns.prefill_rows is None) == any(cfg.moe_layer_mask())
    twin.fns.prefill_rows = None
    tokens, lengths, valid_n = _arrays(valid_n, cfg.vocab_size)
    calls = P.count_calls(monkeypatch, exe.fns,
                          *(n for n in ("prefill_chunk", "prefill_rows")
                            if getattr(exe.fns, n) is not None))
    got = exe.prefill(tokens, lengths, valid_n)
    assert calls == [path]
    want = twin.prefill(tokens, lengths, valid_n)
    assert got.shape == want.shape == (B,)
    rows = valid_n > 0
    np.testing.assert_array_equal(got[rows], want[rows])
    if path == "prefill_rows":
        assert not got[~rows].any()


@pytest.fixture
def fake_world_of_four():
    """This process as rank 0 of the dry run's fake process group of 4
    (collectives return at once), torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    dryrun.fake_group(4)
    yield
    dist.destroy_process_group()


def test_a_mesh_prefills_the_whole_chunk(fake_world_of_four, monkeypatch):
    """Over a (1, 4) mesh the serve functions have no ``prefill_rows``
    (each rank holds a block of the batch rows), and the executor hands
    the whole (B, C) arrays to ``prefill_chunk``, stood in for here: the
    meta device computes nothing."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    cfg = smoke_config("qwen3-8b")
    exe = ModelExecutor(cfg, EngineConfig(max_slots=B, max_len=MAX_LEN,
                                          prefill_chunk=C),
                        device="meta", mesh=mesh)
    assert exe.fns.prefill_rows is None
    seen = []

    def stand_in(module, cache, tokens, lengths, valid_n):
        seen.append(tuple(tokens.shape))
        return torch.arange(B, dtype=torch.int32), None, cache
    monkeypatch.setattr(exe.fns, "prefill_chunk", stand_in)
    out = exe.prefill(*_arrays(GRANTED, cfg.vocab_size))
    assert seen == [(B, C)]
    np.testing.assert_array_equal(out, np.arange(B))
