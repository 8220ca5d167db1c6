"""Tensor-parallel serving of MLA, the SSD and RG-LRU mixers and the
encoder-decoder on gloo at world 4, against the one-device port.

One group of 4 gloo ranks for the file (``tests/_torch_serve_worker.py``)
serves the smoke configs of DeepSeek-V2-Lite (MLA: its heads over
``model``, the latent cache's length over ``model``; meshes (data,
model) = (2, 2), (1, 4) and (4, 1)), Mamba2-370M (the SSD on its heads,
the ``state`` over heads, the conv windows whole), RecurrentGemma-2B
(the RG-LRU on its channels; its local attention's single kv head
puts the ring's length over ``model``) and Whisper-large-v3 (encoder,
decoder and cross-attention on their heads; the first prefill encodes
frames, so the cross K/V are real) on (2, 2) and (1, 4) under
``chunked``, the last three also under ``pallas`` on (1, 4) (the
kernels' plain versions), and RecurrentGemma and Whisper with 6 heads
on (1, 4): 6 query heads do not divide ``model`` 4 (as RecurrentGemma's
10 and Whisper's 20 on 16 at full width), so q, k and v are gathered
whole, and Whisper's cross K/V put the frames over ``model``.  The
weights are the port's own, drawn from a seed and carried to every
rank.  Held, as ``tests/test_torch_serve_mesh.py`` holds them: the
``serve_mixed_slo`` RunReport JSON and every request's tokens byte for
byte, the prefill and decode logits within 1e-5 (f32) of the one-device
port's, the greedy tokens, ``reset_slots`` on the sharded cache, and
each rank's cache shapes (at init and after the frames filled the cross
K/V) against the reference's ``cache_pspecs`` on a JAX mesh of that
shape.  The one-device port is held to the JAX package by
``tests/test_torch_{moe_mla,recurrent_models,whisper,engine}.py``.
"""
import json
import sys

import numpy as np
import pytest
import torch

import _torch_dist
import _torch_serve_worker as W
from repro_torch.models.registry import build_model

TOL = 1e-5
BOTH = [[2, 2], [1, 4]]
CASES = [
    dict(name="deepseek", arch="deepseek-v2-lite-16b",
         changes={"attn_impl": "chunked"}, meshes=BOTH + [[4, 1]]),
    dict(name="mamba2", arch="mamba2-370m",
         changes={"attn_impl": "chunked"}, meshes=BOTH),
    dict(name="mamba2_pallas", arch="mamba2-370m",
         changes={"attn_impl": "pallas"}, meshes=[[1, 4]]),
    dict(name="rgemma", arch="recurrentgemma-2b",
         changes={"attn_impl": "chunked"}, meshes=BOTH),
    dict(name="rgemma_pallas", arch="recurrentgemma-2b",
         changes={"attn_impl": "pallas"}, meshes=[[1, 4]]),
    dict(name="rgemma_h6", arch="recurrentgemma-2b",
         changes={"attn_impl": "pallas", "num_heads": 6}, meshes=[[1, 4]]),
    dict(name="whisper", arch="whisper-large-v3",
         changes={"attn_impl": "chunked"}, meshes=BOTH),
    dict(name="whisper_pallas", arch="whisper-large-v3",
         changes={"attn_impl": "pallas"}, meshes=[[1, 4]]),
    dict(name="whisper_h6", arch="whisper-large-v3",
         changes={"attn_impl": "pallas", "num_heads": 6, "num_kv_heads": 6},
         meshes=[[1, 4]]),
]
RUNS = [(c["name"], f"{m[0]}x{m[1]}") for c in CASES for m in c["meshes"]]
BY_NAME = {c["name"]: c for c in CASES}
# each cache leaf's dims in the port (the reference may stack layers)
LEAF_DIMS = {"pos": 2, "h": 2, "ckv": 3, "krope": 3, "conv": 3,
             "conv_x": 3, "conv_B": 3, "conv_C": 3, "state": 4, "k": 4,
             "v": 4, "xk": 4, "xv": 4}


def _inputs(cfg):
    rng = np.random.default_rng(11)
    inp = dict(batch=8, max_len=64, steps=4, reset_at=2,
               prompt=rng.integers(1, cfg.vocab_size, (8, 12)).tolist(),
               valid_n=[12, 5, 9, 1, 12, 7, 3, 10],
               keep=[True, False, True, True, False, True, True, False])
    if cfg.is_encoder_decoder:
        inp["frames"] = rng.standard_normal(
            (8, cfg.num_audio_frames, cfg.d_model)).astype(np.float32
                                                           ).tolist()
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device port's results of every case and the world-4
    worker's output directory."""
    d = tmp_path_factory.mktemp("serve_mesh_families")
    ind, outd = d / "in", d / "out"
    ind.mkdir()
    outd.mkdir()
    single = {}
    for case in CASES:
        cfg = W.case_cfg(case)
        module = build_model(cfg).init(torch.Generator().manual_seed(3))
        path = ind / f"{case['name']}.pt"
        torch.save(module.state_dict(), path)
        case["inputs"] = _inputs(cfg)
        report, toks = W.serve_report(cfg, str(path), None)
        arrays, _, cleared = W.logits_run(cfg, W.whole_module(cfg, str(path)),
                                          None, case["inputs"])
        single[case["name"]] = dict(report=report, tokens=toks,
                                    arrays=arrays, cleared=cleared)
    with open(ind / "cases.json", "w") as f:
        json.dump(CASES, f)
    outs = _torch_dist.run_ranks(4, [sys.executable, W.__file__, str(ind),
                                     str(outd)])
    bad = [(r, rc, out) for r, (rc, out) in enumerate(outs) if rc != 0]
    assert not bad, (f"rank {bad[0][0]} exited {bad[0][1]}:\n"
                     f"{bad[0][2][-6000:]}")
    return single, outd


def _rank_results(outd, name, mesh):
    res = []
    for r in range(4):
        with open(outd / f"{name}__{mesh}__r{r}.json") as f:
            meta = json.load(f)
        arrays = dict(np.load(outd / f"{name}__{mesh}__r{r}.npz"))
        res.append((meta, arrays))
    return res


@pytest.mark.parametrize("name,mesh", RUNS)
def test_serve_report_equals_one_device(runs, name, mesh):
    single, outd = runs
    want = single[name]
    assert "decode_steps" in want["report"]
    for r, (meta, _) in enumerate(_rank_results(outd, name, mesh)):
        assert meta["report"] == want["report"], f"rank {r}"
        assert meta["tokens"] == want["tokens"], f"rank {r}"


@pytest.mark.parametrize("name,mesh", RUNS)
def test_logits_match_one_device(runs, name, mesh):
    single, outd = runs
    want = single[name]["arrays"]
    vocab = W.case_cfg(BY_NAME[name]).vocab_size
    for r, (_, got) in enumerate(_rank_results(outd, name, mesh)):
        assert set(got) == set(want)
        for key, g in got.items():
            what = f"{name} {mesh} rank {r} {key}"
            if key.endswith("tokens"):
                np.testing.assert_array_equal(g, want[key], err_msg=what)
            else:
                assert g.shape == (8, vocab)
                np.testing.assert_allclose(g, want[key], rtol=TOL, atol=TOL,
                                           err_msg=what)


@pytest.mark.parametrize("name,mesh", RUNS)
def test_reset_slots_on_the_sharded_cache(runs, name, mesh):
    """The dropped slots' positions (or recurrent rows) are cleared on
    every rank, and the steps after the reset (``decode2`` / ``decode3``)
    restart those slots as on one device."""
    single, outd = runs
    assert single[name]["cleared"] is True
    for r, (meta, got) in enumerate(_rank_results(outd, name, mesh)):
        assert meta["reset_cleared"] is True, f"rank {r}"
        for key in ("decode2", "decode3"):
            np.testing.assert_allclose(got[key],
                                       single[name]["arrays"][key],
                                       rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,mesh", RUNS)
def test_cache_shapes_are_the_reference_specs_local_shapes(runs, name,
                                                           mesh):
    """Each rank's cache leaves, at init and after the run (an
    encoder-decoder's cross K/V refilled from frames), have the shape
    that the reference's ``cache_pspecs`` gives one device of a JAX mesh
    of the same shape (its scan-stacked layer dim dropped)."""
    jax = pytest.importorskip("jax")
    import dataclasses

    from jax.sharding import NamedSharding
    from repro.configs import smoke_config as jsmoke_config
    from repro.distributed import sharding as JSH
    from repro.models.registry import build_model as jbuild_model
    _, outd = runs
    case = BY_NAME[name]
    shape = tuple(int(x) for x in mesh.split("x"))
    jmesh = _torch_dist.jax_cpu_mesh(shape, ("data", "model"))
    jcfg = dataclasses.replace(jsmoke_config(case["arch"]), dtype="float32",
                               **dict(case["changes"], attn_impl="chunked"))
    inp = case["inputs"]
    sds = jax.eval_shape(lambda: jbuild_model(jcfg).init_cache(
        inp["batch"], inp["max_len"]))
    specs = JSH.cache_pspecs(jcfg, sds, jmesh)
    want = set()
    for path, x in jax.tree_util.tree_leaves_with_path(sds):
        spec = specs
        for k in path:
            spec = spec[k.key if hasattr(k, "key") else k.idx]
        local = NamedSharding(jmesh, spec).shard_shape(x.shape)
        leaf = str(path[-1].key)
        nd = LEAF_DIMS[leaf]
        assert len(local) in (nd, nd + 1) and (len(local) == nd
                                               or spec[0] is None)
        want.add((leaf, tuple(local[len(local) - nd:])))
    for r, (meta, _) in enumerate(_rank_results(outd, name, mesh)):
        for key in ("cache_shapes", "cache_shapes_end"):
            got = {(k, tuple(s)) for layer in meta[key]
                   for k, s in layer.items()}
            assert got == want, f"rank {r} {key}"
