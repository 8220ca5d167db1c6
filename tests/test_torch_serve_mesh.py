"""The port's sharded serving on gloo at world 4 against the one-device
port and the JAX package's one-device serve.

Every case serves the same weights (the reference's, carried into the
port) through the mesh branch of ``serving/serve_step.py`` on meshes
(data, model) = (2, 2), (1, 4) and (4, 1), one gloo group for the file
(``tests/_torch_serve_worker.py``): the Qwen3 smoke config with its kv
heads over ``model``; the same with 2 kv heads at model 4, so the
cache's length goes over ``model`` (under ``chunked`` and under
``pallas``, whose decode runs the kernel's plain version with its
log-sum-exp); and the Llama-4 Maverick smoke config (serve_keep_fsdp:
its experts over ``data``, their hidden dim over ``model``).  Held: the
``serve_mixed_slo`` RunReport JSON and every request's tokens byte for
byte, the prefill and decode logits within 1e-5 (f32) of the one-device
port's and of the reference's ``build_serve_fns``, the greedy tokens,
``reset_slots`` on the sharded cache, each rank's cache shapes against
the reference's ``cache_pspecs`` on a JAX mesh of the same shape.  Last,
the mesh branch builds and runs a decode step for every architecture's
smoke config on a ``model`` 4 mesh of the dry run's fake process group
(the families' own parity is ``tests/test_torch_serve_mesh_families.py``).
The reference's own sharded serve cannot be the oracle: on jax 0.9 its
``with_sharding_constraint`` refuses the mesh's Explicit axes.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import _torch_dist  # noqa: E402
import _torch_serve_worker as W  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.serving.serve_step import build_serve_fns as jserve_fns  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402

TOL = 1e-5
MESHES = [[2, 2], [1, 4], [4, 1]]
CASES = [
    dict(name="qwen3", arch="qwen3-8b", changes={"attn_impl": "chunked"},
         meshes=MESHES),
    dict(name="qwen3_kv2", arch="qwen3-8b",
         changes={"attn_impl": "chunked", "num_kv_heads": 2},
         meshes=[[1, 4]]),
    dict(name="qwen3_kv2_pallas", arch="qwen3-8b",
         changes={"attn_impl": "pallas", "num_kv_heads": 2},
         meshes=[[1, 4]]),
    dict(name="llama4", arch="llama4-maverick-400b-a17b",
         changes={"attn_impl": "chunked"}, meshes=MESHES),
]
RUNS = [(c["name"], f"{m[0]}x{m[1]}") for c in CASES for m in c["meshes"]]
BY_NAME = {c["name"]: c for c in CASES}


def _inputs(vocab):
    rng = np.random.default_rng(7)
    return dict(batch=8, max_len=64, steps=4, reset_at=2,
                prompt=rng.integers(1, vocab, (8, 12)).tolist(),
                valid_n=[12, 5, 9, 1, 12, 7, 3, 10],
                keep=[True, False, True, True, False, True, True, False])


def _jcfg(case):
    changes = dict(case["changes"], attn_impl="chunked")
    return dataclasses.replace(jsmoke_config(case["arch"]), dtype="float32",
                               **changes)


def _reference_logits(case, jparams, inp):
    """``W.logits_run``'s sequence through the reference's one-device
    serve functions (``chunked``)."""
    import jax.numpy as jnp
    B = inp["batch"]
    fns = jserve_fns(_jcfg(case), None, batch=B, max_len=inp["max_len"])
    cache, cache2 = fns.init_cache(), fns.init_cache()
    toks = jnp.asarray(np.asarray(inp["prompt"], np.int32))
    lens = jnp.zeros(B, jnp.int32)
    vn = jnp.asarray(np.asarray(inp["valid_n"], np.int32))
    out = {}
    nxt, last, cache = fns.prefill_chunk(jparams, cache, toks, lens, vn)
    _, _, cache2 = fns.prefill_chunk(jparams, cache2, toks, lens, vn)
    out["prefill"], out["prefill_tokens"] = last, nxt
    lens = lens + vn
    ones = jnp.ones(B, jnp.int32)
    active = jnp.ones(B, bool)
    keep = jnp.asarray(inp["keep"])
    for i in range(inp["steps"]):
        if i == inp["reset_at"]:
            cache = fns.reset_slots(cache, keep)
            cache2 = fns.reset_slots(cache2, keep)
            lens = jnp.where(keep, lens, 0)
        _, logit, cache = fns.prefill_chunk(jparams, cache, nxt[:, None],
                                            lens, ones)
        dec, cache2 = fns.decode(jparams, cache2, nxt, lens, active)
        out[f"decode{i}"], out[f"decode{i}_tokens"] = logit, dec
        nxt = dec
        lens = lens + 1
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-device port's and the reference's results of every case,
    and the world-4 worker's output directory."""
    d = tmp_path_factory.mktemp("serve_mesh")
    ind, outd = d / "in", d / "out"
    ind.mkdir()
    outd.mkdir()
    single = {}
    for case in CASES:
        jcfg = _jcfg(case)
        jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
        cfg = W.case_cfg(case)
        module = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
        path = ind / f"{case['name']}.pt"
        torch.save(module.state_dict(), path)
        case["inputs"] = _inputs(cfg.vocab_size)
        report, toks = W.serve_report(cfg, str(path), None)
        arrays, _, cleared = W.logits_run(cfg, W.whole_module(cfg, str(path)),
                                          None, case["inputs"])
        single[case["name"]] = dict(
            report=report, tokens=toks, arrays=arrays, cleared=cleared,
            ref=_reference_logits(case, jparams, case["inputs"]))
    with open(ind / "cases.json", "w") as f:
        json.dump(CASES, f)
    outs = _torch_dist.run_ranks(4, [sys.executable, W.__file__, str(ind),
                                     str(outd)])
    bad = [(r, rc, out) for r, (rc, out) in enumerate(outs) if rc != 0]
    assert not bad, f"rank {bad[0][0]} exited {bad[0][1]}:\n{bad[0][2][-6000:]}"
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
def test_logits_match_one_device_and_reference(runs, name, mesh):
    single, outd = runs
    want, ref = single[name]["arrays"], single[name]["ref"]
    for r, (_, got) in enumerate(_rank_results(outd, name, mesh)):
        assert set(got) == set(want)
        for key, g in got.items():
            what = f"{name} {mesh} rank {r} {key}"
            if key.endswith("tokens"):
                np.testing.assert_array_equal(g, want[key], err_msg=what)
                np.testing.assert_array_equal(g, ref[key], err_msg=what)
            else:
                assert g.shape == (8, W.case_cfg(BY_NAME[name]).vocab_size)
                np.testing.assert_allclose(g, want[key], rtol=TOL, atol=TOL,
                                           err_msg=what)
                np.testing.assert_allclose(g, ref[key], rtol=TOL, atol=TOL,
                                           err_msg=what)


@pytest.mark.parametrize("name,mesh", RUNS)
def test_reset_slots_on_the_sharded_cache(runs, name, mesh):
    """The dropped slots' positions are -1 on every rank after the reset,
    and the steps after it (``decode2`` / ``decode3`` above) restart those
    slots as on one device."""
    single, outd = runs
    assert single[name]["cleared"] is True
    for r, (meta, got) in enumerate(_rank_results(outd, name, mesh)):
        assert meta["reset_cleared"] is True, f"rank {r}"
        np.testing.assert_allclose(got["decode2"],
                                   single[name]["arrays"]["decode2"],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,mesh", RUNS)
def test_cache_shapes_are_the_reference_specs_local_shapes(runs, name,
                                                           mesh):
    """Each rank's cache leaves have the shape that the reference's
    ``cache_pspecs`` gives one device of a JAX mesh of the same shape
    (its scan-stacked layer dim dropped)."""
    from jax.sharding import NamedSharding
    _, outd = runs
    case = BY_NAME[name]
    shape = tuple(int(x) for x in mesh.split("x"))
    jmesh = _torch_dist.jax_cpu_mesh(shape, ("data", "model"))
    inp = case["inputs"]
    model = jbuild_model(_jcfg(case))
    sds = jax.eval_shape(lambda: model.init_cache(inp["batch"],
                                                  inp["max_len"]))
    specs = JSH.cache_pspecs(_jcfg(case), sds, jmesh)
    want = set()
    for path, x in jax.tree_util.tree_leaves_with_path(sds):
        spec = specs
        for k in path:
            spec = spec[k.key if hasattr(k, "key") else k.idx]
        local = NamedSharding(jmesh, spec).shard_shape(x.shape)
        leaf = str(path[-1].key)
        nd = 2 if leaf == "pos" else 4            # the port's leaf dims
        assert len(local) in (nd, nd + 1) and (len(local) == nd
                                               or spec[0] is None)
        want.add((leaf, tuple(local[len(local) - nd:])))
    for r, (meta, _) in enumerate(_rank_results(outd, name, mesh)):
        got = {(k, tuple(s)) for layer in meta["cache_shapes"]
               for k, s in layer.items()}
        assert got == want, f"rank {r}"


@pytest.fixture
def fake_world_of_four():
    """This process as rank 0 of the dry run's fake process group of 4
    (collectives return at once), torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    dryrun.fake_group(4)
    yield
    dist.destroy_process_group()


def test_a_model_axis_serves_every_architecture(fake_world_of_four):
    """Every architecture of ``list_archs()``, at its smoke config, builds
    its serve functions on a (1, 4) mesh and runs a decode step on the
    meta device: no family refuses a ``model`` axis."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import list_archs, smoke_config
    from repro_torch.serving.serve_step import build_serve_fns
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    B = 8
    for arch in list_archs():
        fns = build_serve_fns(smoke_config(arch), mesh, batch=B, max_len=64,
                              device="meta")
        assert fns.layout.model == 4, arch
        module, cache = fns.init_params(0), fns.init_cache()
        ids = torch.empty(B, dtype=torch.int32, device="meta")
        nxt, _ = fns.decode(module, cache, ids, ids,
                            torch.empty(B, dtype=torch.bool, device="meta"))
        assert tuple(nxt.shape) == (B,), arch
