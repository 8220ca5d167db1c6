"""The port's sharding rules against the JAX package's, with no rank.

For every catalog architecture at full size, in train and serve mode, on
meshes (data 2, model 4) and (pod 2, data 2, model 2): the port's spec of
every parameter (named as the port names it, the reference's stacked
layer axis dropped) equals the reference's ``param_pspecs``.  The port
reads the axis sizes from a plain mapping; the reference from its host
mesh of 8 forced CPU devices.  Also: the batch-axis fallback, the cache
placements, the degrade-to-replication cases and the DTensor placements
the specs turn into.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

jax = pytest.importorskip("jax")

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.configs import smoke_config as jsmoke_config
from repro.distributed import sharding as JSH
from repro.models.registry import build_model as jbuild_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer
from repro_torch.models.registry import build_model
from repro_torch.weights import named_arrays

ARCHS = list_archs()


@pytest.fixture(scope="module")
def host_mesh():
    """The reference's meshes over CPU devices (skipped with fewer than
    8, another machine's settings)."""
    import _torch_dist
    return _torch_dist.jax_cpu_mesh((2, 4), ("data", "model"))


@pytest.fixture(scope="module")
def pod_mesh():
    import _torch_dist
    return _torch_dist.jax_cpu_mesh((2, 2, 2), ("pod", "data", "model"))
MESHES = {"2x4": {"data": 2, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}


def _jmesh(name, host_mesh, pod_mesh):
    return host_mesh if name == "2x4" else pod_mesh


def _boxed(obj, shape):
    """A zero-stride array of ``shape`` whose every element is ``obj``."""
    o = np.empty((), dtype=object)
    o[()] = obj
    return np.broadcast_to(o, shape)


def _reference_by_port_name(arch, jmesh, mode):
    """{port name: (shape, reference spec)} for the full config."""
    jcfg = jget_config(arch)
    sds = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    specs = JSH.param_pspecs(jcfg, sds, jmesh, mode)
    boxed = jax.tree.map(lambda x, s: _boxed(tuple(s), x.shape), sds, specs,
                         is_leaf=lambda x: hasattr(x, "shape"))
    out = {}
    for name, arr in named_arrays(boxed, get_config(arch)).items():
        spec = arr.flat[0]
        drop = len(spec) - arr.ndim
        assert drop in (0, 1) and all(e is None for e in spec[:drop]), \
            (name, spec, arr.shape)
        out[name] = (tuple(arr.shape), tuple(spec[drop:]))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, mode, mesh, host_mesh,
                                          pod_mesh):
    ref = _reference_by_port_name(arch, _jmesh(mesh, host_mesh, pod_mesh),
                                  mode)
    cfg = get_config(arch)
    got = SH.param_pspecs(cfg, {n: s for n, (s, _) in ref.items()},
                          MESHES[mesh], mode)
    assert set(got) == set(ref)
    bad = {n: (got[n], spec) for n, (_, spec) in ref.items()
           if got[n] != spec}
    assert not bad, list(bad.items())[:5]
    # the placements shard each tensor dim the spec names, and nothing else
    sizes = MESHES[mesh]
    for n, (shape, spec) in ref.items():
        pls = SH.placements(spec, sizes)
        assert _spec_of(pls, sizes, len(shape)) == spec, n
        sl = SH.local_slices(shape, pls, sizes, [s - 1 for s in
                                                 sizes.values()])
        assert all(s.stop == d for s, d in zip(sl, shape)), n


def _spec_of(pls, sizes, ndim):
    """The placements read back as one entry per tensor dim."""
    dims = {}
    for axis, pl in zip(sizes, pls):
        if isinstance(pl, Shard):
            dims.setdefault(pl.dim, []).append(axis)
    return tuple(None if d not in dims else
                 (dims[d][0] if len(dims[d]) == 1 else tuple(dims[d]))
                 for d in range(ndim))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_modules_have_the_shapes_the_rules_see(arch):
    """The full-size test above reads the port's names and shapes off the
    reference's tree; at smoke size the port's own modules hold exactly
    those names and shapes."""
    jcfg = jsmoke_config(arch)
    sds = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    want = {n: a.shape for n, a in named_arrays(
        jax.tree.map(lambda x: np.broadcast_to(np.float32(0), x.shape), sds),
        smoke_config(arch)).items()}
    gen = torch.Generator().manual_seed(0)
    module = build_model(smoke_config(arch)).init(gen)
    got = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert got == want


def test_degrade_to_replication_when_a_dim_does_not_divide():
    """Whisper's 20 heads of 64 (proj 1280) over model 16: 1280 divides,
    so wq shards; its vocab 51866 does not, so the embedding replicates.
    An axis of size 1 shards nothing; a mesh axis shards one dim at most
    (MoE (E, d, f) in train: 'model' goes to the experts)."""
    cfg = get_config("whisper-large-v3")
    shapes = {"embed": (51866, 1280), "dec_layers.0.cross.wq": (1280, 1280),
              "dec_layers.0.cross.wo": (1280, 1280)}
    got = SH.param_pspecs(cfg, shapes, {"data": 16, "model": 16}, "train")
    assert got["embed"] == (None, None)
    assert got["dec_layers.0.cross.wq"] == ("data", "model")
    assert got["dec_layers.0.cross.wo"] == ("model", "data")
    odd = SH.param_pspecs(cfg, {"dec_layers.0.mixer.wq": (1280, 20 * 63)},
                          {"data": 16, "model": 16}, "train")
    assert odd["dec_layers.0.mixer.wq"] == ("data", None)
    one = SH.param_pspecs(cfg, shapes, {"data": 1, "model": 1}, "train")
    assert all(s == (None, None) for s in one.values())
    ds = get_config("deepseek-v2-lite-16b")
    moe = SH.param_pspecs(ds, {"layers.1.moe.w_gate": (64, 2048, 1408)},
                          {"data": 2, "model": 4}, "train")
    assert moe["layers.1.moe.w_gate"] == ("model", "data", None)
    assert SH.placements(("model", "data", None),
                         {"data": 2, "model": 4}) == (Shard(1), Shard(0))
    assert SH.placements((("pod", "data"), None, "model"),
                         MESHES["2x2x2"]) == (Shard(0), Shard(0), Shard(2))
    assert SH.placements((None,), {"data": 2}) == (Replicate(),)


def test_local_slices_split_major_first():
    sizes = MESHES["2x2x2"]
    pls = SH.placements((("pod", "data"), "model"), sizes)
    seen = []
    for p in range(2):
        for d in range(2):
            for m in range(2):
                sl = SH.local_slices((8, 6), pls, sizes, (p, d, m))
                seen.append((sl[0].start, sl[1].start))
                assert sl[0].stop - sl[0].start == 2
                assert sl[0].start == 4 * p + 2 * d and sl[1].start == 3 * m
    assert len(set(seen)) == 8
    with pytest.raises(ValueError, match="split"):
        SH.local_slices((5,), (Shard(0),), {"data": 2}, (1,))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8, 16])
def test_batch_axes_equal_the_references(n, host_mesh, pod_mesh):
    assert SH.batch_axes(MESHES["2x4"], n) == JSH.batch_axes(host_mesh, n)
    assert SH.batch_axes(MESHES["2x2x2"], n) == JSH.batch_axes(pod_mesh, n)
    assert SH.batch_pspec(MESHES["2x4"], n) == \
        tuple(JSH.batch_pspec(host_mesh, n))


def test_batch_axes_fallback():
    assert SH.batch_axes(MESHES["2x4"], 8) == "data"
    assert SH.batch_axes(MESHES["2x4"], 7) is None
    assert SH.batch_axes(MESHES["2x2x2"], 8) == ("pod", "data")
    assert SH.batch_axes(MESHES["2x2x2"], 2) == "data"


@pytest.mark.parametrize("shard_length", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, mesh, shard_length,
                                          host_mesh, pod_mesh):
    """Per cache leaf name, the set of specs over the layers (the
    reference's stacked axes dropped)."""
    jcfg = jget_config(arch)
    B, T = (1, 64) if shard_length else (8, 64)
    jm = jbuild_model(jcfg)
    sds = jax.eval_shape(lambda: jm.init_cache(B, T))
    jspecs = JSH.cache_pspecs(jcfg, sds, _jmesh(mesh, host_mesh, pod_mesh),
                              shard_length=shard_length)
    want: dict = {}
    for (path, x), (_, s) in zip(
            jax.tree_util.tree_flatten_with_path(sds)[0],
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda v: isinstance(
                    v, jax.sharding.PartitionSpec))[0]):
        t = tuple(s) + (None,) * (x.ndim - len(tuple(s)))
        name = str(path[-1].key)
        want.setdefault(name, set()).add(t[-_port_ndim(name):])
    cfg = get_config(arch)
    cache = build_model(cfg).init_cache(B, T, "meta")
    got: dict = {}
    for layer, specs in zip(cache, SH.cache_pspecs(
            cfg, cache, MESHES[mesh], shard_length=shard_length)):
        for k, t in layer.items():
            assert len(specs[k]) == t.dim()
            got.setdefault(k, set()).add(specs[k])
    assert got == want


def _port_ndim(leaf: str) -> int:
    return {"pos": 2, "ckv": 3, "krope": 3, "h": 2, "state": 4}.get(
        leaf, 3 if leaf.startswith("conv") else 4)


def test_cache_specs_head_or_length_over_model():
    """kv 8 over model 4: heads shard; kv 2 over model 4: the length
    shards instead (the qwen3-on-16-way case, scaled down)."""
    cfg = get_config("qwen3-8b")
    sizes = MESHES["2x4"]
    cache = transformer.init_cache(cfg, 8, 64, "meta")
    kv = SH.cache_pspecs(cfg, cache, sizes)[0]
    assert kv["k"] == ("data", None, "model", None) == kv["v"]
    assert kv["pos"] == ("data", "model")       # no head dim: the length
    cfg2 = dataclasses.replace(cfg, num_kv_heads=2)
    kv2 = SH.cache_pspecs(cfg2, transformer.init_cache(cfg2, 8, 64, "meta"),
                          sizes)[0]
    assert kv2["k"] == ("data", "model", None, None)
    long = SH.cache_pspecs(cfg, transformer.init_cache(cfg, 1, 64, "meta"),
                           sizes, shard_length=True)[0]
    assert long["k"] == (None, "data", "model", None)


def test_rules_follow_the_mode():
    cfg = get_config("qwen3-8b")
    assert SH.rules_for(cfg, "train", MESHES["2x2x2"]).fsdp == \
        ("pod", "data")
    assert SH.rules_for(cfg, "serve") == SH.SERVE_RULES
    assert SH.rules_for(get_config("llama4-maverick-400b-a17b"),
                        "serve") == SH.SERVE_FSDP_RULES
