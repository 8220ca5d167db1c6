"""The port's dry run (``launch/mesh.py``'s stand-ins, ``launch/dryrun.py``,
``launch/op_stats.py``) against the JAX package.

  * ``input_specs`` / ``cache_specs`` of every arch x shape equal the
    reference's on its forced CPU meshes (2 x 4 and 2 x 2 x 2): shapes,
    dtypes and specs; the reference's cache leaves are scan-stacked, so
    each is compared without its leading layer dim and that dim's
    ``None``.
  * The plan's argument bytes per device of every cell on both
    production meshes (16 x 16 and 2 x 16 x 16) equal the bytes summed
    from the reference's own specs (``param_pspecs``, the optimizer's
    ``opt_state_pspecs``, ``cache_pspecs``, ``batch_axes``) over its
    abstract trees: the rules read only the axis sizes, so the
    production mesh goes in as a mapping, and no 512 devices are needed.
  * ``op_stats`` of a world-4 (gloo) decode step counts 2 all-reduces a
    layer (the row-parallel ``wo`` and ``w_down``) and, as all-gathers,
    each layer's positions plus the two sampling gathers; on one device
    its matmul FLOPs are 2 x matmul parameters x tokens plus the
    attention's 4 B Hq T D a layer, and its total is within 10 % of the
    reference ``hlo_stats.analyze`` of the same step (the two count
    elementwise work differently: XLA's fused graph against eager ops).
  * The CLI's records, skips and refusals.
"""
import dataclasses
import functools
import json
import math
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import _torch_dist  # noqa: E402
import _torch_serve_worker as W  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import SHAPES, get_config, smoke_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.weights import named_arrays  # noqa: E402

ARCHS = list_archs()
HOST = {"2x4": ((2, 4), ("data", "model")),
        "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PROD = {"single": M.production_mesh_sizes(False),
        "multi": M.production_mesh_sizes(True)}


def _jmesh(name):
    return _torch_dist.jax_cpu_mesh(*HOST[name])


def _sizes(name):
    return dict(zip(HOST[name][1], HOST[name][0]))


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def _spec(s):
    return tuple(s)


# ---------------------------------------------------------------------------
# stand-ins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(HOST))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_references(arch, shape, mesh):
    jm = _jmesh(mesh)
    want = JM.input_specs(jget_config(arch), JSHAPES[shape], jm)
    tensors, specs = M.input_specs(get_config(arch), SHAPES[shape],
                                   _sizes(mesh))
    assert list(tensors) == list(want) == list(specs)
    for k, sds in want.items():
        assert tuple(tensors[k].shape) == tuple(sds.shape), k
        assert tensors[k].device.type == "meta"
        assert _dtype(tensors[k].dtype) == str(sds.dtype), k
        got = specs[k] + (None,) * (len(sds.shape) - len(specs[k]))
        want_spec = _spec(sds.sharding.spec)
        want_spec += (None,) * (len(sds.shape) - len(want_spec))
        assert got == want_spec, k


def _leaf_name(path) -> str:
    return str(path[-1].key)


@pytest.mark.parametrize("mesh", list(HOST))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, shape, mesh):
    """Leaf by leaf: the port's per-layer leaves and the reference's
    stacked ones give the same set of (name, shape, dtype, spec) and the
    same count of layers a name."""
    jm = _jmesh(mesh)
    want_tree = JM.cache_specs(jget_config(arch), JSHAPES[shape], jm)
    want, want_n = set(), {}
    for path, sds in jax.tree_util.tree_leaves_with_path(want_tree):
        name = _leaf_name(path)
        spec = _spec(sds.sharding.spec)
        spec += (None,) * (len(sds.shape) - len(spec))
        nd = {"pos": 2, "h": 2, "state": 4, "ckv": 3, "krope": 3}.get(
            name, 3 if name.startswith("conv") else 4)
        shp, n = tuple(sds.shape), 1
        if len(shp) == nd + 1:           # scan-stacked: drop the layer dim
            assert spec[0] is None, (name, spec)
            n, shp, spec = shp[0], shp[1:], spec[1:]
        want.add((name, shp, str(sds.dtype), spec))
        want_n[name] = want_n.get(name, 0) + n
    cache, specs = M.cache_specs(get_config(arch), SHAPES[shape],
                                 _sizes(mesh))
    got, got_n = set(), {}
    for layer, lspec in zip(cache, specs):
        assert set(layer) == set(lspec)
        for name, t in layer.items():
            assert t.device.type == "meta"
            spec = lspec[name] + (None,) * (t.dim() - len(lspec[name]))
            got.add((name, tuple(t.shape), _dtype(t.dtype), spec))
            got_n[name] = got_n.get(name, 0) + 1
    assert got == want
    assert got_n == want_n


# ---------------------------------------------------------------------------
# the plan's argument bytes against the reference's specs
# ---------------------------------------------------------------------------
def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= d // math.prod(sizes.get(a, 1) for a in axes)
    return n * itemsize


def _tree_bytes(sds_tree, spec_tree, sizes) -> int:
    pairs = jax.tree.leaves(jax.tree.map(
        lambda x, s: _local_bytes(x.shape, tuple(s), sizes,
                                  x.dtype.itemsize),
        sds_tree, spec_tree, is_leaf=lambda x: hasattr(x, "shape")))
    return int(sum(pairs))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    jcfg = jget_config(arch)
    return jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))


def _boxed(obj, shape):
    """A zero-stride array of ``shape`` whose every element is ``obj``."""
    o = np.empty((), dtype=object)
    o[()] = obj
    return np.broadcast_to(o, shape)


def _ref_specs_by_port_name(arch, params, pspecs):
    """{port parameter name: (per-layer shape, the reference's spec)}:
    the reference's stacked leaves cut into the port's layers."""
    boxed = jax.tree.map(lambda x, s: _boxed(tuple(s), x.shape), params,
                         pspecs, is_leaf=lambda x: hasattr(x, "shape"))
    out = {}
    for name, arr in named_arrays(boxed, get_config(arch)).items():
        spec = arr.flat[0]
        out[name] = (tuple(arr.shape), tuple(spec[len(spec) - arr.ndim:]))
    return out


def _ref_argument_bytes(arch, shape_name, sizes) -> int:
    """The reference's trees, placed by its own rules on ``sizes``.  A
    train cell's optimizer slots are the port's per-layer ones (AdamW's m
    and v mirror each parameter; Adafactor factors each layer's matrices,
    where the reference factors its stacked groups), each placed by the
    reference's spec of its parameter."""
    jcfg, shape = jget_config(arch), JSHAPES[shape_name]
    mesh = types.SimpleNamespace(shape=sizes)   # all the rules read
    params = _ref_params(arch)
    B = shape.global_batch
    b = JSH.batch_axes(mesh, B)
    # the inputs' shapes and dtypes from the reference's stand-ins on its
    # host mesh, placed by batch_axes on this one
    inputs = JM.input_specs(jcfg, shape, _jmesh("2x4"))
    total = sum(_local_bytes(x.shape, (b,), sizes, x.dtype.itemsize)
                for x in inputs.values())
    if shape.kind == "train":
        pspecs = JSH.param_pspecs(jcfg, params, mesh, "train")
        total += _tree_bytes(params, pspecs, sizes)
        by_name = _ref_specs_by_port_name(arch, params, pspecs)
        slots = 0
        for shp, spec in by_name.values():
            if jcfg.optimizer == "adamw":
                slots += 2 * _local_bytes(shp, spec, sizes, 4)
            elif len(shp) >= 2:
                slots += _local_bytes(shp[:-1], spec[:-1], sizes, 4)
                slots += _local_bytes(shp[:-2] + shp[-1:],
                                      spec[:-2] + spec[-1:], sizes, 4)
            else:
                slots += _local_bytes(shp, spec, sizes, 4)
        return total + slots + 2 * 4       # + the two int32 step counters
    pspecs = JSH.param_pspecs(jcfg, params, mesh, "serve")
    total += _tree_bytes(params, pspecs, sizes)
    # the decode step's active mask / the prefill's valid counts
    total += _local_bytes((B,), (b,), sizes, 1 if shape.kind == "decode"
                          else 4)
    model = jbuild_model(jcfg)
    cache = jax.eval_shape(lambda: model.init_cache(B, shape.seq_len))
    cspecs = JSH.cache_pspecs(jcfg, cache, mesh, shard_length=(B == 1))
    return total + _tree_bytes(cache, cspecs, sizes)


@pytest.mark.parametrize("mesh", list(PROD))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_argument_bytes_equal_the_references(arch, shape, mesh):
    got = D.plan_memory(get_config(arch), SHAPES[shape], PROD[mesh])
    assert got["argument_bytes"] == _ref_argument_bytes(arch, shape,
                                                        PROD[mesh])


def test_llama4_does_not_fit_four_cards_and_its_plan_states_its_bytes():
    """400.71 B parameters: 801 GB in bf16 against 4 x 80 GB; one pod's
    plan of its decode_32k cell gives its bytes per device."""
    from repro_torch.configs import param_count
    cfg = get_config("llama4-maverick-400b-a17b")
    n = param_count(cfg)
    assert 400e9 < n < 401e9 and 2 * n > 4 * 80e9
    m = D.plan_memory(cfg, SHAPES["decode_32k"], PROD["single"])
    assert m["argument_bytes"] > m["argument_bytes_bf16"] > m["cache_bytes"]
    assert m["param_bytes"] == 2 * m["param_bytes_bf16"]


# ---------------------------------------------------------------------------
# op_stats
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world4_stats(tmp_path_factory):
    out = tmp_path_factory.mktemp("opstats")
    res = _torch_dist.run_ranks(4, [sys.executable, W.__file__, "opstats",
                                    str(out)])
    bad = [(r, rc, o) for r, (rc, o) in enumerate(res) if rc != 0]
    assert not bad, f"rank {bad[0][0]} exited {bad[0][1]}:\n{bad[0][2][-6000:]}"
    stats = []
    for r in range(4):
        with open(out / f"opstats_r{r}.json") as f:
            stats.append(json.load(f))
    return stats


def test_world4_decode_step_counts_two_all_reduces_a_layer(world4_stats):
    for r, s in enumerate(world4_stats):
        L = s["layers"]
        # heads over model: wo and w_down row-parallel; the smoke
        # vocabulary (257) does not split, so the embedding is whole
        assert s["all-reduce_count"] == 2 * L, r
        # each layer's positions (their length over model), the
        # vocabulary argmax and the token rows
        assert s["all-gather_count"] == L + 2, r
        for c in ("reduce-scatter", "all-to-all", "collective-permute"):
            assert s[c + "_count"] == 0, (r, c)
        assert s["collective_bytes"] == s["all-reduce"] + s["all-gather"]
        # 8 rows x d 64 fp32 per all-reduce
        assert s["all-reduce"] == 2 * L * 8 * 64 * 4, r


def test_one_device_matmul_flops_and_the_references_total():
    import jax.numpy as jnp
    from repro.configs import smoke_config as jsmoke
    from repro.launch.hlo_stats import analyze as hlo_analyze
    from repro.serving.serve_step import build_serve_fns as jserve_fns
    from repro_torch.configs import smoke_config
    from repro_torch.launch import op_stats
    from repro_torch.serving.serve_step import build_serve_fns
    from repro_torch.weights import params_from_jax
    B, T = 8, 64
    jcfg = dataclasses.replace(jsmoke("qwen3-8b"), dtype="float32",
                               attn_impl="chunked")
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                              attn_impl="chunked")
    jp = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    jf = jserve_fns(jcfg, None, batch=B, max_len=T, donate=False)
    args = (jnp.ones(B, jnp.int32), jnp.full(B, 10, jnp.int32),
            jnp.ones(B, bool))
    ref = hlo_analyze(jf.decode.lower(jp, jf.init_cache(), *args)
                      .compile().as_text())
    fns = build_serve_fns(cfg, batch=B, max_len=T, device="cpu")
    module = params_from_jax(jax.tree.map(np.asarray, jp), cfg)
    got = op_stats.analyze(fns.decode, module, fns.init_cache(),
                           *(torch.from_numpy(np.array(a)) for a in args))
    d, L = cfg.d_model, cfg.num_layers
    per_layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
                 + 3 * d * cfg.d_ff)
    mm_params = L * per_layer + cfg.vocab_size * d       # + the tied head
    attention = L * 4 * B * cfg.num_heads * T * cfg.head_dim
    assert got["matmul_flops"] == 2 * mm_params * B + attention
    assert abs(got["flops"] / ref["flops"] - 1) < 0.10
    assert got["kernels"] == {}


def test_meta_kernels_count_their_work():
    from repro_torch.kernels import ops
    from repro_torch.launch import op_stats
    q = torch.empty(2, 1, 8, 64, device="meta")
    k = torch.empty(2, 128, 2, 64, device="meta", dtype=torch.bfloat16)
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    s = op_stats.analyze(lambda: ops.decode_attention(
        q, k, k, lens, scale=0.125, return_lse=True))
    assert s["kernels"] == {"decode_attention": 1}
    assert s["flops"] == 4 * 2 * 8 * 128 * 64
    assert s["bytes"] == (2 * 2 * 128 * 2 * 64 * 2 + 2 * q.numel() * 4
                          + 2 * 4 + 2 * 8 * 4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _cli(tmp_path, *args):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out-dir", str(tmp_path)],
                       capture_output=True, text=True, timeout=600)
    return r.returncode, r.stdout + r.stderr


def test_cli_plans_one_decode_cell(tmp_path):
    rc, out = _cli(tmp_path, "--arch", "qwen3-8b", "--shape", "decode_32k",
                   "--mesh", "single")
    assert rc == 0, out
    assert "[ ok ] qwen3-8b x decode_32k x singlepod" in out
    rec = json.loads((tmp_path / "qwen3-8b__decode_32k__singlepod.json")
                     .read_text())
    assert rec["devices"] == 256
    assert rec["memory"]["argument_bytes"] == D.plan_memory(
        get_config("qwen3-8b"), SHAPES["decode_32k"],
        PROD["single"])["argument_bytes"]
    col = rec["collectives"]
    # kv heads 8 on model 16: the cache's length goes over model; 36
    # layers of wo and w_down, and the vocabulary-parallel embedding
    assert col["all-reduce"]["count"] == 2 * 36 + 1
    assert rec["cost"]["flops"] > 0 and rec["memory"]["temp_bytes"] > 0


def test_cli_skips_with_reasons_and_keeps_the_memory(tmp_path):
    rc, out = _cli(tmp_path, "--arch", "gemma-7b", "--shape",
                   "long_500k", "--mesh", "single")
    assert rc == 0, out
    assert "[skip] gemma-7b x long_500k x singlepod" in out
    rec = json.loads((tmp_path / "gemma-7b__long_500k__singlepod.json")
                     .read_text())
    assert "full-attention" in rec["skipped"] \
        and rec["memory"]["argument_bytes"] > 0
    rec = D.run_cell("qwen3-8b", "long_500k", False, save=False)
    assert "skipped" in rec and rec["memory"]["cache_bytes"] > 0


def test_cli_plans_a_smoke_ssd_serve_cell_on_a_model_axis(tmp_path):
    """The Mamba2 smoke config's decode cell on a (2, 4) mesh plans
    ``[ ok ]``: the SSD computes on its heads (8 over model 4, the state
    over heads), its out_proj summed by one all-reduce a layer."""
    code = ("import sys\n"
            "from repro_torch.configs import smoke_config\n"
            "from repro_torch.launch import dryrun as D\n"
            "D.get_config = smoke_config\n"
            "sys.exit(D.main(['--arch', 'mamba2-370m', '--shape',\n"
            "                 'decode_32k', '--mesh-shape', '2x4',\n"
            "                 '--batch', '8', '--seq-len', '64',\n"
            "                 '--out-dir', sys.argv[1]]))\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out
    assert "[ ok ] mamba2-370m x decode_32k x 2x4" in out, out
    rec = json.loads((tmp_path / "mamba2-370m__decode_32k__2x4.json")
                     .read_text())
    cfg = smoke_config("mamba2-370m")
    assert rec["collectives"]["all-reduce"]["count"] >= cfg.num_layers
    assert rec["cost"]["flops"] > 0 and rec["memory"]["cache_bytes"] > 0


def test_cli_plans_the_smoke_train_cell_with_seq_parallel(tmp_path):
    """The Qwen3 smoke config's train cell on a (2, 4) mesh plans ``[ ok ]``
    with ``--seq-parallel`` and without it; the sequence-sharded residual
    stream holds fewer live bytes, and the arguments are the same."""
    code = ("import sys\n"
            "from repro_torch.configs import smoke_config\n"
            "from repro_torch.launch import dryrun as D\n"
            "D.get_config = smoke_config\n"
            "base = ['--arch', 'qwen3-8b', '--shape', 'train_4k',\n"
            "        '--mesh-shape', '2x4', '--batch', '8', '--seq-len',\n"
            "        '64', '--out-dir', sys.argv[1]]\n"
            "sys.exit(D.main(base) | D.main(base + ['--seq-parallel']))\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out
    assert out.count("[ ok ] qwen3-8b x train_4k x 2x4") == 2, out
    whole, sp = (json.loads((tmp_path / f"qwen3-8b__train_4k__2x4{s}.json")
                            .read_text()) for s in ("", "__seqpar"))
    assert (whole["seq_parallel"], sp["seq_parallel"]) == (False, True)
    assert sp["memory"]["argument_bytes"] == whole["memory"]["argument_bytes"]
    assert 0 < sp["memory"]["temp_bytes"] < whole["memory"]["temp_bytes"]
    # sequence-parallel: the row-parallel outputs reduce-scatter
    assert sp["collectives"]["reduce-scatter"]["count"] > 0
