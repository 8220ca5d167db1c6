"""Sharding rules: parameter, batch and cache placements over a mesh.

Mesh axes (``launch/mesh.py``):
  * ``data``  — the batch axis; doubles as the FSDP/ZeRO-3 axis in training.
  * ``model`` — the TP/EP axis (heads, d_ff hidden, vocab, experts).
  * ``pod``   — an optional leading axis: more batch (default) or the
    pipeline axis (``distributed/pipeline.py``).

The rules are the JAX package's table, unchanged: each parameter is
matched by the suffix of its name (``layers.3.mixer.wq`` is read as
``layers/3/mixer/wq``) to a template over its trailing dims.  The port's
layers are not stacked, so the JAX package's leading ``None`` for a
scan-stacked group has no counterpart here; the other dims agree.  An
axis applies only where the dim divides by the axis size and the axis
is larger than 1; otherwise that dim is replicated (whisper's 20 heads
over model=16), and a mesh axis shards at most one dim of a tensor.

A spec is one entry per tensor dim, as in ``jax.sharding.PartitionSpec``:
None, an axis name, or a tuple of axis names (major first).
``placements(spec, mesh)`` turns it into DTensor placements, one per mesh
dim.  A mesh is a ``DeviceMesh`` or an ordered mapping of axis name to
size (``{"data": 2, "model": 4}``), so the rules run without any rank.

Serving drops the FSDP ``data`` axis from the weights (pure TP) unless
the config opts in with ``serve_keep_fsdp``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig

# logical axis names used in rule templates
FSDP = "fsdp"      # -> "data" (train) / dropped (serve, unless keep_fsdp)
TP = "tp"          # -> "model"
EP = "ep"          # -> "model" (experts); "data" when serve_keep_fsdp moe

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved mapping logical axis -> mesh axis (or None)."""
    fsdp: Union[None, str, Tuple[str, ...]] = "data"
    tp: Optional[str] = "model"
    ep: Optional[str] = "model"

    def resolve(self, logical: Optional[str]):
        if logical is None:
            return None
        return {FSDP: self.fsdp, TP: self.tp, EP: self.ep}[logical]


TRAIN_RULES = ShardingRules(fsdp="data", tp="model", ep="model")
SERVE_RULES = ShardingRules(fsdp=None, tp="model", ep="model")
# llama4-400B serving: experts sharded over data, expert hidden over model.
SERVE_FSDP_RULES = ShardingRules(fsdp=None, tp="model", ep="data")


# ---------------------------------------------------------------------------
# rule table: ordered (name-regex, template over trailing dims); first match
# wins.  Names are "/"-joined, as "layers/0/mixer/wq" or "layers/1/moe/w_down".
# ---------------------------------------------------------------------------
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # --- embeddings / head ---------------------------------------------------
    # the embedding's d dim stays unsharded: an FSDP entry there shards the
    # lookup's output over the batch axis
    (r"(^|/)embed$",                 (TP, None)),     # (vocab, d)
    (r"(^|/)lm_head$",               (None, TP)),     # (d, vocab)
    # --- MoE (before generic mlp names; expert weights are rank-3) ----------
    (r"moe/router$",                 (FSDP, None)),   # (d, E)
    (r"moe/shared/w_(gate|up)$",     (FSDP, TP)),
    (r"moe/shared/w_down$",          (TP, FSDP)),
    (r"moe/w_(gate|up)$",            (EP, FSDP, TP)),  # (E, d, f)
    (r"moe/w_down$",                 (EP, TP, FSDP)),  # (E, f, d)
    # --- MLA -----------------------------------------------------------------
    (r"mixer/w_dkv$",                (FSDP, None)),   # (d, rank+rope)
    (r"mixer/w_u[kv]$",              (None, TP)),     # (rank, H*hd)
    (r"mixer/kv_norm$",              (None,)),
    # --- attention (also matches encdec "cross/") ----------------------------
    (r"(mixer|cross)/w[qkv]$",       (FSDP, TP)),     # (d, proj)
    (r"(mixer|cross)/wo$",           (TP, FSDP)),     # (proj, d)
    (r"mixer/b[qkv]$",               (TP,)),
    (r"mixer/[qk]_norm$",            (None,)),
    # --- SSD (mamba2) ---------------------------------------------------------
    (r"mixer/w_[zx]$",               (FSDP, TP)),     # (d, d_in)
    (r"mixer/w_[BC]$",               (FSDP, None)),   # (d, G*N) small
    (r"mixer/w_dt$",                 (FSDP, TP)),     # (d, H)
    (r"mixer/conv_x_w$",             (None, TP)),
    (r"mixer/conv_x_b$",             (TP,)),
    (r"mixer/conv_[BC]_[wb]$",       (None, None)),
    (r"mixer/(A_log|D|dt_bias)$",    (TP,)),
    (r"mixer/gate_norm$",            (TP,)),
    (r"mixer/out_proj$",             (TP, FSDP)),     # (d_in, d)
    # --- RG-LRU ----------------------------------------------------------------
    (r"mixer/w_gate$",               (FSDP, TP)),     # (d, w)
    (r"mixer/w_x$",                  (FSDP, TP)),
    (r"mixer/conv_w$",               (None, TP)),
    (r"mixer/conv_b$",               (TP,)),
    (r"mixer/(lambda_|[ai]_gate_[wb])$", (TP,)),
    (r"mixer/w_out$",                (TP, FSDP)),     # (w, d)
    # --- dense MLP --------------------------------------------------------------
    (r"mlp/w_(gate|up)$",            (FSDP, TP)),     # (d, f)
    (r"mlp/w_down$",                 (TP, FSDP)),     # (f, d)
    # --- norms & everything small ------------------------------------------------
    (r"norm",                        (None,)),
    (r".",                           ()),             # default: replicate
)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order, for a ``DeviceMesh`` or a
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(sizes: Mapping[str, int], name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= sizes.get(a, 1)
        return n
    return sizes.get(name, 1)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x) if isinstance(x, (tuple, list)) else tuple(x.shape)


def _spec_for_leaf(path_s: str, shape: Tuple[int, ...],
                   sizes: Mapping[str, int], rules: ShardingRules) -> Spec:
    for pat, template in _PARAM_RULES:
        if re.search(pat, path_s):
            tmpl = template
            break
    else:  # pragma: no cover — the last rule always matches
        tmpl = ()
    ndim = len(shape)
    k = min(len(tmpl), ndim)
    trailing = tmpl[len(tmpl) - k:] if k else ()
    spec: list = [None] * (ndim - k)
    used: set = set()
    for dim_size, logical in zip(shape[ndim - k:], trailing):
        axis = rules.resolve(logical)
        members = (set(axis) if isinstance(axis, tuple)
                   else {axis} if axis else set())
        # first wins: a mesh axis shards at most one dim (MoE (E, d, f) in
        # train: EP takes 'model', so TP on f degrades to None)
        if axis is not None and not (members & used) \
                and dim_size % _axis_size(sizes, axis) == 0 \
                and _axis_size(sizes, axis) > 1:
            if isinstance(axis, tuple):   # drop components absent here
                axis = tuple(a for a in axis if sizes.get(a, 1) > 1)
                axis = axis if len(axis) > 1 else (axis[0] if axis else None)
            spec.append(axis)
            used |= members
        else:
            spec.append(None)
    return tuple(spec)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def rules_for(cfg: ModelConfig, mode: str, mesh=None) -> ShardingRules:
    if mode == "train":
        # several pods: FSDP spans (pod, data), so parameters and gradients
        # shard over every batch rank, not only within one pod
        if mesh is not None and mesh_sizes(mesh).get("pod", 1) > 1:
            return ShardingRules(fsdp=("pod", "data"), tp="model",
                                 ep="model")
        return TRAIN_RULES
    if cfg.serve_keep_fsdp:
        return SERVE_FSDP_RULES
    return SERVE_RULES


def _named_shapes(params) -> Dict[str, Tuple[int, ...]]:
    items = (params.named_parameters() if hasattr(params, "named_parameters")
             else params.items())
    return {n: _shape(x) for n, x in items}


def param_pspecs(cfg: ModelConfig, params, mesh,
                 mode: str = "train") -> Dict[str, Spec]:
    """{parameter name: spec}.  ``params``: a module, or a mapping of
    name to a tensor or a shape."""
    sizes = mesh_sizes(mesh)
    rules = rules_for(cfg, mode, sizes)
    return {n: _spec_for_leaf(n.replace(".", "/"), s, sizes, rules)
            for n, s in _named_shapes(params).items()}


def placements(spec: Sequence[Entry], mesh) -> tuple:
    """DTensor placements (one per mesh dim) for a spec.  A dim sharded
    over a tuple of axes takes each of them, major first, as a
    ``PartitionSpec`` entry does."""
    out = []
    for axis in mesh_sizes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_placements(cfg: ModelConfig, params, mesh,
                     mode: str = "train") -> Dict[str, tuple]:
    """{parameter name: DTensor placements} under the ``mode`` rules."""
    return {n: placements(s, mesh)
            for n, s in param_pspecs(cfg, params, mesh, mode).items()}


def local_slices(shape: Sequence[int], placements_: Sequence, mesh,
                 coord: Sequence[int]) -> Tuple[slice, ...]:
    """The global slice that the rank at mesh coordinate ``coord`` holds
    (even splits; the rules only shard divisible dims)."""
    sizes = list(mesh_sizes(mesh).values())
    ndim = len(shape)
    start, length = [0] * ndim, list(shape)
    for size, c, pl in zip(sizes, coord, placements_):
        if isinstance(pl, Shard) and size > 1:
            d = pl.dim % ndim
            if length[d] % size:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"{size} ways")
            length[d] //= size
            start[d] += c * length[d]
    return tuple(slice(a, a + n) for a, n in zip(start, length))


def local_shape(shape: Sequence[int], spec: Sequence[Entry], mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` placed by
    ``spec`` (even splits)."""
    sizes = mesh_sizes(mesh)
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = _axis_size(sizes, e)
        if d % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"{n} ways")
        out.append(d // n)
    return tuple(out)


def batch_axes(mesh, n: Optional[int] = None):
    """Dim-0 entry for batch sharding: 'data', ('pod', 'data'), or None.

    Given ``n``, the first candidate whose size divides it wins:
    ('pod', 'data'), then 'data', then 'pod', then None."""
    sizes = mesh_sizes(mesh)
    for c in (("pod", "data"), ("data",), ("pod",)):
        axes = tuple(a for a in c if _axis_size(sizes, a) > 1)
        if not axes:
            continue
        if n is None or n % _axis_size(sizes, axes) == 0:
            return axes if len(axes) > 1 else axes[0]
    return None


def batch_pspec(mesh, n: Optional[int] = None) -> Spec:
    return (batch_axes(mesh, n),)


# ---------------------------------------------------------------------------
# cache placement (serving): batch over data; kv-heads or length over model
# ---------------------------------------------------------------------------
def _cache_leaf(last: str, shape: Tuple[int, ...], sizes: Mapping[str, int],
                shard_length: bool) -> Spec:
    data = "data" if _axis_size(sizes, "data") > 1 else None
    model = "model" if _axis_size(sizes, "model") > 1 else None
    nd = len(shape)
    spec: list = [None] * nd
    tdim = hdim = None
    if last == "pos":
        bdim, tdim = nd - 2, nd - 1
    elif last.startswith("conv"):
        bdim = nd - 3
    elif last == "state":
        bdim, hdim = nd - 4, nd - 3
    elif last in ("ckv", "krope"):
        bdim, tdim = nd - 3, nd - 2
    elif last == "h":
        bdim = nd - 2
    else:  # k / v / xk / xv
        bdim, tdim, hdim = nd - 4, nd - 3, nd - 2
    bdim = max(bdim, 0)

    def fits(dim, axis):
        return (dim is not None and axis is not None
                and shape[dim] % _axis_size(sizes, axis) == 0)

    if not shard_length and fits(bdim, data):
        spec[bdim] = data
    elif shard_length and fits(tdim, data):
        spec[tdim] = data
    if fits(hdim, model):
        spec[hdim] = model
    elif tdim is not None and spec[tdim] is None and fits(tdim, model):
        spec[tdim] = model
    return tuple(spec)


def cache_pspecs(cfg: ModelConfig, cache: Any, mesh,
                 shard_length: bool = False) -> Any:
    """Cache placement, with the cache's own structure (a list of per-layer
    dicts).

    The batch (slot) dim goes over ``data``; kv-heads over ``model`` when
    they divide, else the length dim over ``model`` (GQA kv=8 on a 16-way
    TP axis shards the context instead).  ``shard_length`` (batch 1): the
    length over ``data`` too.  Leaves are (B,T,H,D) k/v/xk/xv, (B,T,r)
    ckv/krope, (B,T) pos, (B,W-1,C) conv, (B,H,P,N) ssd state, (B,W)
    rglru h; each is keyed by its name."""
    sizes = mesh_sizes(mesh)

    def walk(node, last):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, last) for v in node)
        return _cache_leaf(last, _shape(node), sizes, shard_length)

    return walk(cache, "")
