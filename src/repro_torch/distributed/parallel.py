"""The sharded train step's collectives: tensor-parallel compute with
gradients, the sequence-parallel residual stream, row gathers, the
vocab-parallel loss, and the optimizer's reductions over shards.

The mesh branch of ``training/trainer.py`` keeps parameters and optimizer
slots as DTensors placed by ``sharding.param_placements`` (ZeRO-3 over
``data``, TP dims over ``model``).  A step gathers each sharded
parameter over its FSDP axes only and keeps this rank's ``model`` slice
as the compute weight of the blocks computed tensor-parallel, splits the
batch over the batch axes (``pod``/``data``), and runs the blocks as XLA's
SPMD partitioner runs the JAX package's: the attention's ``wq`` / ``wk``
/ ``wv`` column-parallel and ``wo`` row-parallel (flash on the local
heads), the MLP's and the MoE shared experts' ``w_gate`` / ``w_up``
column-parallel and ``w_down`` row-parallel, E / ``model`` routed experts
a rank, the embedding's vocabulary rows, and the LM head's vocabulary
columns, whose loss's log-sum-exp and label logit are all-reduced over
``model``; MLA on its local heads (``wq``, ``w_uk``, ``w_uv`` column- and
``wo`` row-parallel), the SSD mixer on its local heads and the RG-LRU on
its local channels (their projections, convs and gates on the slice,
``out_proj`` / ``w_out`` row-parallel; the SSD's gated norm sums its
squares over ``model`` with ``model_sum``), and the encoder-decoder's
self-attention, cross-attention and MLPs as the decoder's.  A block
enters through ``block_in`` (``copy_to_model``: identity forward,
all-reduce of the gradient over ``model``) and leaves through
``block_out`` (``reduce_from_model``: all-reduce forward, identity
backward).  A block whose weights do not split as it reads them (query
heads that do not divide ``model``) keeps them gathered whole and
computes whole on every model rank.

With ``seq_parallel`` the residual stream between blocks is (B, S/model,
d): the norms and the residual adds run on this rank's positions,
``gather_seq`` (all-gather on the sequence, reduce-scatter of the
gradient) replaces ``copy_to_model`` and ``scatter_seq`` (reduce-scatter,
all-gather of the gradient) replaces ``reduce_from_model``; a block
computed whole gathers the sequence before (its gradient sliced back) and
keeps this rank's positions after (their gradient gathered), and the
sequence is gathered once more for the LM head.  Where S does not divide
by ``model`` the stream stays whole, as the JAX package's ``constrain``
drops an axis that does not divide.

The gradient rule is in ``ActivationMesh``'s docstring.  The MoE block
gathers the rows of the whole microbatch across the batch group before it
routes, so the capacity groups and the load-balancing loss are the
unsharded ones.

Serving computes on the shards themselves (``ServeLayout``, set with
``serve_layout`` by the mesh branch of ``serving/serve_step.py``): each
rank holds its slices of the weights (placed by the serve rules) and of
the cache, and the same layer code computes on them, reading what is
sharded from the local shapes: column-parallel projections, row-parallel
outputs summed by one all-reduce over ``model``, attention over the local
heads or the local length (merged by log-sum-exp), the experts of this
rank, the LM head's vocabulary slice and a greedy argmax across the
slices.  The recurrent mixers' conv windows and RG-LRU's ``h`` are whole
on every model rank (the cache rule keeps them off ``model``): a rank
reads its channels of them and gathers the new ones over ``model``.
Serving runs under ``torch.no_grad``, so its collectives have no
backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Dict, Iterator, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.training.optimizer import Reducer, Tensors


# ---------------------------------------------------------------------------
# the active activation mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ActivationMesh:
    """How the current microbatch is laid out over the ranks.

    ``rows_group`` (size ``rows``): the ranks that hold the other rows of
    the microbatch, in row order (None when this rank holds all rows).
    ``model_group`` (size ``model``, this rank ``model_rank``): the ranks
    that split the blocks' heads, hidden dims, experts and vocabulary;
    ``vocab_group`` / ``vocab_slice``: the same group and this rank's
    vocabulary slice when ``model`` > 1, else None.  ``seq``: the
    residual stream between blocks holds this rank's S / model positions.

    The gradient rule.  The loss of a microbatch is the sum over its row
    blocks of their cross-entropy sums over the microbatch's token count,
    plus the MoE term; no rank scales its share.  Every collective has its
    adjoint as its backward, so after ``backward`` the gradient of every
    activation that is whole on the model ranks is the same full gradient
    on each of them.  A parameter's gradient is then one of two kinds:
      * complete over ``model``: a ``model`` slice (a TP weight), or a
        whole weight used on whole activations (the norms without
        ``seq``, a block computed whole) -- the model ranks hold
        the same full gradient of what they hold, so it is summed over
        the batch group only, never counted ``model`` times;
      * partial over ``model`` (its id in ``partial``, marked by the code
        that uses it so): a whole weight used on this rank's part of the
        work -- ``q_norm`` / ``k_norm`` on the local heads, MLA's
        ``w_dkv`` / ``kv_norm`` and the SSD's ``w_B`` / ``w_C`` and their
        convs feeding the local heads, the router of
        experts split over ``model``, the norms on the positions of a
        ``seq`` shard, a whole embedding or head on this rank's
        vocabulary slice -- summed over the batch group and ``model``.
    The load-balancing loss is computed whole on every rank that sums its
    router's gradient, so its gradient is scaled by one over their number
    (``scale_grad``) where it is made."""
    rows_group: Optional[dist.ProcessGroup] = None
    rows: int = 1
    vocab_group: Optional[dist.ProcessGroup] = None
    vocab_slice: Optional[slice] = None
    model_group: Optional[dist.ProcessGroup] = None
    model: int = 1
    model_rank: int = 0
    seq: bool = False
    partial: Set[int] = dataclasses.field(default_factory=set)

    def gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel output (..., cols / model) -> (..., cols) in
        rank order; the gradient of this rank's columns sums every
        rank's."""
        return _AllGather.apply(x, -1, self.model_group, self.model)


_ACT: Optional[ActivationMesh] = None


def current() -> Optional[ActivationMesh]:
    return _ACT


@contextlib.contextmanager
def activation_mesh(act: Optional[ActivationMesh]) -> Iterator[None]:
    """Make ``act`` the active layout for the forward and backward run
    inside (the backward reruns remat'd layers, so it goes inside too)."""
    global _ACT
    prev, _ACT = _ACT, act
    try:
        yield
    finally:
        _ACT = prev


def _model_act() -> Optional[ActivationMesh]:
    act = _ACT
    return act if act is not None and act.model > 1 else None


def seq_sharded() -> bool:
    """Whether the residual stream holds this rank's positions only."""
    return _ACT is not None and _ACT.seq


def mark_partial(*weights) -> None:
    """Record that these whole weights compute on this rank's part of the
    work, so their gradient sums over ``model`` too (a no-op outside a
    sharded train step)."""
    if _ACT is not None:
        _ACT.partial.update(id(w) for w in weights)


def sums_over_model(act: ActivationMesh, weight: torch.Tensor) -> bool:
    """Whether ``weight``'s gradient is partial over ``model`` (marked),
    so the trainer sums it over ``model`` as well as the batch group."""
    return id(weight) in act.partial


# ---------------------------------------------------------------------------
# collectives with their adjoints as gradients
# ---------------------------------------------------------------------------
def _gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's part of the sum, summed in fp32 (a bf16 partial is
    rounded once more, not once a rank)."""
    parts = list(x.float().chunk(n, dim=dim))
    out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
    _reduce_scatter(out, parts, group)
    return out.to(x.dtype)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce of x into a new tensor, summed in fp32."""
    y = x.float()
    y = y.clone() if y is x else y
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _own(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _AllGather(torch.autograd.Function):
    """All-gather on ``dim`` forward, reduce-scatter backward."""
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter on ``dim`` forward, all-gather backward."""
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _GatherWhole(torch.autograd.Function):
    """All-gather on ``dim`` forward; the gradient, the same on every
    rank, is sliced back to this rank's part."""
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _own(g, *ctx.args), None, None, None


class _Split(torch.autograd.Function):
    """This rank's part of a tensor whole on every rank; the gradient is
    every rank's part gathered."""
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return _own(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward."""
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def copy_to_model(x: torch.Tensor, act: ActivationMesh) -> torch.Tensor:
    return _CopyToModel.apply(x, act.model_group)


def reduce_from_model(x: torch.Tensor, act: ActivationMesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, act.model_group)


def gather_seq(x: torch.Tensor, act: ActivationMesh) -> torch.Tensor:
    """(B, S / model, ...) -> (B, S, ...); reduce-scatter backward."""
    return _AllGather.apply(x, 1, act.model_group, act.model)


def scatter_seq(x: torch.Tensor, act: ActivationMesh) -> torch.Tensor:
    """(B, S, ...) partial sums -> this rank's (B, S / model, ...) of
    their sum; all-gather backward."""
    return _ReduceScatter.apply(x, 1, act.model_group, act.model)


def scale_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """x forward; its gradient times ``s`` backward."""
    return x if s == 1.0 else _ScaleGrad.apply(x, s)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ``model`` ranks of their parts x (a norm's sum
    of squares over channels split over ``model``): serving's all-reduce
    (in place); in a sharded train step an all-reduce whose gradient is
    all-reduced too, as every rank's use of the sum feeds each part
    (``copy_to_model`` after ``reduce_from_model`` backward); x itself
    elsewhere."""
    if _SERVE is not None:
        return _SERVE.all_reduce_model(x)
    act = _model_act()
    if act is None:
        return x
    return reduce_from_model(copy_to_model(x, act), act)


def partial_dtype(dt: torch.dtype) -> torch.dtype:
    """The dtype of a rank's partial sum of a contraction split over
    ``model`` (a row-parallel product, the experts' combine): fp32 in a
    sharded train step, so the sum over ``model`` is rounded once, as
    the whole product is (a split-K product); ``dt`` elsewhere."""
    return torch.float32 if _model_act() is not None else dt


def block_in(x: torch.Tensor, split: bool) -> torch.Tensor:
    """A block's input from the residual stream.  ``split``: the block
    computes on ``model`` slices (training: ``copy_to_model``, or
    ``gather_seq`` under ``seq``); else, under ``seq``, the whole
    sequence for a block computed whole.  Serving and one device pass x
    through."""
    act = None if _SERVE is not None else _model_act()
    if act is None:
        return x
    if act.seq:
        return gather_seq(x, act) if split else _GatherWhole.apply(
            x, 1, act.model_group, act.model)
    return copy_to_model(x, act) if split else x


def block_out(y: torch.Tensor, split: bool,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A block's output back to the residual stream, in ``dtype`` (y's
    by default): the sum of the ``model`` ranks' partial outputs when
    ``split`` (serving: one all-reduce; training: ``reduce_from_model``,
    or ``scatter_seq`` under ``seq``); else, under ``seq``, this rank's
    positions of a whole output."""
    if _SERVE is not None:
        y = _SERVE.all_reduce_model(y) if split else y
    elif (act := _model_act()) is not None:
        if act.seq:
            y = scatter_seq(y, act) if split else _Split.apply(
                y, 1, act.model_group, act.model)
        elif split:
            y = reduce_from_model(y, act)
    return y if dtype is None else y.to(dtype)


# ---------------------------------------------------------------------------
# rows: all-gather forward, reduce-scatter backward
# ---------------------------------------------------------------------------
def _reduce_scatter(out: torch.Tensor, parts, group) -> None:
    """out = sum over ranks of their ``parts[rank]`` (gloo has no
    reduce_scatter: an all-reduce of the stacked parts there)."""
    if dist.get_backend(group) != "gloo":
        dist.reduce_scatter(out, [p.contiguous() for p in parts],
                            group=group)
        return
    full = torch.stack(parts)
    dist.all_reduce(full, group=group)
    out.copy_(full[dist.get_rank(group)])


def gather_rows(x: torch.Tensor, act: ActivationMesh) -> torch.Tensor:
    """(B, ...) local rows -> (rows * B, ...) rows of the whole microbatch;
    the gradient of this rank's rows sums every rank's."""
    if act.rows_group is None:
        return x
    return _AllGather.apply(x, 0, act.rows_group, act.rows)


def local_rows(y: torch.Tensor, act: ActivationMesh) -> torch.Tensor:
    if act.rows_group is None:
        return y
    b = y.shape[0] // act.rows
    r = dist.get_rank(act.rows_group)
    return y[r * b:(r + 1) * b]


# ---------------------------------------------------------------------------
# vocab-parallel log-sum-exp and label logit
# ---------------------------------------------------------------------------
def vocab_split(vocab: int, n: int, k: int) -> slice:
    """The k-th of n contiguous vocabulary slices (the first vocab % n
    one longer), so any vocabulary splits."""
    base, extra = divmod(vocab, n)
    lo = k * base + min(k, extra)
    return slice(lo, lo + base + (1 if k < extra else 0))


class _VocabParallelLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        V = logits.shape[-1]
        m = logits.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - m[..., None])
        s = e.sum(dim=-1)
        dist.all_reduce(s, group=group)
        lse = m + torch.log(s)
        idx = labels.long() - lo
        inside = (idx >= 0) & (idx < V)
        idx = torch.clamp(idx, 0, V - 1)
        lab = torch.gather(logits, -1, idx[..., None])[..., 0] * inside
        dist.all_reduce(lab, group=group)
        ctx.save_for_backward(e.div_(s[..., None]), idx, inside)
        return lse, lab

    @staticmethod
    def backward(ctx, dlse, dlab):
        probs, idx, inside = ctx.saved_tensors
        g = probs * dlse[..., None]
        g.scatter_add_(-1, idx[..., None], (dlab * inside)[..., None])
        return g, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 act: ActivationMesh, z_loss: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``trainer.cross_entropy`` on this rank's vocabulary slice of the
    logits: (summed loss over the rows, token count).  The gradient
    reaches only this slice's logits; the model ranks' shares add up."""
    mask = labels >= 0
    lse, lab = _VocabParallelLSE.apply(
        logits, torch.clamp(labels, min=0), act.vocab_slice.start,
        act.vocab_group)
    nll = (lse - lab) + z_loss * torch.square(lse)
    nll = torch.where(mask, nll, 0.0)
    return torch.sum(nll), torch.sum(mask)


# ---------------------------------------------------------------------------
# process groups over several mesh dims
# ---------------------------------------------------------------------------
def subgroup(mesh, axes: Sequence[str]):
    """(group, size) of the ranks that differ from this one only along
    ``axes``, ordered by their coordinates there (the first axis major).
    Every rank must call it with the same ``axes``."""
    names = list(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0]), mesh.size(names.index(axes[0]))
    ranks = mesh.mesh
    order = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in order]
    grid = ranks.permute(rest + order).reshape(
        [ranks.shape[i] for i in rest] + [-1])
    mine = None
    me = dist.get_rank()
    for idx in itertools.product(*(range(ranks.shape[i]) for i in rest)):
        members = grid[idx].tolist()
        g = dist.new_group(members)
        if me in members:
            mine = g
    return mine, grid.shape[-1]


# ---------------------------------------------------------------------------
# the optimizer's reductions over shards
# ---------------------------------------------------------------------------
class ShardReducer(Reducer):
    """The optimizer's reductions when each rank holds slices of the
    tensors.  ``layout``: {name: (placements, parameter ndim)}.  A
    reduction along a parameter dim sums the local part, all-reduces it
    over each mesh dim that shards that dim and divides by the global
    length; a dim no mesh dim shards keeps the plain reduction.  The
    global norm sums every rank's squares, each over the number of ranks
    that hold the same slice."""

    def __init__(self, mesh, layout: Dict[str, Tuple[tuple, int]]):
        self.layout = layout
        self.groups = [mesh.get_group(i) for i in range(mesh.ndim)]
        self.sizes = list(mesh.mesh.shape)

    def _mesh_dims(self, name: str, pdim: Optional[int]):
        pls, ndim = self.layout[name]
        return [i for i, pl in enumerate(pls)
                if isinstance(pl, Shard) and self.sizes[i] > 1
                and (pdim is None or pl.dim % ndim == pdim % ndim)]

    def _replicas(self, name: str) -> int:
        n = 1
        for i, pl in enumerate(self.layout[name][0]):
            if not isinstance(pl, Shard):
                n *= self.sizes[i]
        return n

    def _sum_over(self, s: torch.Tensor, mesh_dims) -> torch.Tensor:
        for i in mesh_dims:
            dist.all_reduce(s, group=self.groups[i])
        return s

    def global_norm(self, tensors: Tensors) -> torch.Tensor:
        leaves = [torch.sum(torch.square(x.float())) / self._replicas(n)
                  for n, x in tensors.items()]
        total = torch.sum(torch.stack(leaves))
        dist.all_reduce(total)
        return torch.sqrt(total)

    def mean(self, name, x, dim, pdim, keepdim=False):
        dims = self._mesh_dims(name, pdim)
        if not dims:
            return x.mean(dim, keepdim=keepdim)
        n = x.shape[dim]
        for i in dims:
            n *= self.sizes[i]
        return self._sum_over(x.sum(dim, keepdim=keepdim), dims) / n

    def mean_all(self, name, x):
        dims = self._mesh_dims(name, None)
        if not dims:
            return torch.mean(x)
        n = x.numel()
        for i in dims:
            n *= self.sizes[i]
        return self._sum_over(x.sum(), dims) / n


# ---------------------------------------------------------------------------
# serving: compute on the local shards
# ---------------------------------------------------------------------------
NEG_INF = -1.0e30


class ServeLayout:
    """The serving step's layout over a mesh.

    ``mesh``: the ``DeviceMesh``; ``batch`` / ``max_len``: the global
    cache shape; ``shard_length``: the cache's length goes over ``data``
    (batch 1); ``ep``: the mesh axis the serve rules put the experts on.
    The batch rows split as the cache's batch dim does (``row_axes``),
    this rank holding block ``row_block`` of ``rows``."""

    def __init__(self, mesh, *, batch: int, max_len: int,
                 shard_length: bool = False, ep: Optional[str] = "model"):
        from repro_torch.distributed import sharding as SH
        self.mesh = mesh
        self.sizes: Dict[str, int] = SH.mesh_sizes(mesh)
        names = list(self.sizes)
        coord = mesh.get_coordinate()
        self.coord: Dict[str, int] = dict(zip(names, coord))
        self.batch, self.max_len = batch, max_len
        self.shard_length = shard_length
        self.ep = ep
        # the rows are the cache's: its batch dim goes over ``data`` when
        # it divides (``sharding.cache_pspecs``); the pod axis repeats
        brows = SH._cache_leaf("pos", (batch, max_len), self.sizes,
                               shard_length)[0]
        self.row_axes: Tuple[str, ...] = () if brows is None else (brows,)
        self.rows = self.size(self.row_axes)
        self.row_block = self.index(self.row_axes)
        self.model = self.sizes.get("model", 1)
        self.model_rank = self.coord.get("model", 0)
        self._groups: Dict[Tuple[str, ...], object] = {}

    # -- axes ---------------------------------------------------------------
    def size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.sizes.get(a, 1)
        return n

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block along ``axes`` (the first axis major)."""
        i = 0
        for a in axes:
            i = i * self.sizes.get(a, 1) + self.coord.get(a, 0)
        return i

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes`` (every rank builds the same groups in the same
        order, as the step runs the same code everywhere)."""
        axes = tuple(a for a in axes if a in self.sizes)
        if axes not in self._groups:
            self._groups[axes] = subgroup(self.mesh, axes)[0]
        return self._groups[axes]

    def cache_spec(self, name: str, shape: Sequence[int]):
        """The cache rule's spec of a leaf of global ``shape``."""
        from repro_torch.distributed import sharding as SH
        return SH._cache_leaf(name, tuple(shape), self.sizes,
                              self.shard_length)

    # -- rows ---------------------------------------------------------------
    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.rows == 1:
            return x
        b = x.shape[0] // self.rows
        return x[self.row_block * b:(self.row_block + 1) * b]

    def gather_rows(self, x: torch.Tensor, always: bool = False
                    ) -> torch.Tensor:
        """(B_local, ...) -> (B, ...) in row order.  ``always``: run the
        collective on a group of one too (the step's token gather, so a
        one-rank mesh still goes through the process group)."""
        if self.rows == 1 and not always:
            return x
        return self.all_gather(x, self.row_axes, dim=0)

    # -- collectives --------------------------------------------------------
    def all_gather(self, x: torch.Tensor, axes: Sequence[str], dim: int
                   ) -> torch.Tensor:
        """The blocks of the ranks along ``axes``, concatenated on
        ``dim`` in their order."""
        n = self.size(axes)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=self.group(axes))
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]
                   ) -> torch.Tensor:
        """Sum over the ranks along ``axes`` (in place; x when they are
        all of size 1)."""
        if self.size(axes) > 1:
            dist.all_reduce(x, group=self.group(axes))
        return x

    def all_reduce_model(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel outputs' sum over ``model``."""
        return self.all_reduce(x, ("model",))

    def gather_cols(self, x: torch.Tensor, full: int) -> torch.Tensor:
        """A column-parallel output (..., full / model) -> (..., full);
        x itself when its weight was whole."""
        if x.shape[-1] == full:
            return x
        return self.all_gather(x, ("model",), dim=-1)

    def merge_lse(self, o: torch.Tensor, lse: torch.Tensor, axis: str
                  ) -> torch.Tensor:
        """Attentions of the ranks along ``axis`` over disjoint key sets,
        o (..., H, D) with log-sum-exp (..., H), merged as one attention
        over their union (rank order; a rank whose keys all miss weighs
        0, and a row that no rank attends stays 0)."""
        if self.sizes.get(axis, 1) == 1:
            return o
        packed = torch.cat([o.float(), lse.float()[..., None]], dim=-1)
        allp = self.all_gather(packed[None], (axis,), dim=0)
        os_, ls = allp[..., :-1], allp[..., -1]
        m = ls.amax(dim=0)
        w = torch.exp(ls - m)
        out = (w[..., None] * os_).sum(dim=0) / w.sum(dim=0)[..., None]
        return out.to(o.dtype)

    # -- vocabulary ---------------------------------------------------------
    def vocab_slice(self, vocab: int) -> slice:
        return vocab_split(vocab, self.model, self.model_rank)

    def vocab_argmax(self, logits: torch.Tensor, vocab: int
                     ) -> torch.Tensor:
        """Greedy tokens from this rank's vocabulary slice (B, V_slice):
        each slice's (max, first index) is gathered over ``model`` and the
        first maximum in vocabulary order wins, as ``torch.argmax`` on the
        whole row keeps it.  (B,) int32."""
        lo = self.vocab_slice(vocab).start
        idx = torch.argmax(logits, dim=-1)
        best = torch.gather(logits, -1, idx[:, None])[:, 0]
        # indices below 2**24 are exact in fp32
        packed = torch.stack([best.float(), (idx + lo).float()], dim=-1)
        allp = self.all_gather(packed[None], ("model",), dim=0)
        pick = torch.argmax(allp[..., 0], dim=0)          # first max wins
        tok = torch.gather(allp[..., 1], 0, pick[None])[0]
        return tok.to(torch.int32)

    def gather_vocab(self, logits: torch.Tensor, vocab: int) -> torch.Tensor:
        """This rank's vocabulary slice (B, V_slice) -> (B, V): the
        slices, padded to one length for the gather, in vocabulary
        order."""
        if self.model == 1:
            return logits
        width = -(-vocab // self.model)
        pad = torch.nn.functional.pad(logits, (0, width - logits.shape[-1]))
        allp = self.all_gather(pad[None], ("model",), dim=0)
        return torch.cat([allp[k, :, :sl.stop - sl.start] for k, sl in
                          enumerate(vocab_split(vocab, self.model, r)
                                    for r in range(self.model))], dim=-1)


_SERVE: Optional[ServeLayout] = None


def serving() -> Optional[ServeLayout]:
    return _SERVE


@contextlib.contextmanager
def serve_layout(srv: Optional[ServeLayout]) -> Iterator[None]:
    """Make ``srv`` the active serving layout for the step inside."""
    global _SERVE
    prev, _SERVE = _SERVE, srv
    try:
        yield
    finally:
        _SERVE = prev
