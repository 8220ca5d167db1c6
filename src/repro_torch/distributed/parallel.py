"""The sharded train step's collectives: row gathers, the vocab-parallel
loss, and the optimizer's reductions over shards.

The mesh branch of ``training/trainer.py`` keeps parameters and optimizer
slots as DTensors placed by ``sharding.param_placements`` (ZeRO-3 over
``data``, TP dims over ``model``).  A step gathers each sharded
parameter whole, splits the batch over the batch axes (``pod``/``data``)
and computes; the model ranks share their rows, and the LM head is
vocab-parallel over ``model``: each model rank computes the logits of its
slice of the vocabulary, and the loss's log-sum-exp and label logit are
all-reduced over the ``model`` group.  Every rank's gradient is then a
share whose sum over all ranks is the full gradient (see
``ActivationMesh``), so one all-reduce gives it, and each rank keeps its
slice.

Two places in the model couple rows or the vocabulary and read the
active ``ActivationMesh`` (set with ``activation_mesh``, as the JAX
package's trainer sets its activation mesh): the MoE block gathers the
rows of the whole microbatch across the batch group before it routes,
so the capacity groups and the load-balancing loss are the unsharded
ones, and ``layers.lm_logits`` computes only this rank's vocabulary
slice.

Serving computes on the shards themselves (``ServeLayout``, set with
``serve_layout`` by the mesh branch of ``serving/serve_step.py``): each
rank holds its slices of the weights (placed by the serve rules) and of
the cache, and the layers compute on them, reading what is sharded from
the local shapes: column-parallel projections, row-parallel outputs
summed by one all-reduce over ``model``, attention over the local heads
or the local length (merged by log-sum-exp), the experts of this rank,
the LM head's vocabulary slice and a greedy argmax across the slices.
This is the placement's compute that XLA's SPMD partitioner derives for
the JAX package's jitted serve.  Serving runs under ``torch.no_grad``,
so these collectives have no backward.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Dict, Iterator, Optional, Sequence, Tuple

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
    ``vocab_group`` (size > 1): the ranks that split the vocabulary, this
    one holding ``vocab_slice``; None when the logits are whole.
    ``ce_scale`` / ``aux_scale``: the weights that make every rank's
    gradient an additive share (1 / the ranks that repeat this rank's
    cross-entropy term; 1 / world for the MoE loss, which every rank
    computes whole)."""
    rows_group: Optional[dist.ProcessGroup] = None
    rows: int = 1
    vocab_group: Optional[dist.ProcessGroup] = None
    vocab_slice: Optional[slice] = None
    ce_scale: float = 1.0
    aux_scale: float = 1.0


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


# ---------------------------------------------------------------------------
# rows: all-gather forward, reduce-scatter backward
# ---------------------------------------------------------------------------
class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        parts = list(g.contiguous().chunk(ctx.n, dim=0))
        out = torch.empty_like(parts[0])
        _reduce_scatter(out, parts, ctx.group)
        return out, None, None


def _reduce_scatter(out: torch.Tensor, parts, group) -> None:
    """out = sum over ranks of their ``parts[rank]`` (gloo has no
    reduce_scatter: an all-reduce of the stacked parts there)."""
    if dist.get_backend(group) == "nccl":
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
    return _GatherRows.apply(x, act.rows_group, act.rows)


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
