"""Train-step factory: loss, gradient accumulation, optimizer, sharding.

``build_trainer(cfg, mesh)`` returns a ``Trainer`` whose ``train_step`` is
``(state, batch) -> (state, metrics)`` with:

  * cross-entropy over fp32 logits, + z-loss (+ the MoE aux term, 0 for
    the dense decoder), labels -1 masked;
  * gradient accumulation over ``grad_accum`` microbatches (the parameters'
    ``.grad`` sums them in order, fp32, then divides);
  * AdamW / Adafactor with a cosine schedule and global-norm clipping.

With a ``DeviceMesh`` (``launch/mesh.py``; NCCL on the card, gloo on the
CPU) the state is sharded by the train rules (``distributed/sharding.py``):
each parameter and its optimizer slots (Adafactor's ``v_row`` / ``v_col``
included) are DTensors, ZeRO-3 over ``data`` and the TP dims over
``model``.  ``train_step`` takes the global batch on every rank; each
microbatch is split over the batch axes (``pod``/``data``).  The blocks
compute tensor-parallel over ``model`` (``distributed/parallel.py``): a
weight of GQA attention or MLA, of the SSD or RG-LRU mixer, of the dense
MLP or the MoE shared experts, of the routed experts, of the
encoder-decoder's attention, cross-attention and MLPs, the embedding or
the LM head is gathered over its FSDP axes only and this rank computes
on its ``model`` slice (``tp_names``); a block whose weights do not
split as it reads them gathers them whole and every model rank computes
it whole.  ``seq_parallel`` (the JAX package's keyword) shards the
residual stream over ``model`` on the sequence between blocks (each
block gathers the sequence on entry and reduce-scatters on exit; the
encoder-decoder's stream stays whole); without a mesh, or with
``model`` 1, it does nothing.  Each gradient is summed over the ranks
that hold a part of it (the rule is ``ActivationMesh``'s) and cut to
this rank's slices before the update, whose norms and means reduce
across the slices.

The step launches its work and returns: no value is read on the host, so
``metrics["loss"]`` stays a device tensor until the caller reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Set, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import Model, build_model
from repro_torch.models import layers as L
from repro_torch.serving.serve_step import require_device
from repro_torch.training import optimizer as OPT
from repro_torch.training.train_state import TrainState

Z_LOSS = 1e-4
MOE_AUX = 1e-2


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits fp32 (B,S,V); labels int (B,S), -1 = masked.
    Returns (summed loss, token count)."""
    mask = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)                        # (B,S)
    lab = torch.gather(logits, -1,
                       torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = (lse - lab) + Z_LOSS * torch.square(lse)
    nll = torch.where(mask, nll, 0.0)
    return torch.sum(nll), torch.sum(mask)


def _aux_term(cfg: ModelConfig, aux: torch.Tensor) -> Optional[torch.Tensor]:
    return MOE_AUX * aux / max(cfg.num_layers, 1) if cfg.moe is not None \
        else None


def make_loss_fn(model: Model, cfg: ModelConfig):
    def loss_fn(module, batch):
        logits, aux = model.forward(module, batch)
        loss_sum, n_tok = cross_entropy(logits, batch["labels"])
        loss = loss_sum / torch.clamp(n_tok, min=1).to(loss_sum.dtype)
        if cfg.moe is not None:
            loss = loss + _aux_term(cfg, aux)
        return loss, {"ntok": n_tok}
    return loss_fn


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    model: Model
    optimizer: OPT.Optimizer
    device: torch.device
    train_step: Callable[[TrainState, Dict[str, torch.Tensor]],
                         Tuple[TrainState, Dict[str, torch.Tensor]]]
    init_state: Callable[..., TrainState]
    # (state, batch) -> (mean loss, {name: gradient}): the step's gradients
    # before the update (on a mesh, this rank's slices of the summed ones);
    # the next step reuses their buffers
    grads: Optional[Callable] = None
    mesh: Optional[object] = None
    # the sharded state's layout: {leaf id: DTensor placements}, filled by
    # init_state ("params.<name>", "opt_state.m.<name>", ...)
    placements: Optional[Dict[str, tuple]] = None
    # state -> the module the step computes with (on a mesh, this rank's
    # compute weights: ``model`` slices of the TP-computed ones)
    bind: Optional[Callable] = None


def opt_state_pspecs(cfg: ModelConfig, shapes: Dict[str, tuple],
                     pspecs: Dict[str, tuple]) -> Dict:
    """Specs of the optimizer slots, mirroring the parameters' (Adafactor's
    ``v_row`` drops the last dim's entry, ``v_col`` the one before it).
    Given the shapes as ``pspecs``, the slots' shapes."""
    if cfg.optimizer == "adamw":
        return {"m": dict(pspecs), "v": dict(pspecs)}

    def one(shape, spec):
        if len(shape) >= 2:
            return {"v_row": spec[:-1], "v_col": spec[:-2] + spec[-1:]}
        return {"v": spec}
    return {"slots": {n: one(shapes[n], pspecs[n]) for n in pspecs}}


def build_trainer(cfg: ModelConfig, mesh=None, *, total_steps: int = 10_000,
                  warmup_steps: int = 100, grad_accum: Optional[int] = None,
                  device="cuda", seq_parallel: bool = False) -> Trainer:
    dev = require_device(device)
    accum = grad_accum if grad_accum is not None else cfg.grad_accum
    if mesh is not None:
        return _build_sharded(cfg, mesh, dev, total_steps, warmup_steps,
                              accum, seq_parallel)
    model = build_model(cfg, moe_impl="gshard")
    opt = OPT.make_optimizer(cfg, total_steps, warmup_steps)
    loss_fn = make_loss_fn(model, cfg)

    def _grads(module, batch):
        """(mean loss, {name: fp32 grad}) over ``accum`` microbatches."""
        params = dict(module.named_parameters())
        for p in params.values():
            p.grad = None
        if accum <= 1:
            loss, _ = loss_fn(module, batch)
            loss.backward()
            return loss.detach(), {n: p.grad for n, p in params.items()}
        mb = _microbatch(batch, accum)
        loss_sum = 0.0
        for i in range(accum):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _ = loss_fn(module, sub)
            loss.backward()               # .grad sums the microbatches
            loss_sum = loss_sum + loss.detach()
        grads = {n: p.grad.div_(accum) for n, p in params.items()}
        return loss_sum / accum, grads

    def train_step(state: TrainState, batch):
        module = state.params
        loss, grads = _grads(module, batch)
        with torch.no_grad():
            gnorm = OPT.global_norm(grads.values())
            params = dict(module.named_parameters())
            updates, new_opt = opt.update(grads, state.opt_state, params)
            OPT.apply_updates(params, updates)
        for p in params.values():
            p.grad = None
        new_state = TrainState(params=module, opt_state=new_opt,
                               step=state.step + 1,
                               err_feedback=state.err_feedback)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_state.step}
        return new_state, metrics

    def init_state(seed: int, *, compression: bool = False) -> TrainState:
        with torch.no_grad():
            module = model.init(L.generator(dev, seed))
        return TrainState.create(module, opt, compression=compression)

    return Trainer(cfg=cfg, model=model, optimizer=opt, device=dev,
                   train_step=train_step, init_state=init_state,
                   grads=lambda state, batch: _grads(state.params, batch),
                   bind=lambda state: state.params)


def _microbatch(batch, accum: int) -> int:
    B = batch["tokens"].shape[0]
    if B % accum:
        raise ValueError(f"batch {B} does not split into {accum} "
                         "microbatches")
    return B // accum


# ---------------------------------------------------------------------------
# the mesh branch
# ---------------------------------------------------------------------------
# the weights of a block computed on its ``model`` slices: name -> the
# dim the ``model`` axis must shard (MLA on its heads; the SSD mixer on its
# heads; the RG-LRU on its channels)
MLA_SLICES = {"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0}
SSD_SLICES = {"w_z": 1, "w_x": 1, "w_dt": 1, "conv_x_w": 1, "conv_x_b": 0,
              "A_log": 0, "D": 0, "dt_bias": 0, "gate_norm": 0,
              "out_proj": 0}
RGLRU_SLICES = {"w_gate": 1, "w_x": 1, "conv_w": 1, "conv_b": 0,
                "lambda_": 0, "a_gate_w": 0, "a_gate_b": 0, "i_gate_w": 0,
                "i_gate_b": 0, "w_out": 0}
CROSS_SLICES = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}


def tp_names(cfg: ModelConfig, model_dims: Dict[str, Optional[int]],
             model: int) -> Set[str]:
    """The parameters a training rank computes on as its ``model`` slice.
    ``model_dims``: {name: the dim the ``model`` axis shards, or None}.
    A module is computed tensor-parallel when its weights split as the
    layers read them: GQA attention with whole query heads a rank
    (``wq`` / ``wo``, and ``wk`` / ``wv`` where they split), MLA with
    whole heads a rank (``wq``, ``w_uk``, ``w_uv``, ``wo``), the
    encoder-decoder's cross-attention with whole heads a rank, the SSD
    mixer with whole heads a rank in one group, the RG-LRU mixer, the
    gated MLP (``mlp`` and the MoE ``shared`` experts), the routed
    experts by expert or hidden dim (with their shared experts), the
    embedding's rows and the LM head's columns."""
    if model == 1:
        return set()

    def cut(name, dim):
        return model_dims.get(name) == dim

    def block(pre, slices, ok=True):
        return {pre + w for w in slices} if ok and all(
            cut(pre + w, d) for w, d in slices.items()) else set()
    heads = cfg.num_heads % model == 0
    keep: Set[str] = set()
    for n in model_dims:
        if n.endswith("mixer.wq") and cfg.mla is not None:
            keep |= block(n[:-2], MLA_SLICES, heads)
        elif n.endswith("mixer.wq"):
            pre = n[:-2]
            if cut(n, 1) and cut(pre + "wo", 0) and heads:
                keep |= {n, pre + "wo"}
                keep |= {pre + b for b in ("bq", "bk", "bv")
                         if cut(pre + b, 0)}
                keep |= {pre + w for w in ("wk", "wv") if cut(pre + w, 1)}
        elif n.endswith("cross.wq"):
            keep |= block(n[:-2], CROSS_SLICES, heads)
        elif n.endswith("mixer.out_proj"):
            s = cfg.ssm
            keep |= block(n[:-len("out_proj")], SSD_SLICES,
                          s.n_groups == 1 and (s.expand * cfg.d_model
                                               // s.head_dim) % model == 0)
        elif n.endswith("mixer.w_out"):
            keep |= block(n[:-len("w_out")], RGLRU_SLICES)
        elif n.endswith(("mlp.w_gate", "moe.shared.w_gate")):
            pre = n[:-len("w_gate")]
            if cut(n, 1) and cut(pre + "w_up", 1) and cut(pre + "w_down", 0):
                keep |= {pre + w for w in ("w_gate", "w_up", "w_down")}
    for n in model_dims:
        if n.endswith("moe.w_gate"):
            pre = n[:-len("w_gate")]
            up, down = pre + "w_up", pre + "w_down"
            split = (cut(n, 0) and cut(up, 0) and cut(down, 0)) or (
                cut(n, 2) and cut(up, 2) and cut(down, 1))
            shared = {s for s in model_dims if s.startswith(pre + "shared.")}
            if split and shared <= keep:
                keep |= {n, up, down}
            else:                   # the MoE block computes whole
                keep -= shared
    keep |= {n for n, d in (("embed", 0), ("lm_head", 1)) if cut(n, d)}
    return keep


def _build_sharded(cfg: ModelConfig, mesh, dev: torch.device,
                   total_steps: int, warmup_steps: int,
                   accum: int, seq_parallel: bool) -> Trainer:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import compression as C
    from repro_torch.distributed import parallel as PAR
    from repro_torch.distributed import sharding as SH

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch/mesh.py), not {type(mesh).__name__}")
    if dev.type != "meta" and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot train on {dev}")
    model = build_model(cfg, moe_impl="gshard")
    sizes = SH.mesh_sizes(mesh)
    names = list(sizes)
    coord = mesh.get_coordinate()
    world = mesh.mesh.numel()
    n_model = sizes.get("model", 1)
    mdim = names.index("model") if "model" in sizes else None
    layout: Dict[str, Tuple[tuple, int]] = {}     # name -> (placements, ndim)
    red = PAR.ShardReducer(mesh, layout) if world > 1 else OPT.PLAIN
    opt = OPT.make_optimizer(cfg, total_steps, warmup_steps, red)
    placements: Dict[str, tuple] = {}
    compute: Dict[str, object] = {}
    groups: Dict[tuple, tuple] = {}
    acts: Dict[tuple, tuple] = {}

    def sharded(pls) -> bool:
        return any(isinstance(p, Shard) and s > 1
                   for p, s in zip(pls, sizes.values()))

    def fsdp_only(pls) -> tuple:
        """The placements without the ``model`` axis."""
        return tuple(Replicate() if i == mdim else p
                     for i, p in enumerate(pls))

    def model_only(pls) -> tuple:
        """The placements of the ``model`` axis alone."""
        return tuple(p if i == mdim else Replicate()
                     for i, p in enumerate(pls))

    def local(full: torch.Tensor, pls) -> torch.Tensor:
        if not sharded(pls):
            return full
        return full[SH.local_slices(full.shape, pls, mesh, coord)].contiguous()

    def zeros(shape, pls) -> DTensor:
        sl = SH.local_slices(shape, pls, mesh, coord)
        t = torch.zeros([s.stop - s.start for s in sl], dtype=torch.float32,
                        device=dev)
        return DTensor.from_local(t, mesh, pls, run_check=False)

    def init_state(seed: int, *, compression: bool = False) -> TrainState:
        with torch.no_grad():
            module = model.init(L.generator(dev, seed))
        module.requires_grad_(True)
        compute["module"] = module
        shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
        pspecs = SH.param_pspecs(cfg, shapes, mesh, "train")
        params = {}
        for n, p in module.named_parameters():
            pls = SH.placements(pspecs[n], mesh)
            layout[n] = (pls, p.dim())
            placements[f"params.{n}"] = pls
            params[n] = DTensor.from_local(local(p.detach(), pls), mesh, pls,
                                           run_check=False)
        specs = opt_state_pspecs(cfg, shapes, pspecs)

        def slots(spec_tree, shape_tree, prefix):
            if isinstance(shape_tree, dict):
                return {k: slots(spec_tree[k], shape_tree[k],
                                 f"{prefix}.{k}") for k in shape_tree}
            pls = SH.placements(spec_tree, mesh)
            placements[prefix] = pls
            return zeros(shape_tree, pls)
        opt_state = slots(specs, opt_state_pspecs(cfg, shapes, shapes),
                          "opt_state")
        opt_state["step"] = torch.zeros((), dtype=torch.int32, device=dev)
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32, device=dev),
                          err_feedback=C.init_error(params) if compression
                          else None)

    def bind(state: TrainState) -> torch.nn.Module:
        """The compute module: a TP-computed parameter (``tp_names``) is
        gathered over its FSDP axes only and holds this rank's ``model``
        slice; any other sharded one is gathered whole; a replicated one
        is this rank's tensor itself."""
        if "module" not in compute:
            with torch.no_grad():
                compute["module"] = model.init(L.generator(dev, 0))
            compute["module"].requires_grad_(True)
        module = compute["module"]
        for n, d in state.params.items():
            layout[n] = (tuple(d.placements), d.dim())
            placements[f"params.{n}"] = layout[n][0]
        dims = {n: (pls[mdim].dim % nd if mdim is not None
                    and isinstance(pls[mdim], Shard) else None)
                for n, (pls, nd) in layout.items()}
        compute["tp"] = tp_names(cfg, dims, n_model)
        with torch.no_grad():
            for n, p in module.named_parameters():
                d = state.params[n]
                pls = layout[n][0]
                if n in compute["tp"]:
                    keep = model_only(pls)
                    p.data = (d if keep == pls else
                              d.redistribute(mesh, keep)).to_local()
                else:
                    p.data = d.full_tensor() if sharded(pls) \
                        else d.to_local()
        return module

    def group(axes: tuple) -> tuple:
        if axes not in groups:
            groups[axes] = PAR.subgroup(mesh, axes) if axes else (None, 1)
        return groups[axes]

    def row_layout(mb: int, seq: int):
        """(the microbatch's layout over the ranks, this rank's row
        block, the groups that sum a complete and a partial gradient)."""
        if (mb, seq) in acts:
            return acts[mb, seq]
        baxes = SH.batch_axes(mesh, mb)
        axes = () if baxes is None else (
            (baxes,) if isinstance(baxes, str) else tuple(baxes))
        rows_group, rows = group(axes)
        block = 0
        for a in axes:
            block = block * sizes[a] + coord[names.index(a)]
        kw = {}
        if n_model > 1:
            g = mesh.get_group("model")
            rank = coord[mdim]
            kw = dict(vocab_group=g, model_group=g, model=n_model,
                      model_rank=rank,
                      vocab_slice=PAR.vocab_split(cfg.vocab_size, n_model,
                                                  rank),
                      seq=(seq_parallel and seq % n_model == 0
                           and not cfg.encoder_layers))
        act = PAR.ActivationMesh(rows_group=rows_group, rows=rows, **kw)
        acts[mb, seq] = (act, block, (rows_group, rows),
                         group(axes + (("model",) if n_model > 1 else ())))
        return acts[mb, seq]

    def share_of(module, sub, act: PAR.ActivationMesh, block: int):
        """(this rank's share of one microbatch's loss: its rows'
        cross-entropy over the microbatch's tokens, plus the MoE term;
        both detached beside it).  Nothing of the forward outlives this
        call but the graph, so the logits go in the backward."""
        n_tok = torch.clamp(torch.sum(sub["labels"] >= 0), min=1)
        b = sub["tokens"].shape[0] // act.rows
        loc = {k: v[block * b:(block + 1) * b] for k, v in sub.items()}
        logits, aux = model.forward(module, loc)
        if act.vocab_group is not None:
            ce, _ = PAR.vocab_parallel_cross_entropy(
                logits, loc["labels"], act, Z_LOSS)
        else:
            ce, _ = cross_entropy(logits, loc["labels"])
        ce = ce / n_tok.to(ce.dtype)
        aux_t = _aux_term(cfg, aux)
        share = ce if aux_t is None else ce + aux_t
        return share, ce.detach(), None if aux_t is None else aux_t.detach()

    def microbatch_loss(module, sub, act: PAR.ActivationMesh, block: int):
        """Backward of this rank's share of one microbatch's loss; returns
        the microbatch's loss (the same on every rank)."""
        with PAR.activation_mesh(act):
            share, loss, aux_t = share_of(module, sub, act, block)
            share.backward()
        if act.rows_group is not None:
            dist.all_reduce(loss, group=act.rows_group)
        return loss if aux_t is None else loss + aux_t

    def cut(n: str, g: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a summed gradient: of a ``model`` slice,
        its FSDP part; of a whole one, its placements' slice."""
        pls = layout[n][0]
        if n in compute["tp"]:
            pls = fsdp_only(pls)
        return local(g, pls)

    def sharded_grads(state: TrainState, batch):
        module = bind(state)
        mb = _microbatch(batch, accum)
        act, block, whole, part = row_layout(mb, batch["tokens"].shape[1])
        act.partial.clear()         # the forward marks them anew
        for p in module.parameters():
            p.grad = None
        loss_sum = 0.0
        for i in range(accum):
            sub = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss_sum = loss_sum + microbatch_loss(module, sub, act, block)
        loss = loss_sum / accum if accum > 1 else loss_sum
        grads = {}
        with torch.no_grad():
            for n, p in module.named_parameters():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                if accum > 1:
                    g.div_(accum)
                grp, size = part if PAR.sums_over_model(act, p) else whole
                if size > 1:
                    dist.all_reduce(g, group=grp)
                grads[n] = cut(n, g)
        return loss, grads

    def train_step(state: TrainState, batch):
        loss, grads = sharded_grads(state, batch)
        with torch.no_grad():
            params = {n: d.to_local() for n, d in state.params.items()}
            gnorm = red.global_norm(grads)
            opt_local = _map_tree(state.opt_state, _to_local)
            updates, new_opt = opt.update(grads, opt_local, params)
            OPT.apply_updates(params, updates)
        new_state = TrainState(
            params=state.params,
            opt_state={**state.opt_state, "step": new_opt["step"]},
            step=state.step + 1, err_feedback=state.err_feedback)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": new_state.step}
        return new_state, metrics

    return Trainer(cfg=cfg, model=model, optimizer=opt, device=dev,
                   train_step=train_step, init_state=init_state,
                   grads=sharded_grads, mesh=mesh, placements=placements,
                   bind=bind)


def _to_local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)
