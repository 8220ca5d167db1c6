"""Serving steps: batched chunked-prefill and decode, on one device or
over a mesh.

``build_serve_fns(cfg, mesh=None, batch=, max_len=, device=)`` returns
the data-plane functions the engine (and the dry run) calls:

  * ``prefill_chunk(module, cache, tokens(B,C), lengths(B,), valid_n(B,),
    frames=None)`` -> (next_token (B,), last_logits (B,V), cache)
    Ragged tails are exact: pad entries are written with position -1.
    ``frames`` (B, T_enc, d): an encoder-decoder encodes them and fills
    every layer's cross K/V first (the engine passes none).
  * ``prefill_rows(module, cache, slots(k,), tokens(B,C), lengths(B,),
    valid_n(B,))`` -> (next_token (k,), last_logits (k,V), cache)
    ``prefill_chunk`` computed for the k slots ``slots`` alone: each
    layer's cache rows of those slots are gathered, run through it and
    written back.  A call then costs its k rows, not B (the engine grants
    at most ``prefill_slots_per_step`` of its ``max_slots``).  Every
    other slot gets only what the whole chunk writes into a slot without
    work: position -1 at its chunk's entries of each attention ring, so
    what is served does not change.  On a full ring (a sliding window, a
    global cache past ``max_len``) these entries erase live keys, as the
    whole chunk's do (ROADMAP Queue 3).  ``None`` where the rows cannot
    be taken apart: over a mesh, whose ranks each hold a block of the
    batch rows, and for a model with MoE layers that dispatches with
    ``gshard``, whose capacity counts every token of the call, padding
    included, so fewer rows would drop other tokens.  The ``grouped``
    dispatch (``cfg.moe.serve_impl``) has no capacity: each row's
    experts are its own, so its MoE models take ``prefill_rows``.
  * ``decode(module, cache, tokens(B,), lengths(B,), active(B,))``
      -> (next_token (B,), cache)
  * ``reset_slots(cache, keep_mask(B,))`` — invalidate freed slots' cache
    rows so re-assigned slots never attend to a previous tenant's KV or
    continue its recurrent state (the paper's memory-isolation
    requirement R3 at the cache level).

A model with MoE layers dispatches with ``moe_impl`` (``gshard``, as the
JAX package serves) unless ``cfg.moe.serve_impl`` is ``grouped``: then
one device serves it dropless with no host sync (``models/moe.py``), and
a mesh refuses it (its ranks' experts are summed by ``gshard``'s
all-reduce).

The functions run eagerly and update the cache's tensors in place (the
JAX package jits them and donates the cache).  ``device`` is the card
unless the caller asks for ``"cpu"``; without a card the default raises.
``"meta"`` builds shapes only (the dry run).

With a ``DeviceMesh`` (``launch/mesh.py``) every rank holds its slices:
the weights placed by the serve rules (``sharding.param_placements(...,
"serve")``; drawn whole from the seed, as on one device, then cut), the
cache allocated at the local shapes of ``sharding.cache_pspecs``, and the
batch rows of its block of the cache's batch axis.  The functions still
take and return whole (B,) / (B, V) tensors: each rank takes its rows,
computes on its shards under the serving layout
(``distributed/parallel.py``), and gathers the sampled tokens (and
prefill's last logits) back, so every rank returns the same.  Every
family computes tensor-parallel over ``model``: attention and MLA on
their heads (or on a length shard of the cache), the SSD and RG-LRU
mixers on their heads and channels, the encoder-decoder's encoder,
decoder and cross-attention as the decoder-only layers.  The pod axis
repeats the step: the cache rule keeps it off the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.sampler import sample


@dataclasses.dataclass
class ServeFns:
    cfg: ModelConfig
    model: Model
    device: torch.device
    init_params: Callable[[int], Any]
    init_cache: Callable[[], Any]
    prefill_chunk: Callable[..., Tuple[torch.Tensor, torch.Tensor, Any]]
    decode: Callable[..., Tuple[torch.Tensor, Any]]
    reset_slots: Callable[[Any, torch.Tensor], Any]
    chunk: int = 256                 # prefill chunk, clipped by the window
    prefill_rows: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor,
                                               Any]]] = None
    place: Callable[[Any], Any] = lambda module: module   # a whole module
    #                                  -> this rank's shards (mesh branch)
    layout: Any = None               # the mesh branch's ServeLayout
    placements: Optional[Dict[str, tuple]] = None   # parameter -> DTensor
    #                                                 placements (mesh)


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names a CUDA
    device and no card is present (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return dev


def make_reset_slots(cfg: ModelConfig):
    """reset(cache, keep (B,) bool) -> cache with dropped slots invalidated,
    in place: ``pos`` rows set to -1 (k/v payloads are masked by pos) and
    the recurrent rows (``state``, ``h``, ``conv*``) zeroed, so a
    reassigned slot starts from a fresh state, not its last tenant's."""

    def reset(cache, keep):
        drop = ~keep.to(torch.bool)
        for layer in cache:
            for name, t in layer.items():
                rows = drop.reshape((-1,) + (1,) * (t.dim() - 1))
                if name == "pos":
                    t.masked_fill_(rows, -1)
                elif name in ("state", "h") or name.startswith("conv"):
                    t.masked_fill_(rows, 0)
        return cache

    return reset


def build_serve_fns(cfg: ModelConfig, mesh=None, *, batch: int,
                    max_len: int, prefill_chunk: int = 256,
                    moe_impl: str = "gshard", temperature: float = 0.0,
                    device="cuda", shard_cache_length: bool = False
                    ) -> ServeFns:
    dev = require_device(device)
    if cfg.moe is not None and cfg.moe.serve_impl == "grouped":
        if mesh is not None:
            raise NotImplementedError(
                f"{cfg.name}: serve_impl 'grouped' serves on one device; "
                "the serving mesh dispatches with gshard")
        moe_impl = "grouped"
    model = build_model(cfg, moe_impl=moe_impl)
    if cfg.window_size:
        prefill_chunk = min(prefill_chunk, cfg.window_size)
    if mesh is not None:
        return _build_sharded(cfg, mesh, model, dev, batch, max_len,
                              prefill_chunk, temperature, shard_cache_length)

    @torch.no_grad()
    def _prefill(module, cache, tokens, lengths, valid_n, frames=None):
        B, C = tokens.shape
        valid = torch.arange(C, device=tokens.device)[None, :] \
            < valid_n[:, None]
        logits, cache = model.prefill(module, tokens, cache, lengths,
                                      valid=valid, frames=frames)
        idx = torch.clamp(valid_n.long() - 1, min=0)
        last = logits[torch.arange(B, device=logits.device), idx]  # (B, V)
        nxt = sample(last, temperature=temperature)
        return nxt, last, cache

    @torch.no_grad()
    def _prefill_rows(module, cache, slots, tokens, lengths, valid_n):
        # the pad entries the whole chunk writes: position -1 at (fill +
        # arange(C)) mod T in every slot's ring; the slots computed below
        # write the same entries again
        C = tokens.shape[1]
        at = lengths.long()[:, None] + torch.arange(C, device=tokens.device)
        for layer in cache:
            if "pos" in layer:
                layer["pos"].scatter_(1, at % layer["pos"].shape[1], -1)
        if not len(slots):
            return (torch.zeros(0, dtype=torch.int32, device=tokens.device),
                    torch.zeros((0, cfg.vocab_size), device=tokens.device),
                    cache)
        part = [{name: t.index_select(0, slots) for name, t in layer.items()}
                for layer in cache]
        nxt, last, part = _prefill(module, part, tokens[slots],
                                   lengths[slots], valid_n[slots])
        # attention writes the gathered rows in place; a recurrent layer
        # replaces its entries, so write back what the call returned
        for layer, rows in zip(cache, part):
            for name, t in rows.items():
                layer[name].index_copy_(0, slots, t)
        return nxt, last, cache

    @torch.no_grad()
    def _decode(module, cache, tokens, lengths, active):
        logits, cache = model.decode_step(
            module, tokens[:, None], cache, lengths,
            valid=active.to(torch.bool)[:, None])
        nxt = sample(logits[:, -1], temperature=temperature)
        return nxt, cache

    @torch.no_grad()
    def init_params(seed: int):
        return model.init(L.generator(dev, seed))

    return ServeFns(
        cfg=cfg, model=model, device=dev, init_params=init_params,
        init_cache=lambda: model.init_cache(batch, max_len, dev),
        prefill_chunk=_prefill, decode=_decode,
        reset_slots=make_reset_slots(cfg), chunk=prefill_chunk,
        prefill_rows=(None if any(cfg.moe_layer_mask())
                      and moe_impl == "gshard" else _prefill_rows))


# ---------------------------------------------------------------------------
# the mesh branch
# ---------------------------------------------------------------------------
def _build_sharded(cfg: ModelConfig, mesh, model: Model, dev: torch.device,
                   batch: int, max_len: int, chunk: int, temperature: float,
                   shard_length: bool) -> ServeFns:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import parallel as PAR
    from repro_torch.distributed import sharding as SH

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(launch/mesh.py), not {type(mesh).__name__}")
    if dev.type != "meta" and mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot serve on {dev}")
    sizes = SH.mesh_sizes(mesh)
    rules = SH.rules_for(cfg, "serve", sizes)
    srv = PAR.ServeLayout(mesh, batch=batch, max_len=max_len,
                          shard_length=shard_length, ep=rules.ep)
    coord = mesh.get_coordinate()
    placements: Dict[str, tuple] = {}
    V = cfg.vocab_size

    @torch.no_grad()
    def place(module):
        """Cut a whole module's weights to this rank's slices, in place."""
        pls = SH.param_placements(cfg, module, mesh, "serve")
        for n, p in module.named_parameters():
            placements[n] = pls[n]
            sl = SH.local_slices(p.shape, pls[n], mesh, coord)
            if any(s.stop - s.start < d for s, d in zip(sl, p.shape)):
                p.data = p.data[sl].contiguous()
        return module

    @torch.no_grad()
    def init_params(seed: int):
        return place(model.init(L.generator(dev, seed)))

    def init_cache():
        whole = model.init_cache(batch, max_len, "meta")
        specs = SH.cache_pspecs(cfg, whole, sizes, shard_length)
        return [{name: torch.full(SH.local_shape(t.shape, specs[i][name],
                                                 sizes),
                                  -1 if name == "pos" else 0,
                                  dtype=t.dtype, device=dev)
                 for name, t in layer.items()}
                for i, layer in enumerate(whole)]

    def pick(last):
        """(B_local, V slice) -> (B,) tokens, the same on every rank."""
        if temperature <= 0.0:
            tok = srv.vocab_argmax(last, V)
        else:
            tok = sample(srv.gather_vocab(last, V), temperature=temperature)
        return srv.gather_rows(tok, always=True)

    @torch.no_grad()
    def _prefill(module, cache, tokens, lengths, valid_n, frames=None):
        tokens, lengths, valid_n = map(srv.local_rows,
                                       (tokens, lengths, valid_n))
        if frames is not None:
            frames = srv.local_rows(frames)
        B, C = tokens.shape
        valid = torch.arange(C, device=tokens.device)[None, :] \
            < valid_n[:, None]
        with PAR.serve_layout(srv):
            logits, cache = model.prefill(module, tokens, cache, lengths,
                                          valid=valid, frames=frames)
            idx = torch.clamp(valid_n.long() - 1, min=0)
            last = logits[torch.arange(B, device=logits.device), idx]
            nxt = pick(last)
            last = srv.gather_rows(srv.gather_vocab(last, V))
        return nxt, last, cache

    @torch.no_grad()
    def _decode(module, cache, tokens, lengths, active):
        tokens, lengths, active = map(srv.local_rows,
                                      (tokens, lengths, active))
        with PAR.serve_layout(srv):
            logits, cache = model.decode_step(
                module, tokens[:, None], cache, lengths,
                valid=active.to(torch.bool)[:, None])
            nxt = pick(logits[:, -1])
        return nxt, cache

    reset = make_reset_slots(cfg)

    return ServeFns(
        cfg=cfg, model=model, device=dev, init_params=init_params,
        init_cache=init_cache, prefill_chunk=_prefill, decode=_decode,
        reset_slots=lambda cache, keep: reset(cache, srv.local_rows(keep)),
        chunk=chunk, place=place, layout=srv, placements=placements)
