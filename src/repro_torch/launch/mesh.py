"""Device meshes for the port's distributed paths.

``make_mesh(shape, axes, device)`` joins (or starts) the process group
and returns a ``DeviceMesh`` over it with named axes drawn from
("pod", "data", "model").  On ``cuda`` the group runs on NCCL, one card a
rank; on ``cpu`` it runs on gloo (the tests' host meshes).  Rank and
world size come from the environment that ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); with
none set, the process is a group of one on a free localhost port.  A
CUDA run with more ranks on this host than cards raises: nothing falls
back to the CPU or to fewer ranks.

The dry run's side (the JAX package's ``launch/mesh.py:30-99``):
``production_mesh_sizes(multi_pod)`` is the reference's logical mesh as
an axis-size mapping (16 x 16, or 2 x 16 x 16 with ``pod``), which the
sharding rules take with no rank; ``input_specs`` / ``cache_specs`` give
a cell's inputs and KV cache as meta tensors (global shapes, nothing
allocated) with each one's spec beside it by the same keys.  The card's
constants below are the H100's (the JAX package's are a TPU's and have
no use here).
"""
from __future__ import annotations

import math
import os
import socket
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as SH
from repro_torch.serving.serve_step import require_device

AXES = ("pod", "data", "model")

# One card, for the plans' rooflines: NVIDIA H100 80GB HBM3 (SXM) at its
# 700 W power limit, from NVIDIA's data sheet.  A card set to a lower
# limit runs slower under load.
CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core flops/s
HBM_BW = 3.35e12                  # bytes/s
HBM_BYTES = 80 * 10**9            # device memory
NVLINK_BW = 450e9                 # bytes/s a direction (NVLink 4, 18 links)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device="cuda") -> Tuple[int, int]:
    """Join the process group for ``device`` (starting it if needed);
    returns (rank, world size)."""
    dev = require_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", device {dev} needs {backend}")
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(f"{local_world} ranks on this host but "
                               f"{cards} CUDA devices: NCCL needs one card "
                               "a rank")
        torch.cuda.set_device(local_rank)
    if "MASTER_ADDR" in os.environ:
        init = "env://"
    elif world == 1:
        init = f"tcp://localhost:{_free_port()}"
    else:
        raise RuntimeError("WORLD_SIZE > 1 without MASTER_ADDR/MASTER_PORT")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    return rank, world


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model"),
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over every
    rank of the process group (whose size must be the shape's product)."""
    if len(shape) != len(axes) or not set(axes) <= set(AXES):
        raise ValueError(f"mesh {tuple(shape)} over {tuple(axes)}: axes are "
                         f"drawn from {AXES}, one a dim")
    dev = require_device(device)
    world = dist.get_world_size() if dist.is_initialized() \
        else int(os.environ.get("WORLD_SIZE", 1))
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    init_distributed(dev)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(shape: Tuple[int, ...] = (2, 4),
                   axes: Tuple[str, ...] = ("data", "model")) -> DeviceMesh:
    """A mesh over gloo ranks on the CPU (tests)."""
    return make_mesh(shape, axes, "cpu")


def parse_mesh(text: str) -> Tuple[int, ...]:
    """'2x4' -> (2, 4) (data x model); 'none' -> ()."""
    if text == "none":
        return ()
    return tuple(int(x) for x in text.split("x"))


def production_mesh_sizes(multi_pod: bool = False) -> Dict[str, int]:
    """The JAX package's production mesh as axis sizes: one pod (data 16,
    model 16) or two (pod 2, data 16, model 16)."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


# ---------------------------------------------------------------------------
# the dry run's stand-ins: meta tensors beside their specs
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """Every model input of the (arch, shape) cell: ({name: meta tensor
    of the global shape}, {name: spec}).  ``mesh``: a ``DeviceMesh`` or
    an axis-size mapping.

    train:   tokens, labels (+ frames, or vis_embeds + vis_mask stubs)
    prefill: tokens, lengths (+ frames)
    decode:  tokens (B,), lengths (B,): one new token against a cache of
             shape.seq_len (``cache_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    b = SH.batch_axes(mesh, B)
    tensors: Dict[str, torch.Tensor] = {}
    specs: Dict[str, tuple] = {}

    def add(name, dims, dtype, spec):
        tensors[name] = torch.empty(dims, dtype=dtype, device="meta")
        specs[name] = spec

    if shape.kind in ("train", "prefill"):
        add("tokens", (B, S), torch.int32, (b, None))
        if shape.kind == "train":
            add("labels", (B, S), torch.int32, (b, None))
        else:
            add("lengths", (B,), torch.int32, (b,))
        if cfg.is_encoder_decoder:
            add("frames", (B, cfg.num_audio_frames, cfg.d_model),
                torch.float32, (b, None, None))
        elif cfg.frontend_stub and shape.kind == "train":
            add("vis_embeds", (B, S, cfg.d_model), torch.bfloat16,
                (b, None, None))
            add("vis_mask", (B, S), torch.bool, (b, None))
    else:
        add("tokens", (B,), torch.int32, (b,))
        add("lengths", (B,), torch.int32, (b,))
    return tensors, specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, model=None
                ) -> Tuple[list, list]:
    """The KV cache of a decode (or prefill) cell: (per-layer dicts of
    meta tensors, the same dicts of specs).  A batch of 1 (long_500k)
    puts the cache's length over ``data`` too, as the JAX package's
    ``shard_length`` does."""
    from repro_torch.models.registry import build_model
    model = model or build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    cache = model.init_cache(B, S, "meta")
    return cache, SH.cache_pspecs(cfg, cache, mesh, shard_length=(B == 1))
