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

The JAX package's ``make_production_mesh`` and its v5e constants
describe TPU pods and have no counterpart here; ``input_specs`` /
``cache_specs`` (the dry run's stand-ins) are not ported.
"""
from __future__ import annotations

import math
import os
import socket
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.serving.serve_step import require_device

AXES = ("pod", "data", "model")


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
