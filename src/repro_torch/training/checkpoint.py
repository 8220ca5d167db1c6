"""Checkpoints of a TrainState, one-device or sharded, in the JAX
package's layout, with an atomic commit and elastic resharding.

    ckpt_dir/
      step_00000420/
        index.json            # leaves: shape, dtype, shard files; extra
        <leaf-id>.s<k>.npy    # one file per saved shard (a global slice)
      LATEST                  # atomically replaced pointer file

A save writes into a temporary directory and commits it by renaming,
then rewrites LATEST, so a torn save is never visible; the data
pipeline's state rides in ``index.json``'s ``extra``.  The port's leaf
ids are ``params.<name>``, ``opt_state.<slot>.<name>[.<part>]``,
``err_feedback.<name>`` and ``step``.

Sharded state (DTensor leaves): every rank writes only the shards it
holds, each once: the shard at mesh coordinate c is ``<leaf-id>.s<k>``
with k its index among the distinct shards (the mesh dims that shard the
leaf, row major), written by the rank whose coordinates along the other
mesh dims are 0; plain leaves are written by rank 0.  Every rank derives
the whole index from the placements, and rank 0 writes it and commits
after a barrier (``AsyncCheckpointer`` writes on a thread and barriers on
a gloo group of its own, so it never shares the train step's group).

``load`` fills the target state's tensors in place: a DTensor gets its
rank's slice, assembled from whichever saved shards overlap it, so a
checkpoint saved on one mesh restores onto another or onto one device;
``placements=`` rebuilds listed leaves with another layout.  ``load``
also reads a checkpoint that the JAX package's
``training.checkpoint.save`` wrote for an unsharded TrainState (leaf ids
``[<flat index 0>].embed`` ...): it rebuilds that tree and converts it
with ``weights.train_state_from_reference``.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch.training.train_state import TrainState

_JAX_CHILDREN = ("params", "opt_state", "step", "err_feedback")
_JAX_PREFIX = "[<flat index "


# ---------------------------------------------------------------------------
# TrainState <-> flat {leaf id: tensor}
# ---------------------------------------------------------------------------
def _flatten(prefix: str, tree: Any, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif tree is not None:
        raise TypeError(f"{prefix}: cannot checkpoint {type(tree)}")


def state_leaves(state: TrainState) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    _flatten("params", state.named_params(), out)
    _flatten("opt_state", state.opt_state, out)
    out["step"] = state.step
    if state.err_feedback is not None:
        _flatten("err_feedback", state.err_feedback, out)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise NotImplementedError("bfloat16 leaves have no numpy dtype; the "
                                  "port checkpoints float32 parameters")
    return t.detach().to("cpu", copy=True).numpy()   # a snapshot, not a view


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _mesh_shards(t: DTensor):
    """(the distinct shards as {k: global slices}, this rank's k or None
    when another rank writes its shard)."""
    from repro_torch.distributed.sharding import local_slices
    mesh, pls = t.device_mesh, t.placements
    sizes = list(mesh.mesh.shape)
    split = [i for i, (p, s) in enumerate(zip(pls, sizes))
             if isinstance(p, Shard) and s > 1]
    shards = {}
    for k, sub in enumerate(itertools.product(*(range(sizes[i])
                                                for i in split))):
        coord = [0] * len(sizes)
        for i, c in zip(split, sub):
            coord[i] = c
        shards[k] = local_slices(t.shape, pls, mesh, coord)
    mine = mesh.get_coordinate()
    k = 0
    for i in split:
        k = k * sizes[i] + mine[i]
    writer = all(mine[i] == 0 for i in range(len(sizes)) if i not in split)
    return shards, (k if writer else None)


def _index_json(sl, shape) -> List[List[int]]:
    return [[s.start, s.stop] for s in sl] if sl else \
        [[0, n] for n in shape]


def _plan(state: TrainState) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """(index leaves, {file: host snapshot of a shard this rank writes})."""
    leaves, files = {}, {}
    rank = _rank()
    for lid, t in state_leaves(state).items():
        if isinstance(t, DTensor):
            shards, mine = _mesh_shards(t)
            snap = _to_numpy(t.to_local()) if mine is not None else None
            dtype = str(snap.dtype) if snap is not None else \
                str(_to_numpy(t.to_local().reshape(-1)[:0]).dtype)
            entry = {"shape": list(t.shape), "dtype": dtype,
                     "shards": [{"file": f"{lid}.s{k}.npy",
                                 "index": _index_json(sl, t.shape)}
                                for k, sl in shards.items()]}
            if mine is not None:
                files[f"{lid}.s{mine}.npy"] = snap
        else:
            arr = _to_numpy(t)
            entry = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                     "shards": [{"file": f"{lid}.s0.npy",
                                 "index": _index_json(None, arr.shape)}]}
            if rank == 0:
                files[f"{lid}.s0.npy"] = arr
        leaves[lid] = entry
    return leaves, files


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
def _barrier(group) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)


def _write(leaves: Dict[str, Any], files: Dict[str, np.ndarray],
           ckpt_dir: str, step: int, *, extra: Optional[Dict], keep: int,
           group=None) -> str:
    """Every rank writes its files; rank 0 commits after a barrier."""
    rank = _rank()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp0"
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    _barrier(group)
    for fname, arr in files.items():
        np.save(os.path.join(tmp, fname), arr)
    _barrier(group)
    if rank == 0:
        index = {"step": step, "treedef": None, "leaves": leaves,
                 "extra": extra or {}}
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _write_latest(ckpt_dir, step)
        _gc(ckpt_dir, keep)
    _barrier(group)
    return final


def save(state: TrainState, ckpt_dir: str, step: int, *,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write a checkpoint of ``state`` for ``step`` (copies its shards to
    the host first); every rank of a sharded state calls it.  Returns the
    committed directory."""
    leaves, files = _plan(state)
    return _write(leaves, files, ckpt_dir, step, extra=extra, keep=keep)


def _write_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and "." not in d)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


# ---------------------------------------------------------------------------
# async wrapper
# ---------------------------------------------------------------------------
class AsyncCheckpointer:
    """Saves on a background thread (one in flight).  The copy to the host
    happens in ``save`` itself, so the snapshot is the state at the call
    even though training goes on changing it in place.  Under a process
    group every rank constructs one (a collective: it makes the gloo group
    that the thread's barriers run on)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        self._group = dist.new_group(backend="gloo") \
            if dist.is_initialized() else None

    def save(self, state: TrainState, step: int,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        leaves, files = _plan(state)

        def work():
            try:
                _write(leaves, files, self.ckpt_dir, step, extra=extra,
                       keep=self.keep, group=self._group)
            except BaseException as e:  # pragma: no cover
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------
def _index(ckpt_dir: str, step: Optional[int]) -> Tuple[str, Dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        return d, json.load(f)


def _assemble(d: str, entry: Dict, want: Tuple[slice, ...]) -> np.ndarray:
    """The global slice ``want`` of a saved leaf, from the shard files
    that overlap it (each read through a memory map)."""
    shape = tuple(entry["shape"])
    lo_hi = [(s.start, s.stop) for s in want] if want else []
    out = np.zeros([b - a for a, b in lo_hi], np.dtype(entry["dtype"]))
    for sh in entry["shards"]:
        have = [tuple(x) for x in sh["index"]]
        inter = [(max(a, c), min(b, e))
                 for (a, b), (c, e) in zip(lo_hi, have)]
        if any(a >= b for a, b in inter):
            continue
        src = tuple(slice(a - c, b - c) for (a, b), (c, _) in zip(inter, have))
        dst = tuple(slice(a - w, b - w) for (a, b), (w, _) in zip(inter, lo_hi))
        data = np.load(os.path.join(d, sh["file"]), mmap_mode="r")
        out[dst] = data[src]
    return out


def _nest(flat: Dict[str, np.ndarray]) -> Dict:
    """{'a.b.0': x} -> {'a': {'b': {'0': x}}}; digit keys of a level
    become a list."""
    root: Dict = {}
    for lid, arr in flat.items():
        node = root
        parts = lid.split(".")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def _from_jax_layout(d: str, index: Dict, state: TrainState
                     ) -> Dict[str, np.ndarray]:
    """A JAX-package TrainState checkpoint -> the port's leaf ids."""
    from repro_torch.weights import train_state_from_reference
    children: Dict[str, Dict[str, np.ndarray]] = {}
    for lid, entry in index["leaves"].items():
        # '[<flat index 1>].m.embed', or a bare child '[<flat index 2>]'
        m = re.fullmatch(r"\[<flat index (\d+)>\](?:\.(.*))?", lid)
        if m is None:
            raise ValueError(f"unexpected leaf id {lid!r}")
        full = tuple(slice(0, n) for n in entry["shape"])
        children.setdefault(_JAX_CHILDREN[int(m.group(1))], {})[
            m.group(2) or ""] = _assemble(d, entry, full)
    tree = {k: (v[""] if "" in v else _nest(v)) for k, v in children.items()}
    ref = train_state_from_reference(tree["params"], tree["opt_state"],
                                     tree["step"], state.params.cfg)
    return {lid: _to_numpy(t) for lid, t in state_leaves(ref).items()}


def _leaf_refs(prefix: str, tree: Any, out: Dict[str, Tuple[dict, str]]
               ) -> None:
    """{leaf id: (the dict that holds it, its key)}, as ``_flatten``."""
    for k, v in tree.items():
        lid = f"{prefix}.{k}"
        if isinstance(v, dict):
            _leaf_refs(lid, v, out)
        else:
            out[lid] = (tree, k)


def load(ckpt_dir: str, state: TrainState, step: Optional[int] = None, *,
         placements: Optional[Dict[str, tuple]] = None
         ) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint into ``state``'s tensors (in place, on their
    devices; a DTensor gets its rank's slice).  ``placements``: {leaf id:
    DTensor placements} to rebuild a DTensor leaf with, over its mesh.
    Returns (state, extra)."""
    from repro_torch.distributed.sharding import local_slices
    d, index = _index(ckpt_dir, step)
    get: Callable[[str, Tuple[slice, ...]], np.ndarray]
    if any(lid.startswith(_JAX_PREFIX) for lid in index["leaves"]):
        arrays = _from_jax_layout(d, index, state)
        entries = {lid: {"shape": list(a.shape)} for lid, a in arrays.items()}

        def get(lid, sl):
            return arrays[lid][sl]
    else:
        entries = index["leaves"]

        def get(lid, sl):
            return _assemble(d, entries[lid], sl)
    want = state_leaves(state)
    missing = sorted(set(want) - set(entries))
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing[:5]}")
    placements = placements or {}
    with torch.no_grad():
        for lid, t in want.items():
            shape = tuple(entries[lid]["shape"])
            if tuple(t.shape) != shape:
                raise ValueError(f"{lid}: target shape {tuple(t.shape)} != "
                                 f"saved {shape}")
            if not isinstance(t, DTensor):
                t.copy_(torch.as_tensor(
                    get(lid, tuple(slice(0, n) for n in shape))))
                continue
            mesh = t.device_mesh
            pls = tuple(placements.get(lid, t.placements))
            sl = local_slices(shape, pls, mesh, mesh.get_coordinate())
            part = torch.as_tensor(get(lid, sl))
            if pls == tuple(t.placements):
                t.to_local().copy_(part)
            else:
                local = part.to(device=t.to_local().device,
                                dtype=t.dtype).contiguous()
                refs: Dict[str, Tuple[dict, str]] = {}
                for name in ("params", "opt_state", "err_feedback"):
                    tree = getattr(state, name)
                    if isinstance(tree, dict):
                        _leaf_refs(name, tree, refs)
                holder, key = refs[lid]
                holder[key] = DTensor.from_local(local, mesh, pls,
                                                 run_check=False)
    return state, index.get("extra", {})
