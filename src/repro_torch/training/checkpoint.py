"""Checkpoints of a one-device TrainState, in the JAX package's layout.

    ckpt_dir/
      step_00000420/
        index.json            # leaves: shape, dtype, shard files; extra
        <leaf-id>.s0.npy      # one file per leaf (the whole array)
      LATEST                  # atomically replaced pointer file

A save writes into a temporary directory and commits it by renaming,
then rewrites LATEST, so a torn save is never visible; the data
pipeline's state rides in ``index.json``'s ``extra``.  The port's leaf ids
are ``params.<name>``, ``opt_state.<slot>.<name>[.<part>]`` and
``step``.  ``load`` also reads a checkpoint that the JAX package's
``training.checkpoint.save`` wrote for an unsharded TrainState (leaf ids
``[<flat index 0>].embed`` ...): it rebuilds that tree and converts it
with ``weights.train_state_from_reference``.  Sharded saves and the
elastic reshard of the JAX package are not ported.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise NotImplementedError("bfloat16 leaves have no numpy dtype; the "
                                  "port checkpoints float32 parameters")
    return t.detach().to("cpu", copy=True).numpy()   # a snapshot, not a view


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
def save_arrays(arrays: Dict[str, np.ndarray], ckpt_dir: str, step: int, *,
                extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write host arrays as the checkpoint of ``step``; returns the
    committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp0"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index: Dict[str, Any] = {"step": step, "treedef": None, "leaves": {},
                             "extra": extra or {}}
    for lid, arr in arrays.items():
        fname = f"{lid}.s0.npy"
        np.save(os.path.join(tmp, fname), arr)
        index["leaves"][lid] = {
            "shape": list(arr.shape), "dtype": str(arr.dtype),
            "shards": [{"file": fname,
                        "index": [[0, n] for n in arr.shape]}]}
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _write_latest(ckpt_dir, step)
    _gc(ckpt_dir, keep)
    return final


def save(state: TrainState, ckpt_dir: str, step: int, *,
         extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Write a checkpoint of ``state`` for ``step`` (copies it to the
    host first); returns the committed directory."""
    arrays = {lid: _to_numpy(t) for lid, t in state_leaves(state).items()}
    return save_arrays(arrays, ckpt_dir, step, extra=extra, keep=keep)


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
    even though training goes on changing it in place."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, state: TrainState, step: int,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        arrays = {lid: _to_numpy(t) for lid, t in state_leaves(state).items()}

        def work():
            try:
                save_arrays(arrays, self.ckpt_dir, step, extra=extra,
                            keep=self.keep)
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
def _read(ckpt_dir: str, step: Optional[int]) -> Tuple[Dict[str, np.ndarray],
                                                       Dict]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no LATEST in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    arrays = {}
    for lid, entry in index["leaves"].items():
        shape = tuple(entry["shape"])
        out = np.zeros(shape, np.dtype(entry["dtype"]))
        for sh in entry["shards"]:
            dst = tuple(slice(a, b) for a, b in sh["index"])
            out[dst] = np.load(os.path.join(d, sh["file"]))
        arrays[lid] = out
    return arrays, index.get("extra", {})


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


def _from_jax_layout(arrays: Dict[str, np.ndarray], state: TrainState,
                     cfg) -> Dict[str, np.ndarray]:
    """A JAX-package TrainState checkpoint -> the port's leaf ids."""
    from repro_torch.weights import train_state_from_reference
    children: Dict[str, Dict[str, np.ndarray]] = {}
    for lid, arr in arrays.items():
        # '[<flat index 1>].m.embed', or a bare child '[<flat index 2>]'
        m = re.fullmatch(r"\[<flat index (\d+)>\](?:\.(.*))?", lid)
        if m is None:
            raise ValueError(f"unexpected leaf id {lid!r}")
        children.setdefault(_JAX_CHILDREN[int(m.group(1))], {})[
            m.group(2) or ""] = arr
    tree = {k: (v[""] if "" in v else _nest(v)) for k, v in children.items()}
    ref = train_state_from_reference(tree["params"], tree["opt_state"],
                                     tree["step"], cfg)
    return {lid: _to_numpy(t) for lid, t in state_leaves(ref).items()}


def load(ckpt_dir: str, state: TrainState, step: Optional[int] = None
         ) -> Tuple[TrainState, Dict]:
    """Restore a checkpoint into ``state``'s tensors (in place, on their
    devices).  Returns (state, extra)."""
    arrays, extra = _read(ckpt_dir, step)
    if any(lid.startswith(_JAX_PREFIX) for lid in arrays):
        arrays = _from_jax_layout(arrays, state, state.params.cfg)
    want = state_leaves(state)
    missing = sorted(set(want) - set(arrays))
    if missing:
        raise KeyError(f"checkpoint missing leaves {missing[:5]}")
    with torch.no_grad():
        for lid, t in want.items():
            arr = arrays[lid]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{lid}: target shape {tuple(t.shape)} != "
                                 f"saved {arr.shape}")
            t.copy_(torch.as_tensor(arr))
    return state, extra
