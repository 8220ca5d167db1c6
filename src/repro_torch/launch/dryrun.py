"""Dry run: the memory and cost plan of one rank of every (arch x shape x
mesh) cell, with nothing allocated (the JAX package's
``launch/dryrun.py``).

For each cell this driver builds the port's sharded program on the meta
device (the serving mesh branch of ``serving/serve_step.py`` for decode
and prefill cells, the trainer's mesh branch for train cells) as rank 0
of a fake process group of the production mesh's size (16 x 16 = 256
ranks, or 2 x 16 x 16 = 512), runs one step, and records:

  * ``memory`` -- argument bytes per device, exact from the rules' local
    shapes: the parameters at the port's dtypes (fp32; the bf16 serving
    copy the JAX package plans is printed beside them), the optimizer
    slots of a train cell, the KV cache of a serve cell and the inputs;
    and, from the traced step (``launch/op_stats.py``), the bytes it
    returns and the peak of the bytes it holds (``temp_bytes``).
  * ``cost`` -- the step's flops and bytes accessed (``op_stats``).
  * ``collectives`` -- each collective's count and operand bytes.

A cell that ``cell_supported`` rejects records ``skipped`` with the
reason; its ``memory`` needs no trace and is written all the same.
Records are JSON files under ``build/dryrun_torch/``.  Usage:

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \
        --mesh single --seq-parallel

``--mesh-shape 1x1 --batch 8 --seq-len 256`` plans a cell of another
size on another (data x model) mesh (``chip_smoke.py`` plans the card's
served cell so).  ``--seq-parallel`` plans a train cell with the residual
stream sharded over ``model`` on the sequence (its record's name ends in
``__seqpar``).  The process must have no process group of its own: the
dry run starts a fake one (``torch.testing``'s ``FakeStore``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (SHAPES, ShapeSpec, cell_supported,
                                 get_config, list_archs, param_count)
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch import op_stats
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model
from repro_torch.serving.serve_step import build_serve_fns

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun_torch")
COLLECTIVES = op_stats.COLLECTIVES


def _train_grad_accum(shape: ShapeSpec) -> int:
    # the JAX package's choice: small per-rank microbatches at batch >= 64
    accum = 8 if shape.global_batch >= 64 else 1
    while shape.global_batch % accum:
        accum //= 2
    return max(accum, 1)


# ---------------------------------------------------------------------------
# memory: argument bytes per device from the rules, no trace
# ---------------------------------------------------------------------------
def _local_bytes(t: torch.Tensor, spec, sizes, dtype=None) -> int:
    dt = dtype if dtype is not None else t.dtype
    n = math.prod(SH.local_shape(t.shape, spec, sizes))
    return n * torch.empty((), dtype=dt).element_size()


def _tree_bytes(tensors, specs, sizes) -> int:
    if isinstance(tensors, dict):
        return sum(_tree_bytes(tensors[k], specs[k], sizes) for k in tensors)
    if isinstance(tensors, (list, tuple)):
        return sum(_tree_bytes(t, s, sizes) for t, s in zip(tensors, specs))
    return _local_bytes(tensors, specs, sizes)


def plan_memory(cfg, shape: ShapeSpec, sizes: Dict[str, int],
                moe_impl: str = "gshard") -> Dict[str, int]:
    """Argument bytes per device of the cell's step: parameters (fp32,
    and the bf16 serving copy), optimizer slots (train), cache and
    inputs (serve)."""
    train = shape.kind == "train"
    module = build_model(cfg, moe_impl=moe_impl).init(L.ShapeOnly())
    params = dict(module.named_parameters())
    pspecs = SH.param_pspecs(cfg, params, sizes, "train" if train else
                             "serve")
    p_bytes = sum(_local_bytes(t, pspecs[n], sizes) for n, t in
                  params.items())
    serve_dt = getattr(torch, cfg.dtype)
    p16 = sum(_local_bytes(t, pspecs[n], sizes,
                           serve_dt if t.is_floating_point() else None)
              for n, t in params.items())
    inputs, ispecs = M.input_specs(cfg, shape, sizes)
    B = shape.global_batch
    b = SH.batch_axes(sizes, B)
    if shape.kind == "decode":        # the step's active mask
        inputs["active"] = torch.empty((B,), dtype=torch.bool, device="meta")
        ispecs["active"] = (b,)
    elif shape.kind == "prefill":     # its valid counts
        inputs["valid_n"] = torch.empty((B,), dtype=torch.int32,
                                        device="meta")
        ispecs["valid_n"] = (b,)
    out = {"param_bytes": p_bytes, "param_bytes_bf16": p16,
           "input_bytes": _tree_bytes(inputs, ispecs, sizes)}
    if train:
        from repro_torch.training.trainer import opt_state_pspecs
        shapes = {n: tuple(t.shape) for n, t in params.items()}
        slot_shapes = opt_state_pspecs(cfg, shapes, shapes)
        slot_specs = opt_state_pspecs(cfg, shapes, pspecs)

        def slots(sh, sp):
            if isinstance(sh, dict):
                return sum(slots(sh[k], sp[k]) for k in sh)
            return 4 * math.prod(SH.local_shape(sh, sp, sizes))
        # fp32 slots, plus the optimizer's and the state's step counters
        out["opt_bytes"] = slots(slot_shapes, slot_specs) + 2 * 4
        args = p_bytes + out["opt_bytes"] + out["input_bytes"]
    else:
        cache, cspecs = M.cache_specs(cfg, shape, sizes)
        out["cache_bytes"] = _tree_bytes(cache, cspecs, sizes)
        args = p_bytes + out["cache_bytes"] + out["input_bytes"]
        out["argument_bytes_bf16"] = (p16 + out["cache_bytes"]
                                      + out["input_bytes"])
    out["argument_bytes"] = args
    return out


# ---------------------------------------------------------------------------
# cost: one rank's step on the meta device
# ---------------------------------------------------------------------------
def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (collectives return at once; nothing is sent)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs a process without a "
                               f"process group ({dist.get_backend()} runs)")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def trace_step(cfg, shape: ShapeSpec, sizes: Dict[str, int],
               moe_impl: str = "gshard", seq_parallel: bool = False) -> Dict:
    """``op_stats.analyze`` of rank 0's step of the cell on meta tensors
    (``seq_parallel``: a train cell's residual stream sharded over
    ``model`` on the sequence)."""
    from torch.distributed.device_mesh import init_device_mesh
    fake_group(math.prod(sizes.values()))
    mesh = init_device_mesh("cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))
    B, S = shape.global_batch, shape.seq_len
    inputs, _ = M.input_specs(cfg, shape, sizes)
    if shape.kind == "train":
        from repro_torch.training.trainer import build_trainer
        trainer = build_trainer(cfg, mesh, grad_accum=_train_grad_accum(
            shape), device="meta", seq_parallel=seq_parallel)
        state = trainer.init_state(0)
        return op_stats.analyze(trainer.train_step, state, inputs)
    fns = build_serve_fns(cfg, mesh, batch=B, max_len=S, moe_impl=moe_impl,
                          device="meta", prefill_chunk=S,
                          shard_cache_length=(shape.kind == "decode"
                                              and B == 1))
    module, cache = fns.init_params(0), fns.init_cache()
    lengths = inputs["lengths"]
    if shape.kind == "decode":
        active = torch.empty((B,), dtype=torch.bool, device="meta")
        return op_stats.analyze(fns.decode, module, cache, inputs["tokens"],
                                lengths, active)
    return op_stats.analyze(fns.prefill_chunk, module, cache,
                            inputs["tokens"], lengths,
                            torch.empty_like(lengths))


# ---------------------------------------------------------------------------
# cell driver
# ---------------------------------------------------------------------------
def mesh_label(sizes: Dict[str, int]) -> str:
    if sizes == M.production_mesh_sizes(False):
        return "singlepod"
    if sizes == M.production_mesh_sizes(True):
        return "multipod"
    return "x".join(str(n) for n in sizes.values())


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             moe_impl: str = "gshard", save: bool = True,
             attn_impl: Optional[str] = None, seq_parallel: bool = False,
             tag: str = "", sizes: Optional[Dict[str, int]] = None,
             batch: Optional[int] = None, seq_len: Optional[int] = None,
             out_dir: str = RESULTS_DIR) -> Dict:
    cfg = get_config(arch)
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    shape = SHAPES[shape_name]
    if batch or seq_len:
        shape = dataclasses.replace(shape, global_batch=batch or
                                    shape.global_batch,
                                    seq_len=seq_len or shape.seq_len)
    sizes = dict(sizes or M.production_mesh_sizes(multi_pod))
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_label(sizes),
                 "kind": shape.kind, "moe_impl": moe_impl, "tag": tag,
                 "seq_parallel": bool(seq_parallel and shape.kind == "train"),
                 "params": param_count(cfg), "batch": shape.global_batch,
                 "seq_len": shape.seq_len,
                 "devices": math.prod(sizes.values())}
    rec["memory"] = plan_memory(cfg, shape, sizes, moe_impl)
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        rec["skipped"] = reason
        if save:
            _save(rec, tag, out_dir)
        return rec
    t0 = time.time()
    hs = trace_step(cfg, shape, sizes, moe_impl, seq_parallel)
    rec["trace_s"] = round(time.time() - t0, 1)
    m = rec["memory"]
    m["output_bytes"] = int(hs["output_bytes"])
    m["temp_bytes"] = int(hs["live_bytes"])
    m["peak_bytes_est"] = m["argument_bytes"] + m["temp_bytes"]
    rec["cost"] = {"flops": hs["flops"], "bytes_accessed": hs["bytes"]}
    rec["kernels"] = hs["kernels"]
    rec["collectives"] = {
        **{c: {"bytes": hs[c], "count": int(hs[c + "_count"])}
           for c in COLLECTIVES},
        "total_bytes": hs["collective_bytes"]}
    if save:
        _save(rec, tag, out_dir)
    return rec


def _save(rec: Dict, tag: str = "", out_dir: str = RESULTS_DIR) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = (f"__{tag}" if tag else "") + (
        "__seqpar" if rec.get("seq_parallel") else "")
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)


def _gib(n: float) -> str:
    return f"{n / 2**30:.2f} GiB"


def _print_rec(rec: Dict) -> None:
    m = rec["memory"]
    head = f"{rec['arch']} x {rec['shape']} x {rec['mesh']}"
    args = (f"       mem/device: args {_gib(m['argument_bytes'])} "
            f"({m['argument_bytes']} B; params {_gib(m['param_bytes'])} "
            f"fp32, {_gib(m['param_bytes_bf16'])} as a bf16 copy")
    args += (f", opt {_gib(m['opt_bytes'])})" if "opt_bytes" in m else
             f", cache {_gib(m['cache_bytes'])}; bf16 params: args "
             f"{_gib(m['argument_bytes_bf16'])})")
    if "skipped" in rec:
        print(f"[skip] {head}: {rec['skipped']}")
        print(args)
        return
    c = rec["collectives"]
    print(f"[ ok ] {head} (trace {rec['trace_s']}s)")
    print(args)
    print(f"       temp {_gib(m['temp_bytes'])}, out "
          f"{_gib(m['output_bytes'])}")
    print(f"       flops/device: {rec['cost']['flops']:.3e}   bytes/device: "
          f"{rec['cost']['bytes_accessed']:.3e}   collective bytes/device: "
          f"{c['total_bytes']:.3e}")
    per = {k: v for k, v in c.items()
           if isinstance(v, dict) and v["count"]}
    if per:
        print("       " + "  ".join(
            f"{k}:{v['count']}x/{v['bytes']:.2e}B" for k, v in per.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-impl", default="gshard")
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel residual stream (train cells)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--subprocess-per-cell", action="store_true",
                    help="isolate each cell in a fresh process")
    ap.add_argument("--mesh-shape", default=None,
                    help="a (data x model) mesh such as 1x1 in place of "
                         "the production meshes")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--out-dir", default=RESULTS_DIR,
                    help="where the records go (default build/dryrun_torch)")
    args = ap.parse_args(argv)

    if args.mesh_shape:
        dims = M.parse_mesh(args.mesh_shape)
        meshes = [dict(zip(("data", "model"), dims))]
    else:
        meshes = [M.production_mesh_sizes(mp) for mp in
                  {"single": [False], "multi": [True],
                   "both": [False, True]}[args.mesh]]
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for sizes in meshes:
            label = mesh_label(sizes)
            if args.subprocess_per_cell and len(cells) > 1:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape,
                       "--moe-impl", args.moe_impl]
                cmd += (["--mesh-shape", args.mesh_shape] if args.mesh_shape
                        else ["--mesh", "multi" if "pod" in sizes
                              else "single"])
                if args.seq_parallel:
                    cmd.append("--seq-parallel")
                for flag, val in (("--attn-impl", args.attn_impl),
                                  ("--tag", args.tag),
                                  ("--out-dir", args.out_dir),
                                  ("--batch", args.batch),
                                  ("--seq-len", args.seq_len)):
                    if val:
                        cmd += [flag, str(val)]
                r = subprocess.run(cmd)
                failures += (r.returncode != 0)
                continue
            try:
                rec = run_cell(arch, shape, "pod" in sizes,
                               moe_impl=args.moe_impl,
                               attn_impl=args.attn_impl,
                               seq_parallel=args.seq_parallel, tag=args.tag,
                               sizes=sizes, batch=args.batch,
                               seq_len=args.seq_len, out_dir=args.out_dir)
                _print_rec(rec)
            except Exception as e:  # noqa: BLE001 -- a cell's failure is its
                failures += 1       # [FAIL] line; the other cells go on
                print(f"[FAIL] {arch} x {shape} x {label}: {e!r}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
