"""One rank of the port's distributed CPU tests (gloo), started by
``tests/_torch_dist.py``; imports torch and the port only.

    python tests/_torch_dist_worker.py CASE OUT_DIR

CASE is one of distributed, training, tp and tp_families.

``distributed``: the collectives, compression and GPipe on seeded numpy
inputs; every rank writes ``distributed_r<rank>.npz``.
``training``: 3 sharded train steps of the Qwen3, DeepSeek-V2-Lite and
Mamba2 smoke configs on meshes (2, 2) and (4, 1) (rank 0 writes each
run's losses, grad norms and gathered parameters), a checkpoint saved on
(2, 2) and loaded back on (4, 1), (1, 4) and with transposed placements.
``tp``: 3 steps of each ``TP_RUNS`` case (tensor-parallel compute, with
and without ``seq_parallel``; rank 0 writes the losses, grad norms,
gathered parameters and every rank's compute-module shapes), and one run
whose gradient rule counts the replicated 1-D weights' gradients
``model`` times (``TP_WRONG``).
``tp_families``: the same for each ``TP_FAMILY_RUNS`` case (MLA, the SSD
and RG-LRU mixers and the encoder-decoder computed tensor-parallel), and
one run whose SSD gated norm normalises this rank's channels alone
(``GATE_NORM_WRONG``).

The one-device references the tests hold these runs to are here too
(``one_device_run``, ``one_device_grads``), with the pattern of the
weight names the blocks compute on as ``model`` slices (``TP_WEIGHTS``).
"""
import dataclasses
import functools
import json
import os
import re
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs import smoke_config
from repro_torch.distributed import collectives as COL
from repro_torch.distributed import compression as Q
from repro_torch.distributed import pipeline as PP
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_mesh)
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.data import SyntheticLM
from repro_torch.training.trainer import build_trainer

SEQ, BATCH, STEPS = 16, 4, 3
TRAIN_KW = dict(total_steps=10, warmup_steps=2, device="cpu")
ARCHS = {"qwen3": ("qwen3-8b", {}),
         "qwen3_adafactor": ("qwen3-8b", {"optimizer": "adafactor"}),
         "deepseek": ("deepseek-v2-lite-16b", {}),
         "mamba2": ("mamba2-370m", {})}
MESHES = {"qwen3": [(2, 2), (4, 1)], "qwen3_adafactor": [(2, 2)],
          "deepseek": [(2, 2), (4, 1)], "mamba2": [(2, 2), (4, 1)]}
ACCUM_CASE = ("qwen3", (2, 2), 2)      # grad accumulation 2 on (2, 2)


# the tensor-parallel cases: (config, mesh (data, model), seq_parallel)
TP_ARCHS = {"qwen3": ("qwen3-8b", {}),
            "qwen3_kv2": ("qwen3-8b", {"num_kv_heads": 2}),
            "qwen3_pallas": ("qwen3-8b", {"attn_impl": "pallas"}),
            "qwen3_adafactor": ("qwen3-8b", {"optimizer": "adafactor",
                                             "scan_layers": False}),
            "deepseek": ("deepseek-v2-lite-16b", {}),
            "mamba2": ("mamba2-370m", {})}
TP_RUNS = ([("qwen3", s, sp) for s in ((1, 4), (2, 2))
            for sp in (False, True)]
           + [("qwen3_kv2", (1, 4), sp) for sp in (False, True)]
           + [("qwen3_pallas", (1, 4), False)]
           + [(n, (2, 2), sp) for n in ("deepseek", "mamba2",
                                         "qwen3_adafactor")
              for sp in (False, True)])
TP_WRONG = ("qwen3", (1, 4), False)
# the tensor-parallel families: MLA (with the routed experts), the SSD
# mixer, the RG-LRU mixer with its local attention, the encoder-decoder
FAMILY_ARCHS = {"deepseek": ("deepseek-v2-lite-16b", {}),
                "mamba2": ("mamba2-370m", {}),
                "rgemma": ("recurrentgemma-2b", {}),
                "whisper": ("whisper-large-v3", {})}
TP_FAMILY_RUNS = [(n, s, sp) for n in FAMILY_ARCHS
                  for s in ((2, 2), (1, 4)) for sp in (False, True)]
GATE_NORM_WRONG = ("mamba2", (1, 4), False)
# the weights the blocks compute on as model slices, where the rules
# shard them over ``model``
TP_WEIGHTS = re.compile(
    r"((mixer|cross)\.w[qkvo]|mixer\.b[qkv]|mixer\.w_u[kv]|"
    r"mixer\.(w_[zx]|w_dt|conv_x_[wb]|A_log|D|dt_bias|gate_norm|out_proj)|"
    r"mixer\.(w_gate|conv_[wb]|lambda_|[ai]_gate_[wb]|w_out)|"
    r"(mlp|shared)\.w_(gate|up|down)|moe\.w_(gate|up|down)|^embed|"
    r"^lm_head)$")


def train_cfg(name: str):
    arch, over = {**TP_ARCHS, **FAMILY_ARCHS, **ARCHS}[name]
    kw = {"dtype": "float32", "attn_impl": "chunked", **over}
    return dataclasses.replace(smoke_config(arch), **kw)


def batches(cfg, n: int = STEPS):
    """``n`` SyntheticLM batches (an encoder-decoder's with seeded random
    frames)."""
    src = SyntheticLM(cfg, SEQ, BATCH, seed=0)
    out = [next(src) for _ in range(n)]
    if cfg.is_encoder_decoder:
        rng = np.random.default_rng(5)
        for b in out:
            b["frames"] = rng.standard_normal(
                (BATCH, cfg.num_audio_frames, cfg.d_model)).astype(
                    np.float32)
    return out


@functools.lru_cache(maxsize=None)
def one_device_grads(name):
    """The first batch's gradients of the one-device trainer."""
    cfg = train_cfg(name)
    tr = build_trainer(cfg, **TRAIN_KW)
    _, grads = tr.grads(tr.init_state(0), {
        k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()})
    return {n: g.detach().numpy().copy() for n, g in grads.items()}


@functools.lru_cache(maxsize=None)
def one_device_run(name):
    """(losses, grad norms, final parameters) of ``STEPS`` one-device
    steps."""
    cfg = train_cfg(name)
    tr = build_trainer(cfg, **TRAIN_KW)
    state = tr.init_state(0)
    losses, norms = [], []
    for b in batches(cfg):
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {n: p.detach().numpy().copy()
                           for n, p in state.named_params().items()}


def agrees(got, name) -> bool:
    """Whether a sharded run's losses, grad norms (1e-5 relative) and
    parameters (1e-5 absolute) are the one-device run's."""
    losses, norms, params = one_device_run(name)
    return (np.allclose(got["losses"], losses, rtol=1e-5, atol=0)
            and np.allclose(got["norms"], norms, rtol=1e-5, atol=0)
            and all(np.allclose(got[f"leaf:params.{n}"], p, rtol=0,
                                atol=1e-5) for n, p in params.items()))


def inputs(seed: int = 0):
    """The distributed case's numpy inputs (the test rebuilds them)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((8, 32)).astype(f),
        w=rng.standard_normal((32, 24)).astype(f),
        tiles=rng.standard_normal((4, 3, 5)).astype(f),
        grads=rng.standard_normal((4, 512)).astype(f),
        ws=(rng.standard_normal((8, 16, 16)) * 0.2).astype(f),
        xs=rng.standard_normal((8, 4, 16)).astype(f))


def case_distributed(out: str) -> None:
    rank = dist.get_rank()
    a = inputs()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    res = {}
    m4 = make_host_mesh((1, 4))
    g = m4.get_group("model")
    r = dist.get_rank(g)
    res["ag"] = COL.collective_matmul_ag(t["x"], t["w"][r * 8:(r + 1) * 8], g)
    res["rs"] = COL.reduce_scatter_matmul(
        t["x"][:, r * 8:(r + 1) * 8], t["w"][r * 8:(r + 1) * 8], g)
    res["interleaved"] = COL.all_gather_interleaved(
        t["tiles"][r], g, lambda i, s: s * (i + 1))
    pods = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    res["pods"] = COL.psum_pods_then_data(
        torch.full((3,), float(rank + 1)), pods)
    d4 = make_mesh((4, 1), ("data", "model"), "cpu")
    gd = d4.get_group("data")
    mine = t["grads"][dist.get_rank(gd)]
    comp, err = Q.compress_with_feedback({"g": mine},
                                         {"g": torch.zeros_like(mine)})
    res["psum"] = Q.psum_compressed(comp, gd)["g"]
    res["scale"] = comp["g"].scale
    res["err"] = err["g"]
    pp = make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")

    def layer_stack(ws, x):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    staged = PP.stage_params(t["ws"], 2)
    res["gpipe"] = PP.gpipe(layer_stack, pp, axis="pod")(staged, t["xs"])
    np.savez(os.path.join(out, f"distributed_r{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})


def _full(state):
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
            .detach().numpy() for k, v in CKPT.state_leaves(state).items()}


def run_sharded(name, shape, accum=1, seq_parallel=False):
    cfg = train_cfg(name)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    tr = build_trainer(cfg, mesh, grad_accum=accum,
                       seq_parallel=seq_parallel, **TRAIN_KW)
    state = tr.init_state(0)
    losses, norms = [], []
    for b in batches(cfg):
        state, m = tr.train_step(state, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return tr, state, losses, norms


def case_training(out: str) -> None:
    rank = dist.get_rank()
    runs = [(n, s, 1) for n in ARCHS for s in MESHES[n]] + [ACCUM_CASE]
    saved = None
    for name, shape, accum in runs:
        tr, state, losses, norms = run_sharded(name, shape, accum)
        leaves = _full(state)
        tag = f"{name}_{shape[0]}x{shape[1]}_a{accum}"
        if rank == 0:
            np.savez(os.path.join(out, f"{tag}.npz"),
                     losses=np.array(losses), norms=np.array(norms),
                     **{f"leaf:{k}": v for k, v in leaves.items()})
            with open(os.path.join(out, f"{tag}.placements.json"), "w") as f:
                json.dump({k: [repr(p) for p in v]
                           for k, v in tr.placements.items()}, f)
        if (name, shape, accum) == ("qwen3", (2, 2), 1):
            saved = (state, leaves)
    # the checkpoint: saved on (2, 2) (once through the async writer, whose
    # barriers run on a gloo group of their own), reloaded elsewhere
    state, leaves = saved
    ck = os.path.join(out, "ckpt")
    CKPT.save(state, ck, 3, extra={"step": 3})
    ac = CKPT.AsyncCheckpointer(ck)
    ac.save(state, 4, extra={"step": 4})
    ac.wait()
    report = {}
    cfg = train_cfg("qwen3")
    for shape in ((4, 1), (1, 4), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        tr = build_trainer(cfg, mesh, **TRAIN_KW)
        fresh = tr.init_state(7)
        pls = None
        if shape == (2, 2):     # every sharded leaf with its axes swapped
            pls = {lid: tuple(Shard(p.dim) if isinstance(p, Shard)
                              else Replicate() for p in reversed(v))
                   for lid, v in tr.placements.items()
                   if any(isinstance(p, Shard) for p in v)}
        fresh, extra = CKPT.load(ck, fresh, placements=pls)
        got = _full(fresh)
        tag = f"{shape[0]}x{shape[1]}" + ("_swapped" if pls else "")
        report[tag] = {
            "extra": extra,
            "unequal": sorted(k for k in leaves
                              if not np.array_equal(got[k], leaves[k])),
            "swapped": sorted(k for k, v in CKPT.state_leaves(fresh).items()
                              if pls and k in pls
                              and tuple(v.placements) == pls[k])}
    if rank == 0:
        with open(os.path.join(out, "ckpt_report.json"), "w") as f:
            json.dump(report, f)


def tp_tag(name, shape, sp, wrong=False) -> str:
    return (f"tp_{name}_{shape[0]}x{shape[1]}_sp{int(sp)}"
            + ("_wrong" if wrong else ""))


def first_grads(name, shape, seq_parallel):
    """The first batch's gradients at the initial state, gathered whole."""
    from torch.distributed.tensor import DTensor
    cfg = train_cfg(name)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    tr = build_trainer(cfg, mesh, seq_parallel=seq_parallel, **TRAIN_KW)
    state = tr.init_state(0)
    _, grads = tr.grads(state, {k: torch.from_numpy(v)
                                for k, v in batches(cfg, 1)[0].items()})
    return {n: DTensor.from_local(g, mesh, tr.placements[f"params.{n}"],
                                  run_check=False).full_tensor().numpy()
            for n, g in grads.items()}


def _save_run(out, tag, tr, state, losses, norms, grads) -> None:
    """Rank 0: the run's npz; every rank: its compute module's shapes."""
    leaves = _full(state)
    shapes = {n: list(p.shape) for n, p in
              tr.bind(state).named_parameters()}
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, shapes)
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, f"{tag}.npz"), losses=np.array(losses),
                 norms=np.array(norms),
                 **{f"leaf:{k}": v for k, v in leaves.items()},
                 **{f"grad:{k}": v for k, v in grads.items()})
        with open(os.path.join(out, f"{tag}.shapes.json"), "w") as f:
            json.dump(everyone, f)


def case_tp(out: str) -> None:
    from repro_torch.distributed import parallel as PAR
    for name, shape, sp in TP_RUNS:
        grads = first_grads(name, shape, sp)
        tr, state, losses, norms = run_sharded(name, shape, seq_parallel=sp)
        _save_run(out, tp_tag(name, shape, sp), tr, state, losses, norms,
                  grads)
    # a wrong rule: the norms' gradients, complete on every model rank,
    # summed over ``model`` as well (counted ``model`` times)
    right = PAR.sums_over_model
    PAR.sums_over_model = lambda act, w: w.dim() == 1 or right(act, w)
    try:
        name, shape, sp = TP_WRONG
        grads = first_grads(name, shape, sp)
        tr, state, losses, norms = run_sharded(name, shape, seq_parallel=sp)
    finally:
        PAR.sums_over_model = right
    _save_run(out, tp_tag(name, shape, sp, wrong=True), tr, state, losses,
              norms, grads)


def case_tp_families(out: str) -> None:
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SM
    for name, shape, sp in TP_FAMILY_RUNS:
        grads = first_grads(name, shape, sp)
        tr, state, losses, norms = run_sharded(name, shape, seq_parallel=sp)
        _save_run(out, tp_tag(name, shape, sp), tr, state, losses, norms,
                  grads)
    # a wrong gated norm: each rank normalises its channels alone
    right = SM.gated_norm
    SM.gated_norm = lambda y, scale, eps, width: L.rms_norm(y, scale, eps)
    try:
        name, shape, sp = GATE_NORM_WRONG
        grads = first_grads(name, shape, sp)
        tr, state, losses, norms = run_sharded(name, shape, seq_parallel=sp)
    finally:
        SM.gated_norm = right
    _save_run(out, tp_tag(name, shape, sp, wrong=True), tr, state, losses,
              norms, grads)


def main() -> int:
    case, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    init_distributed("cpu")
    {"distributed": case_distributed, "training": case_training,
     "tp": case_tp, "tp_families": case_tp_families}[case](out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
