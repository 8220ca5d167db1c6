"""One rank of the port's sharded-serving CPU tests (gloo), started by
``tests/test_torch_serve_mesh.py``,
``tests/test_torch_serve_mesh_families.py`` and
``tests/test_torch_dryrun.py`` through ``tests/_torch_dist.py``; imports
torch and the port only.

    python tests/_torch_serve_worker.py IN_DIR OUT_DIR
    python tests/_torch_serve_worker.py opstats OUT_DIR

``IN_DIR/cases.json`` lists the cases ({name, arch, changes, meshes,
inputs}); ``IN_DIR/<name>.pt`` holds each case's whole weights (the
reference's, carried into the port by the test).  For every case and
mesh every rank serves ``serve_mixed_slo`` through
``ModelExecutor(mesh=)``, runs a ragged prefill and greedy decode steps
through the mesh branch's ``prefill_chunk`` / ``decode`` (the decode
logits from one-token chunks on a second cache; an encoder-decoder's
first prefill encodes the case's ``frames``), resets slots, and writes
``<name>__<mesh>__r<rank>.json`` / ``.npz``.

``opstats``: one decode step of the Qwen3 smoke config (fp32,
``chunked``) on the (1, 4) mesh under ``launch/op_stats.analyze``;
every rank writes ``opstats_r<rank>.json``.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from repro_torch.api import ServeRuntime, get_scenario
from repro_torch.configs import smoke_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import op_stats
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import ModelExecutor
from repro_torch.serving.serve_step import build_serve_fns

SCENARIO_KW = dict(tenants=3, requests=6, max_len=64, prefill_chunk=16)


def case_cfg(case):
    return dataclasses.replace(smoke_config(case["arch"]), dtype="float32",
                               **case["changes"])


def whole_module(cfg, path):
    module = build_model(cfg).init(torch.Generator().manual_seed(0))
    module.load_state_dict(torch.load(path))
    return module


def serve_report(cfg, weights, mesh):
    spec = get_scenario("serve_mixed_slo", vocab=cfg.vocab_size,
                        **SCENARIO_KW)
    rt = ServeRuntime.from_spec(spec, executor=lambda e: ModelExecutor(
        cfg, e, params=whole_module(cfg, weights), device="cpu", mesh=mesh))
    rep = rt.run(spec)
    toks = {str(r.rid): [int(t) for t in r.generated] for r in rt.engine.done}
    return rep.to_json(), toks


def logits_run(cfg, module, mesh, inp):
    """Ragged prefill (given ``frames``, encoding them first) and greedy
    decode steps, with a reset of the slots ``keep`` drops before step
    ``reset_at``; every logit (B, V) and token the serve functions return
    (one device when ``mesh`` is None), the cache's local shapes (at init
    and at the end) and whether the reset left the dropped rows'
    positions at -1."""
    B, T = inp["batch"], inp["max_len"]
    fns = build_serve_fns(cfg, mesh, batch=B, max_len=T, device="cpu")
    module = fns.place(module)
    cache, cache2 = fns.init_cache(), fns.init_cache()
    shapes = [{k: list(t.shape) for k, t in layer.items()} for layer in cache]
    toks = torch.tensor(inp["prompt"], dtype=torch.int32)
    lens = torch.zeros(B, dtype=torch.int32)
    vn = torch.tensor(inp["valid_n"], dtype=torch.int32)
    frames = (torch.tensor(inp["frames"], dtype=torch.float32)
              if "frames" in inp else None)
    out = {}
    nxt, last, _ = fns.prefill_chunk(module, cache, toks, lens, vn,
                                     frames=frames)
    fns.prefill_chunk(module, cache2, toks, lens, vn, frames=frames)
    out["prefill"], out["prefill_tokens"] = last, nxt
    lens = lens + vn
    ones = torch.ones(B, dtype=torch.int32)
    active = torch.ones(B, dtype=torch.bool)
    keep = torch.tensor(inp["keep"])
    dropped = ~(keep if fns.layout is None else fns.layout.local_rows(keep))
    cleared = None
    for i in range(inp["steps"]):
        if i == inp["reset_at"]:
            fns.reset_slots(cache, keep)
            fns.reset_slots(cache2, keep)
            cleared = all(bool((t[dropped] == (-1 if k == "pos" else 0))
                               .all()) for layer in cache
                          for k, t in layer.items()
                          if k in ("pos", "state", "h")
                          or k.startswith("conv"))
            lens = torch.where(keep, lens, 0)
        _, logit, _ = fns.prefill_chunk(module, cache, nxt[:, None], lens,
                                        ones)
        dec, _ = fns.decode(module, cache2, nxt, lens, active)
        out[f"decode{i}"], out[f"decode{i}_tokens"] = logit, dec
        nxt = dec
        lens = lens + 1
    after = [{k: list(t.shape) for k, t in layer.items()} for layer in cache]
    return ({k: v.numpy() for k, v in out.items()}, dict(init=shapes,
                                                         end=after), cleared)


def main(in_dir: str, out_dir: str) -> None:
    rank, _ = init_distributed("cpu")
    with open(os.path.join(in_dir, "cases.json")) as f:
        cases = json.load(f)
    for case in cases:
        cfg = case_cfg(case)
        weights = os.path.join(in_dir, case["name"] + ".pt")
        for shape in case["meshes"]:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            tag = f"{case['name']}__{shape[0]}x{shape[1]}__r{rank}"
            report, toks = serve_report(cfg, weights, mesh)
            arrays, shapes, cleared = logits_run(
                cfg, whole_module(cfg, weights), mesh, case["inputs"])
            np.savez(os.path.join(out_dir, tag + ".npz"), **arrays)
            with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                json.dump(dict(report=report, tokens=toks,
                               cache_shapes=shapes["init"],
                               cache_shapes_end=shapes["end"],
                               reset_cleared=cleared,
                               coord=mesh.get_coordinate(),
                               sizes=SH.mesh_sizes(mesh)), f)


def opstats(out_dir: str) -> None:
    rank, _ = init_distributed("cpu")
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                              attn_impl="chunked")
    B = 8
    fns = build_serve_fns(cfg, make_mesh((1, 4), ("data", "model"), "cpu"),
                          batch=B, max_len=64, device="cpu")
    module, cache = fns.init_params(0), fns.init_cache()
    stats = op_stats.analyze(fns.decode, module, cache,
                             torch.ones(B, dtype=torch.int32),
                             torch.full((B,), 10, dtype=torch.int32),
                             torch.ones(B, dtype=torch.bool))
    with open(os.path.join(out_dir, f"opstats_r{rank}.json"), "w") as f:
        json.dump(dict(stats, layers=cfg.num_layers), f)


if __name__ == "__main__":
    if sys.argv[1] == "opstats":
        opstats(sys.argv[2])
    else:
        main(sys.argv[1], sys.argv[2])
