"""The plain references against the program's serve step at smoke widths
on the CPU, and the references' isolation from the program.

Run: ``PYTHONPATH=src python -m pytest -q portbench/tests``."""
from __future__ import annotations

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness.bench import bind
from portbench.harness.spec import Cell, model_config
from portbench.reference import dense_gqa, mamba2_ssd
from portbench.reference.common import Precision
from portbench.tests.smoke import REPO, SMOKE_CONFIGS

FAMILIES = {"dense_gqa": dense_gqa, "mamba2_ssd": mamba2_ssd}
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def smoke_cell(name: str) -> Cell:
    conf = dict(SMOKE_CONFIGS[name], name=name)
    return Cell(name=name, root=REPO, workload={}, bench={}, config=conf,
                traffic={})


def served_logits(cell: Cell, W: dict, prompts, steps: int, chunk: int,
                  dtype: str):
    """Prefill ``prompts`` (B, P) in chunks of ``chunk`` through the
    program's serve step, then ``steps`` greedy decode steps; the logits
    of each step's sampled position (B, steps + 1, V) and the tokens."""
    from repro_torch.models import layers as PL
    from repro_torch.models.registry import build_model
    from repro_torch.serving.serve_step import build_serve_fns
    cfg = dataclasses.replace(model_config(cell), dtype=dtype)
    B, P = prompts.shape
    # room for the last chunk's padding: a padded chunk that ran past
    # max_len would wrap the ring onto the slot's first positions
    fns = build_serve_fns(cfg, batch=B, max_len=P + steps + chunk,
                          prefill_chunk=chunk, device="cpu")
    module = build_model(cfg).init(PL.generator("meta", 0))
    bind(module, W)
    cache = fns.init_cache()
    lengths = torch.zeros(B, dtype=torch.int32)
    for c0 in range(0, P, chunk):
        toks = prompts[:, c0:c0 + chunk]
        n = toks.shape[1]
        pad = torch.zeros((B, chunk), dtype=torch.int32)
        pad[:, :n] = toks
        nxt, last, cache = fns.prefill_chunk(
            module, cache, pad, lengths, torch.full((B,), n,
                                                    dtype=torch.int32))
        lengths = lengths + n
    out, tokens = [last], [nxt]
    for _ in range(steps):
        model = fns.model
        logits, cache = model.decode_step(
            module, nxt[:, None], cache, lengths,
            valid=torch.ones((B, 1), dtype=torch.bool))
        lengths = lengths + 1
        out.append(logits[:, -1])
        nxt = logits[:, -1].argmax(-1).to(torch.int32)
        tokens.append(nxt)
    return torch.stack(out, 1), torch.stack(tokens, 1)


@pytest.mark.parametrize("name", sorted(SMOKE_CONFIGS))
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 0.1)])
def test_prefill_then_decode_matches_reference(name, dtype, tol):
    """Ragged chunked prefill through the cache, then decode: the
    program's logits at every sampled position are the reference's full
    forward over the prompt and the tokens served (fp32: to rounding;
    bf16: within 0.1 of a logit range of several units)."""
    cell = smoke_cell(name)
    ref = FAMILIES[cell.family]
    W = ref.draw(cell.pub, 5, "cpu")
    g = torch.Generator().manual_seed(9)
    V = model_config(cell).vocab_size
    prompts = torch.randint(1, V, (3, 37), generator=g, dtype=torch.int32)
    got, toks = served_logits(cell, W, prompts, 6, 16, dtype)
    for b in range(prompts.shape[0]):
        seq = torch.cat([prompts[b], toks[b, :-1]]).long()
        want = ref.logits(W, cell.pub, seq, prompts.shape[1] - 1,
                          Precision("fp32"))
        err = (got[b].float() - want).abs().max().item()
        assert err <= tol * max(1.0, want.abs().max().item()), err


def test_control_reads_above_the_program():
    """fp8 weight products move the reference's logits by far more than
    the program's bf16 path does at the same positions."""
    cell = smoke_cell("qwen3-smoke")
    W = dense_gqa.draw(cell.pub, 3, "cpu")
    seq = torch.randint(1, 257, (40,), generator=torch.Generator()
                        .manual_seed(1))
    full = dense_gqa.logits(W, cell.pub, seq, 20, Precision("fp32"))
    low = dense_gqa.logits(W, cell.pub, seq, 20, Precision("fp8"))
    assert (full - low).abs().max().item() > 0.05


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("part", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_program(part):
    """The references and counts import neither JAX nor the JAX package
    nor the program, by top-level name compared whole, in their sources
    and once loaded."""
    files = sorted((REPO / "portbench" / part).glob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    mods = " ".join(f"portbench.{part}.{f.stem}" for f in files)
    code = ("import importlib, sys\n"
            f"for m in {mods.split()!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert not set(ast.literal_eval(out.strip())) & FORBIDDEN
