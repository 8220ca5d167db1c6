"""One run of one cell: set up, warm, load, measure, check, report.

``run_cell`` is the whole run as ``run.py`` makes it on the card; the
CPU tests call it with ``device="cpu"`` on smoke-sized files.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from portbench.harness import check as CHK
from portbench.harness import trace as TRC
from portbench.harness.loop import Driver, TimedExecutor, clock
from portbench.harness.spec import Cell, load_cell, model_config
from portbench.harness.traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def bind(module, W: dict) -> None:
    """Give the program's module, built on the meta device, the harness's
    tensors as its parameters (no copy)."""
    names = set()
    for name, p in list(module.named_parameters()):
        t = W.get(name)
        if t is None or tuple(t.shape) != tuple(p.shape) \
                or t.dtype != p.dtype:
            raise ValueError(f"weight {name}: the module wants "
                             f"{tuple(p.shape)} {p.dtype}, the harness has "
                             f"{None if t is None else tuple(t.shape)}")
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, torch.nn.Parameter(t, requires_grad=False))
        names.add(name)
    if set(W) - names:
        raise ValueError(f"weights the module has no place for: "
                         f"{sorted(set(W) - names)[:5]}")
    if any(b.is_meta for b in module.buffers()):
        raise ValueError("the module keeps a buffer the harness did not set")


@dataclasses.dataclass
class RunRecord:
    """What the per-layer readers read (``metrics/<name>.py``)."""
    cell: Cell
    pub: dict
    counts: object            # counts/<family>.py
    t0: float                 # the window, host clock
    t1: float
    steps: list               # loop.Step of the window
    calls: list               # loop.Call of the window
    recs: list                # loop.Rec of every request
    trace: Optional[TRC.Trace]

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def victims_due(self):
        return [r for r in self.recs
                if r.victim and self.t0 <= r.due <= self.t1]


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else None


def end_to_end(run: RunRecord) -> dict:
    t0, t1 = run.t0, run.t1
    tokens, itl = 0, []
    for r in run.recs:
        inw = [t for t in r.times if t0 <= t <= t1]
        tokens += len(inw)
        itl += list(np.diff(inw)) if len(inw) > 1 else []
    ttft = [((r.times[0] if r.times and r.times[0] <= t1 else t1) - r.due)
            for r in run.victims_due()]
    out = {"tokens_per_s": tokens / run.seconds,
           "victim_ttft_p90_ms": percentile(ttft, 90),
           "itl_p95_ms": percentile(itl, 95)}
    for k in ("victim_ttft_p90_ms", "itl_p95_ms"):
        if out[k] is not None:
            out[k] *= 1e3
    out["_counts"] = dict(window_tokens=tokens, victims_due=len(ttft),
                          gaps=len(itl))
    return out


def warm(inner, ecfg) -> None:
    """One prefill and one decode call at the engine's fixed shapes (the
    only shapes its calls have), then every slot reset."""
    B, C = ecfg.max_slots, ecfg.prefill_chunk
    inner.prefill(np.ones((B, C), np.int32), np.zeros(B, np.int32),
                  np.full(B, C, np.int32))
    inner.decode(np.ones(B, np.int32), np.full(B, C, np.int32),
                 np.ones(B, bool))
    inner.reset(np.zeros(B, bool))


@dataclasses.dataclass
class Setup:
    """A cell's program, built once: the served model on the harness's
    weights, warmed at the engine's shapes."""
    cell: Cell
    seed: int
    dev: torch.device
    cfg: object               # the program's ModelConfig
    ecfg: object              # its EngineConfig
    W: dict                   # the harness's weights (both sides read them)
    inner: object             # the program's ModelExecutor
    phases: dict              # set-up phase -> host seconds


def prepare(root: Path, name: str, seed: int, device: str = "cuda",
            cell: Optional[Cell] = None) -> Setup:
    """Draw the weights from ``seed`` on ``device``, build the program's
    executor over them and warm its two shapes."""
    from repro_torch.models import layers as PL
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import EngineConfig, ModelExecutor

    phases, t = {}, clock()

    def mark(name):
        nonlocal t
        now = clock()
        phases[name] = now - t
        t = now

    dev = torch.device(device)
    cell = cell or load_cell(root, name)
    cfg = model_config(cell)
    ecfg = EngineConfig(max_tenants=max(2, len(cell.traffic["tenants"])),
                        **cell.config["deployment"])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    W = cell.reference().draw(cell.pub, seed, dev)
    sync()
    mark("draw_weights")
    module = build_model(cfg).init(PL.generator("meta", 0))
    bind(module, W)
    inner = ModelExecutor(cfg, ecfg, params=module, device=dev)
    sync()
    mark("build_executor")
    warm(inner, ecfg)
    sync()
    mark("warm_shapes")
    return Setup(cell, seed, dev, cfg, ecfg, W, inner, phases)


def serve(st: Setup, seconds: float, trace: bool,
          mix: Optional[dict] = None, wrap_inner: Optional[Callable] = None):
    """Serve the cell's mix (or ``mix``) from a fresh engine: its warm-up,
    then the window of ``seconds``, under the profiler with ``trace``.
    Returns (RunRecord, Driver, profiler or None)."""
    from repro_torch.api.runtime import ServeRuntime
    from repro_torch.core.slo import SLOPolicy
    from repro_torch.serving.request import Request

    mix = mix or st.cell.traffic
    ecfg = st.ecfg
    inner = wrap_inner(st.inner) if wrap_inner is not None else st.inner
    exe = TimedExecutor(inner)
    rt = ServeRuntime(ecfg, executor=exe)
    exe.engine = rt.engine
    for i, t in enumerate(mix["tenants"]):
        rt.create_tenant(i, SLOPolicy(
            priority=float(t.get("priority", 1.0)),
            dma_priority=float(t.get("dma_priority", 1.0)),
            kv_quota_tokens=int(t["kv_quota_slots"]) * ecfg.max_len),
            name=t["name"])
    traffic = Traffic(mix, st.seed, st.cfg.vocab_size, ecfg.max_len)
    drv = Driver(rt, exe, traffic, Request)
    sync = (torch.cuda.synchronize if st.dev.type == "cuda"
            else (lambda: None))
    sync()
    drv.begin()
    drv.run(drv.start + float(mix["warmup_s"]))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if st.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    n_steps, n_calls = len(drv.steps), len(exe.calls)
    t0 = clock()
    with torch.profiler.record_function("portbench.window"):
        drv.run(t0 + seconds)
    t1 = drv.steps[-1].t1 if len(drv.steps) > n_steps else clock()
    sync()
    if prof is not None:
        prof.__exit__(None, None, None)
    run = RunRecord(st.cell, st.cell.pub, st.cell.counts(), t0, t1,
                    drv.steps[n_steps:], exe.calls[n_calls:], drv.recs,
                    None)
    return run, drv, prof


def release(st: Setup, drv) -> None:
    """Free the program's cache and engine before the reference runs; the
    weights stay (the reference reads them)."""
    st.inner.cache = None
    drv.rt = drv.eng = drv.exe = None
    gc.collect()
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             wrap_inner: Optional[Callable] = None,
             control: bool = False, log=print) -> dict:
    """The run; returns the result line's fields (``correct``, ``metrics``,
    ``device``, ...) and, under ``_``-prefixed keys, what the control and
    the tests read."""
    t_process = clock() if t_process is None else t_process
    st = prepare(root, name, seed, device)
    run, drv, prof = serve(st, seconds, trace, wrap_inner=wrap_inner)
    cell, dev, t0, t1 = st.cell, st.dev, run.t0, run.t1
    setup_s = t0 - t_process
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    e2e = end_to_end(run)
    e2e["setup_s"] = setup_s
    log(f"portbench: set-up phases {json.dumps(st.phases)}, traffic "
        f"warm-up {cell.traffic['warmup_s']} s, steps in the window "
        f"{len(run.steps)}")
    release(st, drv)

    chk = cell.config["check"]
    t_chk = time.perf_counter()
    sample = CHK.draw_sample(run.recs, seed, t0, t1, chk["sample_tokens"],
                             chk["sample_requests"])
    gp = CHK.gaps(cell.reference(), st.W, cell.pub, sample, dev,
                  control=control)
    widest = CHK.widest(gp["served"])
    check_s = time.perf_counter() - t_chk
    limit = float(chk["max_gap_limit"])
    n_tok = int(sum(len(s.served) for s in sample))
    correct = widest is not None and widest <= limit and not found

    res = {"_found": found, "_e2e": e2e, "_gaps": gp, "_sample": sample,
           "_run": run, "_check_s": check_s, "_max_late": drv.max_late}
    window_recs = [r for r in run.recs if t0 <= r.submitted <= t1]
    attempted = len(window_recs)
    failed = sum(r.status in ("rejected", "killed") for r in window_recs)
    if prof is not None:
        ops, spans = TRC.raw_events(prof)
        run.trace = TRC.reduce(ops, spans)
        del prof, ops, spans
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        val = (e2e.get(m["name"]) if kind == "end_to_end"
               else cell.reader(m["name"])(run))
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        devinfo["busy_s"] = run.trace.busy_s
        devinfo["window_s"] = run.trace.window_s
    res.update({"correct": bool(correct), "attempted": attempted,
                "failed": failed, "metrics": metrics, "device": devinfo})
    if run.trace is not None:
        res["breakdown"] = run.trace.breakdown()
    res["check"] = {
        "max_gap": {"value": widest, "limit": limit},
        "checked_tokens": {"value": n_tok, "limit": None},
        "checked_requests": {"value": len(sample), "limit": None},
        "jax_modules_loaded": {"value": len(found), "limit": 0}}
    return res
