"""The DeepSeek-V2-Lite configuration's files: the configuration loads and
builds the served model's config, the reference's weights bind to the
module the program builds, the counts match a hand count of the
published active parameters, the experts' roofline reader reads a
synthetic run, and a smoke-sized copy of the cell runs on the CPU."""
from __future__ import annotations

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.counts import mla_moe as CNT
from portbench.harness.bench import bind, run_cell
from portbench.harness.spec import load_cell, model_config
from portbench.harness.trace import Trace
from portbench.harness.loop import Call
from portbench.reference import mla_moe as REF
from portbench.tests.smoke import DEPLOYMENT, REPO, make_checkout

CELL = "deepseek-v2-lite-16b.congested"


def _pub() -> dict:
    return json.loads((REPO / "portbench" / "configs"
                       / "deepseek-v2-lite-16b.json").read_text())["config"]


def small_pub() -> dict:
    """The published config at smoke widths (every key kept)."""
    pub = _pub()
    return dict(pub, hidden_size=64, intermediate_size=128, kv_lora_rank=32,
                moe_intermediate_size=32, n_routed_experts=8,
                n_shared_experts=1, num_attention_heads=4,
                num_key_value_heads=4, num_experts_per_tok=2,
                num_hidden_layers=3, qk_nope_head_dim=16,
                qk_rope_head_dim=16, v_head_dim=16, vocab_size=257,
                rope_scaling=dict(pub["rope_scaling"],
                                  original_max_position_embeddings=64))


def test_the_published_keys_at_the_top_level_equal_the_config_group():
    """The file holds the published config.json twice: at its top level,
    key for key as published, and under ``config``, which ``Cell.pub``
    reads. The two copies must not drift apart."""
    whole = json.loads((REPO / "portbench" / "configs"
                        / "deepseek-v2-lite-16b.json").read_text())
    pub = whole["config"]
    assert pub["first_k_dense_replace"] == 1 and pub["rope_scaling"]
    assert {k: whole.get(k, KeyError) for k in pub} == pub


def test_the_cell_loads_and_builds_the_published_model():
    cell = load_cell(REPO, CELL)
    assert cell.family == "mla_moe" and cell.config["reduced"] == []
    cfg = model_config(cell)
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.d_ff) == (
        27, 2048, 102400, 10944)
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.num_shared_experts,
            cfg.moe.expert_d_ff, cfg.moe.first_dense_layers) == (
        64, 6, 2, 1408, 1)
    assert cfg.moe.norm_topk_prob is False
    assert cfg.moe.serve_impl == "grouped"
    assert (cfg.yarn.factor, cfg.yarn.original_max_position,
            cfg.yarn.mscale_all_dim) == (40.0, 4096, 0.707)
    assert cfg.mla.kv_lora_rank == 512 and cfg.mla.q_lora_rank == 0
    assert cfg.param_dtype == "bfloat16" and not cfg.tie_embeddings


def test_the_drawn_weights_bind_to_the_served_module():
    """Names, shapes and dtypes: bf16 everywhere but the fp32 router."""
    from repro_torch.models import layers as PL
    from repro_torch.models.registry import build_model
    pub = small_pub()
    base = model_config(load_cell(REPO, CELL))
    fields = REF.port_fields(pub)
    for k, v in list(fields.items()):
        if isinstance(v, dict):
            fields[k] = dataclasses.replace(getattr(base, k), **v)
    cfg = dataclasses.replace(base, **fields)
    W = REF.draw(pub, 3, "cpu")
    assert W["layers.1.moe.router"].dtype == torch.float32
    assert W["layers.1.moe.w_gate"].dtype == torch.bfloat16
    module = build_model(cfg).init(PL.generator("meta", 0))
    bind(module, W)
    assert sum(p.numel() for p in module.parameters()) == sum(
        t.numel() for t in W.values())
    again = REF.draw(pub, 3, "cpu")
    assert all(torch.equal(W[k], again[k]) for k in W)


def test_flops_per_token_are_the_published_active_parameters():
    """DeepSeek-V2-Lite: per token 13.76 M attention weights a layer
    (27), a dense SwiGLU of 67.2 M, and per MoE layer (26) the router, 6
    routed and 2 shared experts of 8.65 M: 2.24 B outside the embedding
    and head (2.4 B "activated" with the head); a sampled token adds
    2 x 2048 x 102400."""
    p = _pub()
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert CNT.attention_weight_macs(p) == attn
    moe = 2048 * 64 + 8 * 3 * 2048 * 1408
    active = 27 * attn + 3 * 2048 * 10944 + 26 * moe
    assert active == pytest.approx(2.24e9, rel=0.01)
    one = CNT.decode_flops(p, np.array([0]), np.array([True]))
    assert one == 2 * active + 27 * 2 * 16 * (192 + 128) \
        + 2 * 2048 * 102400
    assert CNT.prefill_flops(p, np.array([0, 5]), np.array([1, 0]),
                             np.array([True, False])) == one


def test_expert_work_counts_the_experts_the_tokens_reach():
    p = _pub()
    flops, nbytes = CNT.moe_experts_work(p, np.zeros(3), np.array([1, 0, 0]))
    per = 3 * 2048 * 1408
    assert flops == 26 * 2 * per * 6
    assert nbytes == 26 * (6 * per + 2 * 6 * 2048) * 2
    assert CNT.experts_hit(p, 0) == 0
    assert CNT.experts_hit(p, 512) == pytest.approx(64, rel=1e-6)
    # a decode call's active mask counts as its rows
    assert CNT.moe_experts_work(p, np.zeros(4), np.array(
        [True, False, True, True])) == CNT.moe_experts_work(
        p, np.zeros(4), np.array([3]))


def _run(trace):
    cell = SimpleNamespace()
    return SimpleNamespace(
        cell=cell, pub=_pub(), counts=CNT, trace=trace,
        calls=[Call("prefill", 0, 1, np.array([0, 128]), np.array([128, 0])),
               Call("decode", 1, 2, np.array([128, 5]),
                    np.array([True, True])),
               Call("reset", 2, 3)])


def test_the_roofline_reader_reads_a_synthetic_run():
    from portbench.counts.peaks import bound_s
    spec = __import__("importlib.util").util.spec_from_file_location(
        "m", REPO / "portbench" / "metrics" / "moe_experts_roofline.py")
    mod = __import__("importlib.util").util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    tr = Trace(1.0, 0.5, {}, {}, {
        "void cutlass::device_kernel<GemmUniversal<cutlass::gemm::"
        "GroupProblemShape<cute::tuple<int, int, int> >, ...>": 0.004,
        "void at::native::elementwise_kernel": 0.5}, {}, [])
    want = 100 * (bound_s(*CNT.moe_experts_work(_pub(), None, [128, 0]))
                  + bound_s(*CNT.moe_experts_work(_pub(), None,
                                                  [True, True]))) / 0.004
    assert mod.read(_run(tr)) == pytest.approx(want)
    assert mod.read(_run(None)) is None
    empty = Trace(1.0, 0.5, {}, {}, {"void other": 1.0}, {}, [])
    assert mod.read(_run(empty)) is None


def test_a_smoke_copy_of_the_cell_runs_and_is_correct(tmp_path):
    """The cell at smoke widths through ``run_cell`` on the CPU: the
    reference passes the program's tokens (widest gap under 0.05 of a
    logit) and the new metric is asked for only where it reads.  The
    program computes in fp32 on the bf16 weights here (widest gap 0 over
    seeds 1-8, the fp8 control 0.156-0.813): at these widths bf16
    activations flip top-2 near-ties (0-0.149 against the control's
    0.219-0.743), and the timed traffic draws another sample each run."""
    root = make_checkout(tmp_path)
    conf = json.loads((REPO / "portbench" / "configs"
                       / "deepseek-v2-lite-16b.json").read_text())
    conf["port"]["fields"]["dtype"] = "float32"
    conf.update(name="ds-smoke", config=small_pub(), deployment=DEPLOYMENT,
                check={"sample_tokens": 64, "sample_requests": 4,
                       "max_gap_limit": 0.05})
    (root / "portbench" / "configs" / "ds-smoke.json").write_text(
        json.dumps(conf))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ds-smoke", "source": "smoke",
                             "file": "portbench/configs/ds-smoke.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "ds-smoke.mix", "config": "ds-smoke",
                               "traffic": "smoke_mix", "chips": 1,
                               "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cell(root, "ds-smoke.mix", 2**33 + 9, 1.0, True,
                   device="cpu", log=lambda *a: None)
    assert res["correct"], res["check"]
    assert "moe_experts_roofline" not in res["metrics"]
    assert {"mfu", "prefill_call_ms", "decode_call_ms"} <= set(res["metrics"])
