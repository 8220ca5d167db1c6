"""A smoke-sized checkout for the CPU tests: a copy of ``portbench/`` and
``BENCHMARK.json`` in a temporary directory, with small configuration
files of both families, a small traffic mix, and cells that use them,
added as new files and new entries only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

SMOKE_CONFIGS = {
    "qwen3-smoke": {
        "family": "dense_gqa", "port": {"arch": "qwen3-8b",
                                        "fields": {"attn_impl": "pallas",
                                                   "attn_chunk": 16}},
        "config": {"hidden_size": 64, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "intermediate_size": 128,
                   "vocab_size": 257, "rms_norm_eps": 1e-6,
                   "rope_theta": 1000000, "tie_word_embeddings": False,
                   "attention_bias": False, "hidden_act": "silu"}},
    "mamba2-smoke": {
        "family": "mamba2_ssd", "port": {"arch": "mamba2-370m",
                                         "fields": {"attn_impl": "pallas"}},
        "config": {"d_model": 64, "n_layer": 2, "vocab_size": 250,
                   "pad_vocab_size_multiple": 16, "tie_embeddings": True,
                   "d_state": 16, "d_conv": 4, "expand": 2, "headdim": 16,
                   "ngroups": 1, "chunk_size": 16, "norm_epsilon": 1e-5}},
}

SMOKE_MIX = {
    "warmup_s": 0.5,
    "tenants": [
        {"name": "batch", "priority": 1, "kv_quota_slots": 2,
         "arrival": {"kind": "closed", "outstanding": 3},
         "prompt": {"dist": "lognormal", "median": 30, "sigma": 0.3,
                    "min": 20, "max": 40},
         "output": {"dist": "uniform", "min": 4, "max": 10}},
        {"name": "chat", "priority": 2, "kv_quota_slots": 2, "victim": True,
         "arrival": {"kind": "poisson", "rate_per_s": 8.0},
         "prompt": {"dist": "lognormal", "median": 10, "sigma": 0.5,
                    "min": 4, "max": 20},
         "output": {"dist": "lognormal", "median": 6, "sigma": 0.5,
                    "min": 3, "max": 12}},
    ],
}

DEPLOYMENT = {"max_slots": 4, "max_len": 64, "prefill_chunk": 16,
              "prefill_slots_per_step": 2, "scheduler": "wlbvt",
              "arbiter": "dwrr"}


def make_checkout(tmp: Path, limit: float = 1.0) -> Path:
    """A copy of the benchmark with the smoke files and cells added.
    Returns its root."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, conf in SMOKE_CONFIGS.items():
        body = dict(conf, name=name, source="smoke", reduced=[],
                    deployment=DEPLOYMENT,
                    check={"sample_tokens": 64, "sample_requests": 4,
                           "max_gap_limit": limit})
        path = root / "portbench" / "configs" / f"{name}.json"
        path.write_text(json.dumps(body))
        bench["configs"].append({"name": name, "source": "smoke",
                                 "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "CPU test"})
        bench["workloads"].append({"name": f"{name}.mix", "config": name,
                                   "traffic": "smoke_mix", "chips": 1,
                                   "why": "CPU test"})
    (root / "portbench" / "traffic" / "smoke_mix.json").write_text(
        json.dumps(SMOKE_MIX))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
