"""The count functions: the roofline bounds PERF.md's kernel table gives
at its shapes, and a model-FLOP count that padding rows do not move."""
from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.counts import dense_gqa, mamba2_ssd
from portbench.counts.peaks import bound_s
from portbench.tests.smoke import REPO


def pub(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())["config"]


def test_decode_attention_bound_at_the_kernel_table_shape():
    """B 8, T 256 (every row full), 32 / 8 heads of 128, bf16: 8.52 MB,
    0.00254 ms by bytes."""
    p = pub("qwen3-8b")
    flops, nbytes = dense_gqa.decode_attention_work(
        p, np.full(8, 255), np.ones(8, bool))
    assert nbytes == 2 * 8 * 256 * 8 * 128 * 2 + 8 * (2 * 32 * 128 * 2 + 4)
    assert bound_s(flops, nbytes) * 1e3 == pytest.approx(0.00254, abs=5e-6)
    assert nbytes / 3.35e12 > flops / 989e12


def test_ssd_scan_bound_at_the_kernel_table_shape():
    """B 8 rows of S 32, 32 heads of 64, state 128, one group, carried
    state: 19.0 MB, 0.00568 ms by bytes."""
    p = pub("mamba2-370m")
    flops, nbytes = mamba2_ssd.ssd_scan_work(p, np.zeros(8), np.full(8, 32))
    assert nbytes == 19_038_336
    assert bound_s(flops, nbytes) * 1e3 == pytest.approx(0.00568, abs=5e-6)


@pytest.mark.parametrize("name,counts", [("qwen3-8b", dense_gqa),
                                         ("mamba2-370m", mamba2_ssd)])
def test_model_flops_ignore_padding_rows(name, counts):
    """Rows that carry no token (valid_n 0, inactive) add nothing: the
    count is the traffic's, whatever batch the program computes."""
    p = pub(name)
    lengths, valid = np.array([0, 128, 300]), np.array([128, 64, 7])
    samples = np.array([False, True, False])
    base = counts.prefill_flops(p, lengths, valid, samples)
    padded = counts.prefill_flops(
        p, np.concatenate([lengths, np.zeros(29, int)]),
        np.concatenate([valid, np.zeros(29, int)]),
        np.concatenate([samples, np.zeros(29, bool)]))
    assert padded == base > 0
    act = np.array([True, False, True])
    dec = counts.decode_flops(p, lengths, act)
    assert counts.decode_flops(p, np.concatenate([lengths, [5] * 29]),
                               np.concatenate([act, [False] * 29])) == dec
    assert dec == counts.decode_flops(p, lengths[act], act[act]) > 0


def test_dense_flops_per_token():
    """Qwen3-8B: 2 x 6.95 B weight multiply-adds a token outside the
    embedding and head, 2 x 4096 x 151936 for a sampled token's head."""
    p = pub("qwen3-8b")
    assert dense_gqa.layer_weight_macs(p) * 36 == pytest.approx(6.95e9,
                                                                rel=0.01)
    one = dense_gqa.decode_flops(p, np.array([0]), np.array([True]))
    assert one == pytest.approx(2 * 36 * dense_gqa.layer_weight_macs(p)
                                + 36 * 4 * 32 * 128 + 2 * 4096 * 151936)
