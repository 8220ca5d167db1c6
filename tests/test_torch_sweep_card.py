"""The sweep datapath on the card against its own CPU run.

On the card the whole scan is one launch of ``csrc/sweep_scan.cu`` (the
WLBVT round inlined, so ``wlbvt_select`` is never launched); on the CPU
every step is the plain version's.  The two must agree field for field,
and the scan kernel must have been counted once per scheduler group.
These tests need the card (the kernel has no CPU mode) and skip without
one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import get_scenario
from repro_torch.kernels import ops
from repro_torch.sim import devicepath as DP


def _specs(scheduler, n):
    base = get_scenario("fig9_congestor_victim", duration_us=3.0,
                        scheduler=scheduler)
    return [dataclasses.replace(base, record_timeline=False, seed=s)
            for s in range(n)]


def _same(a, b):
    assert a.time == b.time
    assert a.completions == b.completions
    assert ([(e.tenant, e.kind, e.time) for e in a.events]
            == [(e.tenant, e.kind, e.time) for e in b.events])
    assert a.summary_row() == b.summary_row()
    assert a.jain_pu_timeavg == b.jain_pu_timeavg
    for k in a.counters:
        np.testing.assert_array_equal(a.counters[k], b.counters[k], k)
    for k in a.sched_state:
        np.testing.assert_array_equal(a.sched_state[k], b.sched_state[k], k)


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("scheduler", ["wlbvt", "rr"])
def test_graph_replayed_sweep_equals_cpu_run(scheduler, precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    specs = _specs(scheduler, 3)
    ops.reset_launches()
    card = DP.run_sweep_specs(specs, precision=precision,
                              record_completions=True)
    launches = dict(ops.LAUNCHES)
    cpu = DP.run_sweep_specs(specs, precision=precision,
                             record_completions=True, device="cpu")
    assert launches["sweep_scan"] == 1 and launches["wlbvt_select"] == 0
    for a, b in zip(card, cpu):
        _same(a, b)
