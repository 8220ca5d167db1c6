"""The sweep datapath on the card against its own CPU run.

On the card the whole scan is one launch of ``csrc/sweep_scan.cu`` (the
WLBVT round inlined, so ``wlbvt_select`` is never launched); on the CPU
every step is the plain version's.  The two must agree field for field,
and the scan kernel must have been counted once per scheduler group.
The card's rows are also held against the port's own host
``BatchedSimulator`` (an independent event-level simulator) under the
exact-mode contract of ``tests/test_torch_devicepath.py``.  These tests
need the card (the kernel has no CPU mode) and skip without one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api import build_traces, get_scenario
from repro_torch.core.slo import ECTX
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


def _host_run(spec):
    """The spec on the port's host batched datapath."""
    from repro_torch.sim.fastpath import build_simulator
    tenants = [ECTX(tenant_id=i, name=t.name, slo=t.slo(),
                    kernel=t.workload.build())
               for i, t in enumerate(spec.tenants)]
    sim = build_simulator(tenants, datapath="batched",
                          scheduler=spec.scheduler, frag=spec.frag(),
                          arb=spec.arbiter,
                          fifo_capacity=spec.fifo_capacity,
                          record_completions=True)
    return sim.run(build_traces(spec, arrays=True))


@pytest.mark.gpu
@pytest.mark.parametrize("scheduler", ["wlbvt", "rr"])
def test_card_sweep_equals_port_host_simulator(scheduler):
    """Exact mode: time, completion stream, EQ stream, per-tenant stats
    and p99, final scheduler state equal; Jain's time-average within
    1e-9 (the host folds the active set in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    base = dataclasses.replace(
        get_scenario("fig9_congestor_victim", duration_us=20.0,
                     scheduler=scheduler), record_timeline=False)
    specs = [dataclasses.replace(base, seed=s) for s in range(2)]
    card = DP.run_sweep_specs(specs, record_completions=True)
    for spec, d in zip(specs, card):
        h = _host_run(spec)
        assert d.time == h.time
        assert d.completions == h.completions
        assert ([(e.tenant, e.kind.value, e.time) for e in d.events]
                == [(e.tenant, e.kind.value, e.time) for e in h.events])
        for i in range(len(spec.tenants)):
            hs, ds = h.stats[i], d.stats[i]
            for f in ("completed", "killed", "drops",
                      "served_payload_bytes", "first_arrival",
                      "last_completion", "kernel_time_count",
                      "kernel_time_sum"):
                assert getattr(ds, f) == getattr(hs, f), (i, f)
            assert (ds.kernel_time_percentile(99)
                    == hs.kernel_time_percentile(99))
        for k in ("prio", "total_occup", "bvt", "kv_pressure"):
            np.testing.assert_array_equal(np.asarray(d.sched_state[k]),
                                          np.asarray(h.sched_state[k]), k)
        assert abs(d.jain_pu_timeavg - h.jain_pu_timeavg) <= 1e-9
