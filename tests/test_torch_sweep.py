"""Sweep plans and the sweep CLI: the port's ``apply_knob``, ``SweepSpec``
and registered simulator scenarios against the JAX package's, and
``python -m repro_torch.launch.sweep`` end to end on the CPU."""
import dataclasses
import json

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.api import SweepAxis as JaxSweepAxis  # noqa: E402
from repro.api import SweepSpec as JaxSweepSpec  # noqa: E402
from repro.api import apply_knob as jax_apply_knob  # noqa: E402
from repro.api import get_scenario as jax_get_scenario  # noqa: E402
from repro_torch.api import (SweepAxis, SweepSpec, apply_knob,  # noqa: E402
                             build_traces, get_scenario)
from repro_torch.api.registry import scenario_params  # noqa: E402
from repro_torch.launch import sweep as cli  # noqa: E402

SIM_SCENARIOS = ("fig9_congestor_victim", "fig10_hol_blocking",
                 "fig11_standalone", "fig12_compute_mixture",
                 "fig13_io_mixture", "qos_closed_loop", "ppb_service_time")


def _base():
    return dataclasses.replace(
        get_scenario("fig9_congestor_victim", duration_us=10.0),
        record_timeline=False)


def _jax_base():
    return dataclasses.replace(
        jax_get_scenario("fig9_congestor_victim", duration_us=10.0),
        record_timeline=False)


@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_sim_scenarios_serialize_as_the_jax_package(name):
    assert get_scenario(name).to_dict() == jax_get_scenario(name).to_dict()
    for t, jt in zip(get_scenario(name).tenants,
                     jax_get_scenario(name).tenants):
        assert (dataclasses.asdict(t.workload.build())
                == dataclasses.asdict(jt.workload.build()))


@pytest.mark.parametrize("name", ["fig9_congestor_victim",
                                  "fig12_compute_mixture"])
def test_traces_are_bit_identical(name):
    from repro.api.runtime import build_traces as jax_build_traces
    kw = {"duration_us": 20.0, "seed": 3}
    got = build_traces(get_scenario(name, **kw), arrays=True)
    want = jax_build_traces(jax_get_scenario(name, **kw), arrays=True)
    for f in ("times", "tenants", "sizes"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("path,value", [
    ("fifo_capacity", 64),
    ("tenants.1.priority", 9.0),
    ("tenants.*.kernel_cycle_limit", 123),
    ("tenants.0.workload.compute_per_byte", 0.25),
    ("scheduler", "rr"),
])
def test_apply_knob_matches_jax(path, value):
    got = apply_knob(_base(), path, value)
    assert got.to_dict() == jax_apply_knob(_jax_base(), path,
                                           value).to_dict()
    assert got != _base()


def test_apply_knob_rejects_unknown_field():
    with pytest.raises(KeyError):
        apply_knob(_base(), "no_such_field", 1)


def test_sweep_spec_expansion_and_serde_match_jax():
    axes = (("fifo_capacity", (64, 4096)),
            ("tenants.0.priority", (1.0, 2.0, 4.0)))
    sw = SweepSpec(name="s", base=_base(),
                   axes=tuple(SweepAxis(k, v) for k, v in axes),
                   seeds=(0, 1))
    jsw = JaxSweepSpec(name="s", base=_jax_base(),
                       axes=tuple(JaxSweepAxis(k, v) for k, v in axes),
                       seeds=(0, 1))
    assert len(sw) == 12
    assert sw.to_dict() == jsw.to_dict()
    pairs, jpairs = list(sw.replicas()), list(jsw.replicas())
    assert [k for k, _ in pairs] == [k for k, _ in jpairs]
    assert [s.to_dict() for _, s in pairs] == \
        [s.to_dict() for _, s in jpairs]
    rt = SweepSpec.from_dict(json.loads(json.dumps(sw.to_dict())))
    assert rt == sw and rt.specs() == sw.specs()


def test_sweep_cli_end_to_end_on_cpu(tmp_path, capsys):
    out = tmp_path / "sweep.json"
    rc = cli.main(["fig9_congestor_victim", "--set", "duration_us=10",
                   "--axis", "tenants.0.priority=1,2", "--seeds", "2",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["replicas"] == 4 and doc["device"] == "cpu"
    assert [r["knobs"] for r in doc["rows"]] == [
        {"tenants.0.priority": p, "seed": s} for p in (1, 2)
        for s in (0, 1)]
    for row in doc["rows"]:
        assert row["scenario"] == "fig9_congestor_victim"
        assert sum(t["completed"] for t in row["tenants"]) > 0
    # raising the congestor's priority moves service towards it
    done = {(r["knobs"]["tenants.0.priority"], r["seed"]):
            r["tenants"][0]["completed"] for r in doc["rows"]}
    assert done[(2, 0)] >= done[(1, 0)]
    assert "4 scenario(s)" in capsys.readouterr().out


def test_sweep_cli_spec_file_and_errors(tmp_path):
    sw = SweepSpec(name="plan", base=get_scenario(
        "fig9_congestor_victim", duration_us=5.0).replace(
            record_timeline=False), seeds=(0,))
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(sw.to_dict()))
    assert cli.main(["--spec", str(plan), "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        cli.main(["fig9_congestor_victim", "--set", "bogus=1",
                  "--device", "cpu"])
    from repro_torch.sim.devicepath import DevicePathError
    with pytest.raises(DevicePathError, match="not device-eligible"):
        cli.main(["fig13_io_mixture", "--device", "cpu"])
    assert "duration_us" in scenario_params("fig9_congestor_victim")


def test_sweep_cli_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["fig9_congestor_victim", "--set", "duration_us=5"])
