"""The port's scenario CLI (``repro_torch.launch.scenario``) against the
JAX package's (``repro.launch.scenario``).

``--list`` prints the reference's lines for every scenario, the fleet
plane's multi-NIC scenarios included; ``--all --fast`` writes, for each
scenario and backend, the file the reference's ``run_one`` saves, byte
for byte (the fleet scenarios among them); ``--set`` parses as the
reference parses.  ``--arch`` serves a smoke model on the CPU only when
asked (``--device cpu``).
"""
import os

import pytest
import torch

jax = pytest.importorskip("jax")

from repro.api.registry import scenario_params as jax_scenario_params  # noqa: E402
from repro.launch import scenario as jax_cli  # noqa: E402
from repro_torch.api import list_scenarios  # noqa: E402
from repro_torch.launch import scenario as cli  # noqa: E402


def test_list_lines_equal_reference(capsys):
    assert cli.main(["--list"]) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_cli.main(["--list"]) == 0
    assert port == capsys.readouterr().out.splitlines()
    names = {line.split()[0] for line in port}
    assert {"fleet_fabric", "fleet_incast", "fleet_migrate"} <= names


def test_all_fast_files_equal_reference(tmp_path, capsys):
    """Every registered scenario on every backend it supports, cut by
    ``--fast`` and a ``--set`` that every sim scenario accepts."""
    out = tmp_path / "port"
    assert cli.main(["--all", "--fast", "--set", "duration_us=8",
                     "--out-dir", str(out)]) == 0
    assert "FAIL" not in capsys.readouterr().out
    want = set()
    for s in list_scenarios():
        params = ({"duration_us": 8}
                  if "duration_us" in jax_scenario_params(s["name"])
                  else {})
        for backend in (["sim"] if s["analytic"] else s["backends"]):
            tag = f"{s['name']}.{backend}"
            path = tmp_path / f"ref.{tag}.json"
            jax_cli.run_one(s["name"], backend, params,
                            fast=True).save(str(path))
            got = (out / f"{tag}.json").read_bytes()
            assert got == path.read_bytes(), tag
            want.add(f"{tag}.json")
    assert set(os.listdir(out)) == want
    assert {"fleet_fabric.sim.json", "fleet_incast.sim.json",
            "fleet_migrate.sim.json"} <= want


@pytest.mark.parametrize("pairs", [
    ["scheduler=rr", "duration_us=60"],
    ["controller=false", "p99_target_ns=1500.5", "name=a=b"],
    ["tenants=[1,2]", "frag_mode=software", "x="],
])
def test_set_parsing_equals_reference(pairs):
    assert cli._parse_sets(pairs) == jax_cli._parse_sets(pairs)
    with pytest.raises(SystemExit):
        cli._parse_sets(["novalue"])


def test_arch_smoke_serves_on_the_cpu(capsys):
    assert cli.main(["serve_mixed_slo", "--backend", "serve", "--arch",
                     "qwen3-8b", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "scenario=serve_mixed_slo backend=serve" in out


def test_arch_defaults_to_the_card_and_unported_planes_raise(tmp_path,
                                                              capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["serve_mixed_slo", "--backend", "serve", "--arch",
                      "qwen3-8b", "--smoke"])
    # the planes that raised before they were ported now run: --export
    # writes both exports, --dash draws its panel
    out = tmp_path / "obs"
    assert cli.main(["fig9_congestor_victim", "--set", "duration_us=5",
                     "--export", str(out)]) == 0
    assert (out / "fig9_congestor_victim.sim.om.txt").read_text()
    assert (out / "fig9_congestor_victim.sim.jsonl").read_text()
    assert cli.main(["fig9_congestor_victim", "--set", "duration_us=5",
                     "--dash"]) == 0
    assert "frame=" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli.main(["serve_mixed_slo", "--backend", "sim"])
