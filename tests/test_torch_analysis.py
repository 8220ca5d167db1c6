"""The port's static-analysis suite (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``).

(a) the six carried-over rules give the reference's findings on every
reference fixture; (b) ``xp-purity`` gives ``jit-purity``'s on
backend-generic fixtures; (c) ``host-sync`` gives its exact findings on
its own fixtures and leaves in-place writes alone; (d) the real tree's
device roots are in its scope; (e) the port's repo-wide run equals its
baseline; (f) the shared rules over ``src/repro_torch`` give the
reference's findings over ``src/repro``; (g) the CLI gate's exit codes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as RA
import repro_torch.analysis as TA
from repro.analysis.purity import JitPurityRule
from repro_torch.analysis.check import BASELINE_NAME
from repro_torch.analysis.purity import HostSyncRule, XpPurityRule

REPO = Path(__file__).resolve().parents[1]
REF_FIXTURES = REPO / "tests" / "data" / "analysis"
FIXTURES = REPO / "tests" / "data" / "analysis_torch"

SHARED_RULES = ("time-unit-flow", "eq-event-exhaustiveness", "frozen-spec",
                "fixed-shape", "span-balance", "metric-names")
# the reference fixture each shared rule must flag (the rest are clean
# under it or hold another rule's violations)
BAD_FIXTURE = {"time-unit-flow": ["units_bad.py"],
               "eq-event-exhaustiveness": ["events_bad", "events_fleet_bad"],
               "frozen-spec": ["frozen_bad.py"],
               "fixed-shape": ["frozen_bad.py"],
               "span-balance": ["span_bad.py"],
               "metric-names": ["metrics_bad.py"]}
REF_FIXTURE_NAMES = sorted(p.name for p in REF_FIXTURES.iterdir()
                           if p.suffix == ".py" or p.is_dir())


def run_pair(name, root, paths, **scope):
    """(port findings, reference findings) of rule ``name``, each rule
    built with ``scope`` over its own package's index of ``paths``."""
    port = TA.RULE_REGISTRY[name](**scope).run(
        TA.RepoIndex.load(str(root), paths=paths, excludes=()))
    ref = RA.RULE_REGISTRY[name](**scope).run(
        RA.RepoIndex.load(str(root), paths=paths, excludes=()))
    return port, ref


def fixture_findings(rule, name):
    return rule.run(TA.RepoIndex.load(str(FIXTURES), paths=[name],
                                      excludes=()))


# ---------------------------------------------------------------------------
# (a) the carried-over rules on the reference's fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fixture", REF_FIXTURE_NAMES)
@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rule_matches_reference_on_its_fixture(rule, fixture):
    port, ref = run_pair(rule, REF_FIXTURES, [fixture], scope=("*",))
    assert [f.to_dict() for f in port] == [f.to_dict() for f in ref]
    if fixture in BAD_FIXTURE[rule]:
        assert port, f"{rule} raised nothing on {fixture}"


def test_the_reference_fixture_trees_are_all_covered():
    assert {"events_bad", "events_good", "events_fleet_bad",
            "events_fleet_good", "units_bad.py", "frozen_bad.py",
            "span_bad.py", "metrics_bad.py"} <= set(REF_FIXTURE_NAMES)


# ---------------------------------------------------------------------------
# (b) xp-purity against the reference's jit-purity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fixture", ["xp_good.py", "xp_bad.py"])
def test_xp_purity_matches_jit_purity(fixture):
    port = XpPurityRule(scope=("*",)).run(
        TA.RepoIndex.load(str(FIXTURES), paths=[fixture], excludes=()))
    ref = JitPurityRule(scope=("*",)).run(
        RA.RepoIndex.load(str(FIXTURES), paths=[fixture], excludes=()))

    def as_port(d):
        return {k: (v.replace("jit-purity", "xp-purity")
                    if isinstance(v, str) else v) for k, v in d.items()}

    assert [f.to_dict() for f in port] == [as_port(f.to_dict()) for f in ref]


def test_xp_bad_exact_findings():
    fs = fixture_findings(XpPurityRule(scope=("*",)), "xp_bad.py")
    assert all(f.rule == "xp-purity" and f.severity == "error" for f in fs)
    assert sorted((f.line, f.symbol) for f in fs) == sorted([
        (12, "inplace_at"), (12, "inplace_at"),   # np.add.at + np.add
        (18, "subscript_store"), (23, "mixes_numpy"),
        (28, "traced_branch"), (34, "traced_loop"), (40, "dynamic_shape"),
        (44, "one_arg_where"),
        (52, "_clip"),                  # reached by a call
        (56, "_exp"),                   # reached as a vmap body
    ])


def test_xp_good_is_clean():
    assert fixture_findings(XpPurityRule(scope=("*",)), "xp_good.py") == []


# ---------------------------------------------------------------------------
# (c) host-sync on its own fixtures
# ---------------------------------------------------------------------------
def fixture_rule():
    """host-sync with the fixture file as its sync-free scope."""
    return HostSyncRule(scope=("*",), sync_free=("*",))


SYNC_BAD = [  # (line, symbol, message start), one violation class each
    (15, "item_torch", "`.item()` copies to the host"),
    (19, "tolist_torch", "`.tolist()` copies to the host"),
    (23, "cpu_torch", "`.cpu()` copies to the host"),
    (27, "numpy_torch", "`.numpy()` copies to the host"),
    (31, "to_cpu_torch", "`.to(\"cpu\")` copies to the host"),
    (36, "synchronize_torch", "`torch.cuda.synchronize()` waits"),
    (41, "float_torch", "`float()` of a traced value"),
    (45, "int_torch", "`int()` of a traced value"),
    (49, "bool_torch", "`bool()` of a traced value"),
    (53, "branch_torch", "Python `if` on a traced value"),
    (59, "loop_torch", "Python `while` on a traced value"),
    (65, "ternary_torch", "Python `if` on a traced value"),
    (69, "assert_torch", "Python `assert` on a traced value"),
    (74, "nonzero_torch", "`nonzero` produces a data-dependent shape"),
    (78, "unique_torch", "`unique` produces a data-dependent shape"),
    (82, "argwhere_torch", "`argwhere` produces a data-dependent shape"),
    (86, "masked_select_torch",
     "`masked_select` produces a data-dependent shape"),
    (90, "where_torch", "one-argument `where` returns data-dependent"),
    (94, "mask_index_torch", "boolean-mask indexing"),
    (98, "bincount_torch", "`bincount` produces a data-dependent shape"),
    (102, "numpy_call_torch", "`np.exp` on a traced value runs on the host"),
    (115, "_scaled_max", "`.item()` copies to the host"),   # via a call
]


@pytest.fixture(scope="module")
def sync_bad():
    return fixture_findings(fixture_rule(), "sync_bad.py")


@pytest.mark.parametrize("line,symbol,message", SYNC_BAD,
                         ids=[s for _, s, _ in SYNC_BAD])
def test_sync_bad_finding(sync_bad, line, symbol, message):
    (f,) = [f for f in sync_bad if f.symbol == symbol]
    assert (f.rule, f.severity, f.line) == ("host-sync", "error", line)
    assert f.message.startswith(message), f.message


def test_sync_bad_exact_findings(sync_bad):
    assert sorted((f.line, f.symbol) for f in sync_bad) == \
        sorted((line, symbol) for line, symbol, _ in SYNC_BAD)


def test_sync_bad_in_place_write_is_in_scope_and_not_a_finding(sync_bad):
    scope = fixture_rule().in_scope(
        TA.RepoIndex.load(str(FIXTURES), paths=["sync_bad.py"], excludes=()))
    assert ("sync_bad.py", "copy_into_torch") in scope
    assert ("sync_bad.py", "_scaled_max") in scope
    assert not [f for f in sync_bad if f.symbol == "copy_into_torch"]


def test_sync_good_is_clean():
    assert fixture_findings(fixture_rule(), "sync_good.py") == []


def test_sync_good_scope():
    """Graph-capture bodies and their callees are roots, the capturing
    function is not; a method's ``*_torch`` is one, ``self`` static."""
    scope = fixture_rule().in_scope(
        TA.RepoIndex.load(str(FIXTURES), paths=["sync_good.py"], excludes=()))
    assert {q for _, q in scope} == {
        "scale_torch", "bucket_torch", "select_torch", "ring_push_torch",
        "scatter_torch", "Doubler.apply_torch", "step", "_double"}


def test_host_sync_roots_need_a_sync_free_scope_or_a_capture():
    index = TA.RepoIndex.load(str(FIXTURES), paths=["sync_bad.py"],
                              excludes=())
    assert HostSyncRule(scope=("*",), sync_free=()).run(index) == []


def test_serve_fns_prefill_rows_is_a_root():
    """Both branches of a conditional ``prefill_rows=`` are roots, also
    through a local name bound to the conditional; a ``len()`` test of
    the rows is metadata, the ``.item()`` and the ``int()`` findings."""
    index = TA.RepoIndex.load(str(FIXTURES), paths=["serve_rows.py"],
                              excludes=())
    scope = {q for _, q in fixture_rule().in_scope(index)}
    assert scope == {"build._rows", "build._rows_synced", "build._decode",
                     "build_bound._rows_bound"}
    assert [(f.line, f.symbol) for f in fixture_rule().run(index)] == [
        (19, "build._rows_synced"), (30, "build_bound._rows_bound")]


# ---------------------------------------------------------------------------
# (d) the real tree's device roots are in scope
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_index():
    return TA.RepoIndex.load(str(REPO))


@pytest.fixture(scope="module")
def host_sync_scope(port_index):
    return HostSyncRule().in_scope(port_index)


@pytest.mark.parametrize("path,qual", [
    ("src/repro_torch/kernels/ref.py", "sweep_scan_ref._step"),
    ("src/repro_torch/kernels/ref.py", "sweep_scan_ref._pre"),
    ("src/repro_torch/kernels/ref.py", "sweep_scan_ref._apply_one"),
    ("src/repro_torch/kernels/ref.py", "sweep_scan_ref._rr_pick"),
    ("src/repro_torch/core/sched_generic.py", "select_rr"),
    ("src/repro_torch/telemetry/metrics.py", "hist_add_torch"),
    ("src/repro_torch/telemetry/metrics.py", "ring_push_torch"),
    ("src/repro_torch/telemetry/metrics.py", "record_window_torch"),
    ("src/repro_torch/serving/serve_step.py", "build_serve_fns._prefill"),
    ("src/repro_torch/serving/serve_step.py",
     "build_serve_fns._prefill_rows"),
    ("src/repro_torch/serving/serve_step.py", "build_serve_fns._decode"),
    ("src/repro_torch/serving/serve_step.py", "_build_sharded._prefill"),
    ("src/repro_torch/serving/serve_step.py", "_build_sharded._decode"),
    ("src/repro_torch/serving/serve_step.py", "make_reset_slots.reset"),
    ("src/repro_torch/serving/sampler.py", "sample"),
])
def test_device_root_in_host_sync_scope(host_sync_scope, path, qual):
    assert (path, qual) in host_sync_scope


def test_host_sync_stops_at_method_calls(host_sync_scope):
    """``model.decode_step`` is a method call: the ragged MoE dispatch
    behind it (``moe.py``'s ``bincount(...).tolist()``) is out of scope."""
    assert ("src/repro_torch/models/moe.py", "apply_moe_ragged") \
        not in host_sync_scope
    assert not any(p.startswith("src/repro_torch/models/")
                   for p, _ in host_sync_scope)


def test_xp_purity_scopes_the_backend_generic_kernels(port_index):
    scope = XpPurityRule().in_scope(port_index)
    assert ("src/repro_torch/core/sched_generic.py", "select_rr") in scope
    assert ("src/repro_torch/telemetry/metrics.py", "hist_add") in scope


# ---------------------------------------------------------------------------
# (e) the port's repo-wide run matches its baseline
# ---------------------------------------------------------------------------
def test_repo_wide_run_matches_baseline(port_index):
    findings = TA.run_rules(port_index)
    baseline = TA.Baseline.load(str(REPO / BASELINE_NAME))
    new, stale = baseline.diff(findings)
    assert new == [], "un-baselined findings:\n" + "\n".join(
        f.format() for f in new)
    assert stale == [], f"stale baseline entries: {stale}"
    for key, just in baseline.entries.items():
        assert just.strip() and not just.startswith("TODO"), (
            f"baseline entry lacks a justification: {key}")
    assert [f.key for f in findings] == [
        "eq-event-exhaustiveness::src/repro_torch/core/events.py::EventKind"
        "::EventKind.KERNEL_ERROR is declared but never emitted; consumers "
        "waiting on it can never fire"]


def test_a_tree_with_both_packages_reports_the_same(port_index):
    """The rules read ``EventKind``, ``TIME_UNITS`` and the metric
    suffixes inside their own scope first: the JAX package beside the
    port (first in the index) changes nothing they report."""
    both = TA.RepoIndex.load(str(REPO), paths=["src", "chip_smoke.py"])
    assert both.modules[0].path.startswith("src/repro/")
    assert TA.run_rules(both) == TA.run_rules(port_index)


def test_all_rules_registered():
    assert sorted(TA.RULE_REGISTRY) == sorted(
        SHARED_RULES + ("xp-purity", "host-sync"))


# ---------------------------------------------------------------------------
# (f) the shared rules over each package, paths mapped
# ---------------------------------------------------------------------------
# the one reference finding with no port counterpart: the port's
# ``ring_scatter`` (telemetry/trace.py) is host numpy with no ``xp``
NO_COUNTERPART = {"jit-purity::src/repro/telemetry/trace.py::ring_scatter::"
                  "subscript store mutates an array in place; kernels must "
                  "return new arrays (use `xp.where` / one-hot adds)"}


@pytest.fixture(scope="module")
def package_findings():
    ref = RA.run_rules(RA.RepoIndex.load(str(REPO), paths=["src/repro"]))
    port = TA.run_rules(TA.RepoIndex.load(str(REPO),
                                          paths=["src/repro_torch"]))
    return ref, port


@pytest.mark.parametrize("ref_rule,port_rule", [
    (r, r) for r in SHARED_RULES] + [("jit-purity", "xp-purity")])
def test_rule_over_the_port_gives_the_reference_findings(
        package_findings, ref_rule, port_rule):
    ref, port = package_findings
    want = {f.key for f in ref if f.rule == ref_rule} - NO_COUNTERPART
    got = {f.key.replace("src/repro_torch/", "src/repro/")
               .replace(port_rule, ref_rule, 1)
           for f in port if f.rule == port_rule}
    assert got == want


def test_no_counterpart_is_the_reference_finding_named(package_findings):
    ref, port = package_findings
    assert NO_COUNTERPART <= {f.key for f in ref}
    assert not [f for f in port if f.rule == "host-sync"]


# ---------------------------------------------------------------------------
# (g) the CLI gate: exit codes, --json, --fix-baseline round trip
# ---------------------------------------------------------------------------
def _check_cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.check", *args],
        capture_output=True, text=True, timeout=600, cwd=cwd, env=env)


@pytest.fixture
def violation_repo(tmp_path):
    """A minimal repo with one deliberately injected unit violation in
    the port's scope."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "clock.py").write_text(
        "def deadline(start_ns, timeout_us):\n"
        "    return start_ns + timeout_us\n")
    return tmp_path


def test_cli_gate_fails_on_injected_violation(violation_repo):
    r = _check_cli("--json", "--root", str(violation_repo),
                   cwd=str(violation_repo))
    assert r.returncode == 1, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert not payload["ok"]
    (finding,) = payload["new"]
    assert finding["rule"] == "time-unit-flow"
    assert finding["path"] == "src/repro_torch/clock.py"
    assert finding["line"] == 2
    assert "mixes time units" in finding["message"]


def test_cli_fix_baseline_round_trip(violation_repo):
    r = _check_cli("--fix-baseline", "--root", str(violation_repo),
                   cwd=str(violation_repo))
    assert r.returncode == 0, r.stdout + r.stderr
    baseline = json.loads((violation_repo / BASELINE_NAME).read_text())
    (entry,) = baseline["entries"]
    assert entry["justification"].startswith("TODO")
    r2 = _check_cli("--json", "--root", str(violation_repo),
                    cwd=str(violation_repo))
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert json.loads(r2.stdout)["ok"]
    # fixing the code makes the pin stale -> the gate fails again
    (violation_repo / "src" / "repro_torch" / "clock.py").write_text(
        "def deadline(start_ns, timeout_us):\n"
        "    return start_ns + timeout_us * 1e3\n")
    r3 = _check_cli("--json", "--root", str(violation_repo),
                    cwd=str(violation_repo))
    assert r3.returncode == 1
    assert json.loads(r3.stdout)["stale_baseline"]


def test_cli_unknown_rule_exits_2(violation_repo):
    r = _check_cli("--rule", "no-such-rule", "--root", str(violation_repo),
                   cwd=str(violation_repo))
    assert r.returncode == 2


def test_cli_single_rule_filter(violation_repo):
    r = _check_cli("--json", "--rule", "frozen-spec", "--root",
                   str(violation_repo), cwd=str(violation_repo))
    assert r.returncode == 0, r.stdout + r.stderr
    assert json.loads(r.stdout)["findings"] == []


def test_cli_list_rules():
    r = _check_cli("--list-rules", cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    assert [line.split(":")[0] for line in r.stdout.splitlines()] == sorted(
        SHARED_RULES + ("xp-purity", "host-sync"))


def test_cli_gate_passes_on_the_repo_without_torch():
    """The gate is ok on this checkout, and the checker loads neither
    torch nor numpy (it runs on a machine with neither)."""
    code = ("import sys, runpy\n"
            "sys.argv = ['check', '--json']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis.check',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    loaded = sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('torch', 'numpy', 'jax', 'repro'))\n"
            "    print(loaded, file=sys.stderr)\n"
            "    sys.exit(e.code if not loaded else 3)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=str(REPO), env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(r.stdout)
    assert payload["ok"] and payload["baselined"] == 1
