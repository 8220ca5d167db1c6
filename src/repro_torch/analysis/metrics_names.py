"""Pass 6 — exported-metric name checker (the port's copy of the JAX
package's).

Lints every literal ``MetricSpec(...)`` declaration (the exporter's
``METRICS`` registry in ``telemetry/export.py`` — and anything else
that mints one) without importing anything:

  * names must be snake_case (``[a-z][a-z0-9_]*``);
  * the last name component must equal the declared ``unit``, and the
    unit must come from the whitelist — the report schema's
    ``TIME_UNITS`` (read statically from ``api/report.py``, the same
    single source of truth the time-unit-flow pass uses) plus the
    exporter's dimensionless suffixes (read statically from
    ``DIMENSIONLESS_SUFFIXES`` where it is defined);
  * ``kind`` must be ``counter`` or ``gauge``, and counters must end
    ``_total`` (the OpenMetrics convention);
  * no two specs may declare the same name + label set — duplicate
    sample shapes silently shadow each other at scrape time.

Dynamic declarations (non-literal name/kind/unit) are themselves
findings: the registry exists so the exported surface is statically
known.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (
    PORT_SCOPE, Module, Finding, RepoIndex, Rule, const_value, lookup_order,
    register_rule,
)
from repro_torch.analysis.units import TimeUnitFlowRule

SNAKE_CASE = re.compile(r"^[a-z][a-z0-9_]*$")
METRIC_KINDS = ("counter", "gauge")
# fallbacks when the defining modules are outside the scanned index
# (fixture runs) — mirror export.py / api/report.py
DEFAULT_DIMENSIONLESS = ("total", "ratio", "count")
DEFAULT_LABELS = ("tenant", "backend")


def _str_tuple_assign(index: RepoIndex, name: str,
                      scope: Tuple[str, ...]) -> Optional[Tuple[str, ...]]:
    """Statically read a module-level ``NAME = ("a", "b", ...)`` string
    tuple from wherever the index defines it, inside ``scope`` first."""
    for mod in lookup_order(index, scope):
        for stmt in mod.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in stmt.targets)
                    and isinstance(stmt.value, (ast.Tuple, ast.List))):
                vals = tuple(const_value(e) for e in stmt.value.elts)
                if all(isinstance(v, str) for v in vals):
                    return vals
    return None


def _call_arg(node: ast.Call, pos: int, kw: str) -> Optional[ast.AST]:
    if len(node.args) > pos:
        return node.args[pos]
    for k in node.keywords:
        if k.arg == kw:
            return k.value
    return None


@register_rule
class MetricNamesRule(Rule):
    name = "metric-names"
    description = ("exported MetricSpec names must be snake_case, end in "
                   "their declared unit (TIME_UNITS + dimensionless "
                   "whitelist), counters must end _total, and no "
                   "name+labelset may repeat")

    def __init__(self, scope: Tuple[str, ...] = PORT_SCOPE):
        self.scope = scope

    def run(self, index: RepoIndex) -> List[Finding]:
        time_units = TimeUnitFlowRule._time_units(index, self.scope)
        dimless = (_str_tuple_assign(index, "DIMENSIONLESS_SUFFIXES",
                                     self.scope)
                   or DEFAULT_DIMENSIONLESS)
        allowed: Set[str] = set(time_units) | set(dimless)
        findings: List[Finding] = []
        seen: Dict[Tuple[str, Tuple[str, ...]], Tuple[Module, ast.AST]] = {}
        for mod in index.matching(list(self.scope)):
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and self._is_metric_spec(node.func)):
                    continue
                findings.extend(
                    self._check_spec(mod, node, allowed, seen))
        return findings

    @staticmethod
    def _is_metric_spec(func: ast.AST) -> bool:
        if isinstance(func, ast.Name):
            return func.id == "MetricSpec"
        if isinstance(func, ast.Attribute):
            return func.attr == "MetricSpec"
        return False

    def _check_spec(self, mod: Module, node: ast.Call, allowed: Set[str],
                    seen: dict) -> List[Finding]:
        out: List[Finding] = []
        name = const_value(_call_arg(node, 0, "name"))
        kind = const_value(_call_arg(node, 1, "kind"))
        unit = const_value(_call_arg(node, 2, "unit"))
        if not isinstance(name, str) or not isinstance(kind, str) \
                or not isinstance(unit, str):
            out.append(self.finding(
                mod, node,
                "MetricSpec name/kind/unit must be string literals — the "
                "exported surface is statically declared"))
            return out
        if not SNAKE_CASE.match(name):
            out.append(self.finding(
                mod, node, f"metric name {name!r} is not snake_case"))
        if unit not in allowed:
            out.append(self.finding(
                mod, node,
                f"metric {name!r} declares unit {unit!r}, not one of "
                f"{sorted(allowed)} (TIME_UNITS + dimensionless suffixes)"))
        if not name.endswith("_" + unit):
            out.append(self.finding(
                mod, node,
                f"metric name {name!r} does not end in its declared "
                f"unit suffix `_{unit}`"))
        if kind not in METRIC_KINDS:
            out.append(self.finding(
                mod, node,
                f"metric {name!r} kind {kind!r} is not one of "
                f"{METRIC_KINDS}"))
        elif kind == "counter" and not name.endswith("_total"):
            out.append(self.finding(
                mod, node,
                f"counter {name!r} must end `_total` (OpenMetrics)"))
        labels = self._labels(node)
        key = (name, labels)
        if key in seen:
            prev_mod, prev_node = seen[key]
            out.append(self.finding(
                mod, node,
                f"duplicate metric {name!r} with labels {list(labels)} "
                f"(first declared at {prev_mod.path}:"
                f"{getattr(prev_node, 'lineno', 0)})"))
        else:
            seen[key] = (mod, node)
        return out

    @staticmethod
    def _labels(node: ast.Call) -> Tuple[str, ...]:
        arg = _call_arg(node, 4, "labels")
        if arg is None:
            return tuple(sorted(DEFAULT_LABELS))
        if isinstance(arg, (ast.Tuple, ast.List)):
            vals = tuple(const_value(e) for e in arg.elts)
            if all(isinstance(v, str) for v in vals):
                return tuple(sorted(vals))
        # a named constant (LABELS_TENANT / LABELS_GLOBAL) — treat the
        # name itself as the labelset identity
        if isinstance(arg, (ast.Name, ast.Attribute)):
            return (getattr(arg, "id", None) or getattr(arg, "attr", "?"),)
        return ("?",)
