"""Pass 2 — time-unit flow checker (the port's copy of the JAX package's).

Lightweight unit inference over the repo's four time domains — virtual
nanoseconds (sim), microseconds (scenario specs), PU cycles (PsPIN
hardware costs), and engine steps (serving) — without executing any
code.  Units are sourced from:

  * name suffixes: ``*_ns`` / ``*_us`` / ``*_cycles`` / ``*_steps``;
  * repo-known bare names (``now`` is virtual ns inside ``sim/``);
  * conversion idioms: ``x_us * 1e3`` -> ns, ``x_ns / 1e3`` -> us,
    ``hw.cycles_ns(c)`` -> ns, ``wire_ns_per_byte(...)`` -> ns/byte
    (so ``nbytes * ns_per_byte`` -> ns);

and flow forward through local assignments.  Findings fire on
cross-unit ``+``/``-``/comparisons, on assigning a value of one unit to
a name suffixed with another, on keyword arguments whose name declares
a different unit than the value carries, on non-cycles arguments to
``cycles_ns``, and on ``time_unit`` string literals outside the
``TIME_UNITS`` whitelist (read statically from ``api/report.py`` so the
checker and ``RunReport.validate`` share one source of truth).
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (
    PORT_SCOPE, Module, Finding, RepoIndex, Rule, const_value, is_const,
    lookup_order, register_rule,
)

TIME_UNIT_SUFFIXES = {"ns": "ns", "us": "us", "cycles": "cycles",
                      "steps": "steps"}
RATE = "ns_per_byte"          # ns/byte rate: multiplying by bytes yields ns
RATE_NAMES = {"ns_per_b", "ns_per_byte", "wire_ns_per_byte"}
# functions with a known result unit (matched on the terminal call name)
FUNC_UNITS = {"cycles_ns": "ns", "wire_ns_per_byte": RATE}
US_TO_NS = {1e3, 1000, 1000.0}
NS_TO_US = {1e-3, 0.001}
# bare names with a repo-defined unit, per module glob
KNOWN_NAME_UNITS: Tuple[Tuple[str, Dict[str, str]], ...] = (
    ("src/repro_torch/sim/*", {"now": "ns"}),
)
DEFAULT_TIME_UNITS = ("ns", "steps")


def suffix_unit(name: str) -> Optional[str]:
    for suf, unit in TIME_UNIT_SUFFIXES.items():
        if name == suf or name.endswith("_" + suf):
            return unit
    if name in RATE_NAMES:
        return RATE
    return None


def _chain_str(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(parts[::-1])
    return None


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


class _FunctionChecker(ast.NodeVisitor):
    """Infers units through one function (or module) body in source
    order, emitting findings on cross-unit flow."""

    def __init__(self, rule: "TimeUnitFlowRule", module: Module,
                 known: Dict[str, str], time_units: Set[str]):
        self.rule = rule
        self.module = module
        self.known = known          # bare-name -> unit for this module
        self.time_units = time_units
        self.env: Dict[str, str] = {}
        self.findings: List[Finding] = []
        self._reported: set = set()

    # -- unit inference ------------------------------------------------------
    def unit_of(self, node: ast.AST) -> Optional[str]:
        if isinstance(node, (ast.Name, ast.Attribute)):
            chain = _chain_str(node)
            if chain is not None and chain in self.env:
                return self.env[chain]
            term = _terminal_name(node)
            if term is None:
                return None
            u = suffix_unit(term)
            if u is not None:
                return u
            return self.known.get(term)
        if isinstance(node, ast.Call):
            term = _terminal_name(node.func)
            if term in FUNC_UNITS:
                return FUNC_UNITS[term]
            return None
        if isinstance(node, ast.BinOp):
            return self._binop_unit(node)
        if isinstance(node, ast.IfExp):
            a, b = self.unit_of(node.body), self.unit_of(node.orelse)
            if a == b:
                return a
            # `x if cond else 0`: the zero is unit-neutral
            if const_value(node.orelse) in (0, 0.0):
                return a
            if const_value(node.body) in (0, 0.0):
                return b
            return None
        if isinstance(node, ast.BoolOp):
            us = {self.unit_of(v) for v in node.values}
            return us.pop() if len(us) == 1 else None
        if isinstance(node, ast.UnaryOp):
            return self.unit_of(node.operand)
        if isinstance(node, ast.Subscript):
            return self.unit_of(node.value)   # t_ns[i] carries t_ns's unit
        return None

    def _binop_unit(self, node: ast.BinOp) -> Optional[str]:
        lu, ru = self.unit_of(node.left), self.unit_of(node.right)
        lc, rc = const_value(node.left), const_value(node.right)
        if isinstance(node.op, ast.Mult):
            if RATE in (lu, ru):
                other = ru if lu == RATE else lu
                return "ns" if other is None else None
            for u, c in ((lu, rc), (ru, lc)):
                if u == "us" and c in US_TO_NS:
                    return "ns"
                if u == "ns" and c in NS_TO_US:
                    return "us"
            if lu is not None and ru is None:
                return lu
            if ru is not None and lu is None:
                return ru
            return None
        if isinstance(node.op, ast.Div):
            if lu is not None and lu == ru:
                return None          # ratio of like units
            if lu == "ns" and rc in US_TO_NS:
                return "us"
            if lu is not None and ru is None and is_const(node.right):
                return lu            # plain scaling
            return None
        if isinstance(node.op, (ast.Add, ast.Sub)):
            if lu is not None and ru is not None and lu != ru:
                self._mix(node, lu, ru, "+" if isinstance(node.op, ast.Add)
                          else "-")
                return lu
            return lu if lu is not None else ru
        if isinstance(node.op, ast.Mod):
            return lu
        return None

    def _mix(self, node: ast.AST, a: str, b: str, op: str) -> None:
        if id(node) in self._reported:
            return
        self._reported.add(id(node))
        self.findings.append(self.rule.finding(
            self.module, node,
            f"`{op}` mixes time units: {a} and {b} (convert explicitly "
            "before combining)"))

    # -- visitors ------------------------------------------------------------
    def visit_BinOp(self, node: ast.BinOp) -> None:
        # evaluate every arithmetic node so cross-unit mixes are caught
        # wherever they appear (call arguments, returns, subscripts...)
        self.generic_visit(node)
        self.unit_of(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        vu = self.unit_of(node.value)
        for t in node.targets:
            self._bind_target(t, vu, node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self.generic_visit(node)
        if node.value is not None:
            self._bind_target(node.target, self.unit_of(node.value), node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        tu = self.unit_of(node.target)
        vu = self.unit_of(node.value)
        if (isinstance(node.op, (ast.Add, ast.Sub)) and tu is not None
                and vu is not None and tu != vu):
            self._mix(node, tu, vu, "+=" if isinstance(node.op, ast.Add)
                      else "-=")

    def _bind_target(self, target: ast.AST, vu: Optional[str],
                     node: ast.AST) -> None:
        chain = _chain_str(target)
        if chain is None:
            return
        term = _terminal_name(target)
        declared = suffix_unit(term) if term else None
        if declared is not None and vu is not None and declared != vu:
            self.findings.append(self.rule.finding(
                self.module, node,
                f"assigns a {vu} value to `{term}` "
                f"(name declares {declared})"))
        self.env[chain] = declared if declared is not None else vu

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        term = _terminal_name(node.func)
        # unit-typed keyword arguments
        for kw in node.keywords:
            if kw.arg is None:
                continue
            # time_unit= literal whitelist ("time_unit" itself carries no
            # unit suffix, so this must come before the suffix bail-out)
            if kw.arg == "time_unit":
                v = const_value(kw.value)
                if isinstance(v, str) and v not in self.time_units:
                    self.findings.append(self.rule.finding(
                        self.module, node,
                        f"time_unit={v!r} is not one of "
                        f"{sorted(self.time_units)} (TIME_UNITS)"))
                continue
            declared = suffix_unit(kw.arg)
            if declared is None:
                continue
            vu = self.unit_of(kw.value)
            if vu is not None and vu != declared:
                self.findings.append(self.rule.finding(
                    self.module, node,
                    f"keyword `{kw.arg}=` declares {declared} but the "
                    f"value carries {vu}"))
        # cycles -> ns converter takes cycles
        if term == "cycles_ns" and node.args:
            au = self.unit_of(node.args[0])
            if au is not None and au != "cycles":
                self.findings.append(self.rule.finding(
                    self.module, node,
                    f"cycles_ns() applied to a {au} value"))

    def visit_Compare(self, node: ast.Compare) -> None:
        self.generic_visit(node)
        sides = [node.left] + node.comparators
        # time_unit == "literal" whitelist check
        terms = [_terminal_name(s) for s in sides]
        if "time_unit" in terms:
            for s in sides:
                lits = ([s] if isinstance(s, ast.Constant)
                        else list(s.elts) if isinstance(s, (ast.Tuple,
                                                            ast.List,
                                                            ast.Set))
                        else [])
                for lit in lits:
                    v = const_value(lit)
                    if isinstance(v, str) and v not in self.time_units:
                        self.findings.append(self.rule.finding(
                            self.module, lit,
                            f"time_unit compared against {v!r}, not one "
                            f"of {sorted(self.time_units)} (TIME_UNITS)"))
            return
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return
        units = [self.unit_of(s) for s in sides]
        seen = [u for u in units if u is not None]
        if len(set(seen)) > 1:
            a, b = sorted(set(seen))[:2]
            self._mix(node, a, b, "comparison")

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs get their own checker (fresh env)
        sub = _FunctionChecker(self.rule, self.module, self.known,
                               self.time_units)
        sub.seed_params(node)
        for stmt in node.body:
            sub.visit(stmt)
        self.findings.extend(sub.findings)

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def seed_params(self, fn: ast.AST) -> None:
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            u = suffix_unit(a.arg)
            if u is not None:
                self.env[a.arg] = u


@register_rule
class TimeUnitFlowRule(Rule):
    name = "time-unit-flow"
    description = ("ns/us/cycles/steps values must not be combined "
                   "without explicit conversion; RunReport time_unit "
                   "literals must come from TIME_UNITS")

    def __init__(self, scope: Tuple[str, ...] = PORT_SCOPE):
        self.scope = scope

    def run(self, index: RepoIndex) -> List[Finding]:
        time_units = self._time_units(index, self.scope)
        findings: List[Finding] = []
        for mod in index.matching(list(self.scope)):
            known: Dict[str, str] = {}
            for pattern, names in KNOWN_NAME_UNITS:
                if fnmatch.fnmatch(mod.path, pattern):
                    known.update(names)
            checker = _FunctionChecker(self, mod, known, time_units)
            for stmt in mod.tree.body:
                checker.visit(stmt)
            findings.extend(checker.findings)
        return findings

    @staticmethod
    def _time_units(index: RepoIndex, scope: Tuple[str, ...]) -> Set[str]:
        """The TIME_UNITS whitelist, read statically from the module that
        defines it (api/report.py), inside ``scope`` first."""
        for mod in lookup_order(index, scope):
            for stmt in mod.tree.body:
                if (isinstance(stmt, ast.Assign)
                        and any(isinstance(t, ast.Name)
                                and t.id == "TIME_UNITS"
                                for t in stmt.targets)
                        and isinstance(stmt.value, (ast.Tuple, ast.List,
                                                    ast.Set))):
                    vals = {const_value(e) for e in stmt.value.elts}
                    strs = {v for v in vals if isinstance(v, str)}
                    if strs:
                        return strs
        return set(DEFAULT_TIME_UNITS)
