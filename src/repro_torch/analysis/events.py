"""Pass 3 — EQ-event exhaustiveness (the port's copy of the JAX package's).

The event queue (paper §5.2) is the tenants' only notification channel,
so an ``EventKind`` that is emitted but never consumed — or consumed
but impossible to emit — is a silent contract break.  This pass keeps
the enum, the emit sites, and the consumption story in lockstep:

  * every declared ``EventKind`` member must have an entry in the
    ``EVENT_DISPOSITIONS`` registry next to the enum, naming where the
    event is consumed (report/telemetry/control handling) — adding a
    kind without deciding its consumer is an error;
  * every kind listed in ``EVENT_DISPOSITIONS`` must still exist on the
    enum (no stale registry rows);
  * every kind that is emitted somewhere in ``src/`` must appear in a
    consume context (a comparison / membership test / dispatch-dict key)
    or carry a registry entry;
  * a declared kind that is never emitted anywhere is reported
    (warning) — consumers waiting on it can never fire.

Emit contexts are occurrences of ``EventKind.X`` inside call arguments,
returns, or dict *values* (the fastpath's small-int code tables);
consume contexts are comparisons, ``in`` tests, and dict *keys*.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (
    PORT_SCOPE, Module, Finding, RepoIndex, Rule, lookup_order, register_rule,
)

ENUM_NAME = "EventKind"
REGISTRY_NAME = "EVENT_DISPOSITIONS"


def _find_enum(index: RepoIndex, scope: Tuple[str, ...]
               ) -> Optional[Tuple[Module, ast.ClassDef]]:
    for mod in lookup_order(index, scope):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == ENUM_NAME:
                return mod, node
    return None


def _enum_members(cls: ast.ClassDef) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out[t.id] = stmt
    return out


def _find_registry(mod: Module) -> Optional[Tuple[ast.Assign, ast.Dict]]:
    for stmt in mod.tree.body:
        if (isinstance(stmt, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == REGISTRY_NAME
                        for t in stmt.targets)
                and isinstance(stmt.value, ast.Dict)):
            return stmt, stmt.value
    return None


def _kind_refs(mod: Module) -> List[ast.Attribute]:
    """All ``EventKind.X`` attribute references in a module."""
    out = []
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == ENUM_NAME):
            out.append(node)
    return out


def _classify(ref: ast.Attribute) -> str:
    """'consume' | 'emit' | 'neutral' based on the syntactic context."""
    node: ast.AST = ref
    parent = getattr(node, "parent", None)
    while parent is not None:
        if isinstance(parent, ast.Compare):
            return "consume"
        if isinstance(parent, (ast.Tuple, ast.List, ast.Set)):
            gp = getattr(parent, "parent", None)
            if isinstance(gp, ast.Compare) and parent in gp.comparators:
                return "consume"   # `kind in (A, B)`
            node, parent = parent, gp
            continue
        if isinstance(parent, ast.Dict):
            if node in parent.keys:
                return "consume"   # dispatch table key
            if node in parent.values:
                return "emit"      # code -> kind decode table
            return "neutral"
        if isinstance(parent, ast.Subscript) and node is parent.slice:
            return "consume"       # table[EventKind.X]
        if isinstance(parent, ast.Call):
            return "emit"          # Event(..., kind), push_raw(kind), ...
        if isinstance(parent, (ast.Return, ast.IfExp)):
            return "emit"          # kill_kind()-style producers
        if isinstance(parent, ast.arguments):
            return "emit"          # default value flowing into an emit
        if isinstance(parent, (ast.Assign, ast.keyword)):
            node, parent = parent, getattr(parent, "parent", None)
            continue
        if isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef, ast.Module)):
            return "neutral"
        node, parent = parent, getattr(parent, "parent", None)
    return "neutral"


@register_rule
class EventExhaustivenessRule(Rule):
    name = "eq-event-exhaustiveness"
    description = ("every EventKind must be registered in "
                   "EVENT_DISPOSITIONS and every emitted kind must have "
                   "a consumer; unreachable kinds are reported")

    def __init__(self, scope: Tuple[str, ...] = PORT_SCOPE):
        self.scope = scope

    def run(self, index: RepoIndex) -> List[Finding]:
        found = _find_enum(index, self.scope)
        if found is None:
            return []
        enum_mod, enum_cls = found
        members = _enum_members(enum_cls)
        findings: List[Finding] = []

        registry = _find_registry(enum_mod)
        reg_keys: Dict[str, ast.AST] = {}
        if registry is None:
            findings.append(self.finding(
                enum_mod, enum_cls,
                f"no {REGISTRY_NAME} registry next to {ENUM_NAME}: each "
                "kind must name where it is consumed"))
        else:
            stmt, dct = registry
            for k, v in zip(dct.keys, dct.values):
                if (isinstance(k, ast.Attribute)
                        and isinstance(k.value, ast.Name)
                        and k.value.id == ENUM_NAME):
                    reg_keys[k.attr] = k
                    if not (isinstance(v, ast.Constant)
                            and isinstance(v.value, str) and v.value.strip()):
                        findings.append(self.finding(
                            enum_mod, k,
                            f"{REGISTRY_NAME}[{ENUM_NAME}.{k.attr}] must "
                            "be a non-empty string naming the consumer"))
            for name, key_node in reg_keys.items():
                if name not in members:
                    findings.append(self.finding(
                        enum_mod, key_node,
                        f"{REGISTRY_NAME} lists {ENUM_NAME}.{name}, which "
                        "is not a declared member (stale registry row)"))

        emitted: Set[str] = set()
        consumed: Set[str] = set()
        for mod in index.matching(list(self.scope)):
            if mod.path == enum_mod.path:
                continue
            for ref in _kind_refs(mod):
                ctx = _classify(ref)
                if ctx == "emit":
                    emitted.add(ref.attr)
                elif ctx == "consume":
                    consumed.add(ref.attr)

        for name, node in members.items():
            if registry is not None and name not in reg_keys:
                findings.append(self.finding(
                    enum_mod, node,
                    f"{ENUM_NAME}.{name} has no {REGISTRY_NAME} entry: "
                    "declare where this event is consumed"))
            if name not in emitted:
                findings.append(self.finding(
                    enum_mod, node,
                    f"{ENUM_NAME}.{name} is declared but never emitted; "
                    "consumers waiting on it can never fire",
                    severity="warning"))
        for name in sorted(emitted):
            if name in members and name not in consumed \
                    and name not in reg_keys:
                findings.append(self.finding(
                    enum_mod, members[name],
                    f"{ENUM_NAME}.{name} is emitted but never consumed "
                    f"and has no {REGISTRY_NAME} entry"))
        return findings
