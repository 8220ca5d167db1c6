"""Pass 4 — frozen-spec + fixed-shape discipline (the port's copy of the
JAX package's).

Two related invariants:

  * **frozen-spec** — ``ScenarioSpec``/``TenantSpec`` (and the other
    ``api/spec.py`` frozen dataclasses) are immutable inputs: after
    construction nothing may assign to their attributes, ``setattr``
    them, or smuggle writes through ``object.__setattr__``.  Evolution
    goes through ``spec.replace(...)`` / ``dataclasses.replace``.
    Spec-typed names are recognized from parameter annotations,
    constructor calls, ``.replace()`` results, and the conventional
    ``spec`` parameter name.

  * **fixed-shape** — telemetry collector kernels (the ``xp``-generic
    functions in ``telemetry/metrics.py`` and their ``*_torch``
    counterparts, the ``"torch"`` backend's device commits) must allocate
    fixed shapes only: no ``nonzero``/``unique``/``masked_select``-style
    data-dependent producers and no boolean-mask indexing, which would
    sync the host in a commit that must not.
"""
from __future__ import annotations

import ast
from typing import List, Set, Tuple

from repro_torch.analysis.framework import (
    PORT_SCOPE, TORCH_KERNEL_SUFFIX, Module, Finding, RepoIndex, Rule,
    register_rule,
)

SPEC_CLASSES = {
    "ScenarioSpec", "TenantSpec", "WorkloadSpec", "ArrivalSpec",
    "ControllerSpec", "ServeSpec",
}
SPEC_PARAM_NAMES = {"spec"}
# the defining module may use object.__setattr__ in __post_init__
DEFINING_MODULES = ("src/repro_torch/api/spec.py",)

DYNAMIC_SHAPE_ATTRS = {"nonzero", "flatnonzero", "unique", "argwhere",
                       "masked_select"}


def _ann_name(ann) -> str:
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split(".")[-1]
    if isinstance(ann, ast.Subscript):     # Optional[TenantSpec]
        return _ann_name(ann.slice)
    return ""


def _spec_names_in(fn: ast.AST) -> Set[str]:
    """Names bound to spec instances inside one function scope."""
    names: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if _ann_name(a.annotation) in SPEC_CLASSES or \
                a.arg in SPEC_PARAM_NAMES:
            names.add(a.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fname = node.value.func
            called = (fname.id if isinstance(fname, ast.Name)
                      else fname.attr if isinstance(fname, ast.Attribute)
                      else "")
            is_ctor = called in SPEC_CLASSES
            is_replace = (called == "replace"
                          and isinstance(fname, ast.Attribute)
                          and isinstance(fname.value, ast.Name)
                          and fname.value.id in names)
            if is_ctor or is_replace:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


@register_rule
class FrozenSpecRule(Rule):
    name = "frozen-spec"
    description = ("ScenarioSpec/TenantSpec and friends are immutable "
                   "after construction — use spec.replace(...)")

    def __init__(self, scope: Tuple[str, ...] = PORT_SCOPE,
                 defining: Tuple[str, ...] = DEFINING_MODULES):
        self.scope = scope
        self.defining = defining

    def run(self, index: RepoIndex) -> List[Finding]:
        findings: List[Finding] = []
        for mod in index.matching(list(self.scope)):
            if mod.path in self.defining:
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    findings.extend(self._check_scope(mod, node))
        return findings

    def _check_scope(self, mod: Module, fn: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        specs = _spec_names_in(fn)
        if not specs:
            return findings

        def is_spec_attr(target: ast.AST) -> bool:
            return (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id in specs)

        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if is_spec_attr(t):
                        findings.append(self.finding(
                            mod, t,
                            f"assignment to frozen spec attribute "
                            f"`{t.value.id}.{t.attr}`; build a new spec "
                            "with `.replace(...)`"))
            elif isinstance(node, ast.AugAssign) and is_spec_attr(node.target):
                t = node.target
                findings.append(self.finding(
                    mod, t,
                    f"in-place update of frozen spec attribute "
                    f"`{t.value.id}.{t.attr}`"))
            elif isinstance(node, ast.Call):
                f = node.func
                if (isinstance(f, ast.Name) and f.id == "setattr"
                        and node.args
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in specs):
                    findings.append(self.finding(
                        mod, node,
                        f"setattr on frozen spec `{node.args[0].id}`"))
                elif (isinstance(f, ast.Attribute)
                      and f.attr == "__setattr__" and node.args
                      and isinstance(node.args[0], ast.Name)
                      and node.args[0].id in specs):
                    findings.append(self.finding(
                        mod, node,
                        f"`object.__setattr__` bypasses the frozen spec "
                        f"contract on `{node.args[0].id}`"))
        return findings


@register_rule
class FixedShapeRule(Rule):
    name = "fixed-shape"
    description = ("telemetry collector kernels must allocate fixed "
                   "shapes: no data-dependent producers or boolean-mask "
                   "indexing")

    def __init__(self, scope: Tuple[str, ...] = (
            "src/repro_torch/telemetry/*",)):
        self.scope = scope

    def run(self, index: RepoIndex) -> List[Finding]:
        findings: List[Finding] = []
        for mod in index.matching(list(self.scope)):
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                args = fn.args
                names = {a.arg for a in (args.posonlyargs + args.args
                                         + args.kwonlyargs)}
                if ("xp" not in names
                        and not fn.name.endswith(TORCH_KERNEL_SUFFIX)):
                    continue
                findings.extend(self._check_kernel(mod, fn))
        return findings

    def _check_kernel(self, mod: Module, fn: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                attr = (f.attr if isinstance(f, ast.Attribute)
                        else f.id if isinstance(f, ast.Name) else None)
                if attr in DYNAMIC_SHAPE_ATTRS:
                    findings.append(self.finding(
                        mod, node,
                        f"`{attr}` allocates a data-dependent shape in a "
                        "telemetry collector kernel"))
                elif (attr == "where" and len(node.args) == 1
                      and not node.keywords):
                    findings.append(self.finding(
                        mod, node,
                        "one-argument `where` is data-dependent; use the "
                        "three-argument select form"))
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.slice, ast.Compare)):
                findings.append(self.finding(
                    mod, node,
                    "boolean-mask indexing yields a data-dependent shape "
                    "in a telemetry collector kernel"))
        return findings
