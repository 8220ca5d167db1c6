"""Pass 5 — trace span-balance (the port's copy of the JAX package's).

The flight recorder's paired span API (``span_begin`` / ``span_end`` /
``span_abandon``) keeps a per-``(stage, uid)`` open table; a stage that
is opened on some code path but never closed *or* abandoned leaks into
``flush_open`` and shows up as a permanently-OPEN span in every trace —
the observability analogue of an emitted-but-never-consumed EQ event.
This pass keeps the open/close story balanced per module:

  * every trace stage passed to ``span_begin`` must also appear in a
    ``span_end`` or ``span_abandon`` call in the same module — opening
    a stage whose close lives in another module hides the pairing from
    review and from this checker (error);
  * ``span_abandon`` must carry a *terminal* disposition (``D_DROP`` /
    ``D_REJECT`` / ``D_KILL``) — abandoning a span as OK/OPEN
    mislabels a terminated packet as healthy (error);
  * a ``span_end`` / ``span_abandon`` for a stage that is never opened
    in the module is reported (warning) — it raises ``KeyError`` at
    runtime if no other path opened the pair;
  * stage arguments must be ``ST_*`` constants (or recognizable
    aliases), not bare numbers — magic stage codes defeat the pairing
    analysis (error).

``span``/``span_packet`` record complete rows and need no balancing;
the recorder module itself (which defines the API) is skipped.

The port's wall-clock host spans (DESIGN.md §10.6) are held the same
way:

  * in each function, the spans opened (``host_root`` /
    ``host_begin``) equal those closed (``host_end``; ``host_next``
    closes one and opens one) — a step or call span left open nests
    every later span under it (error);
  * a module that moves requests through lifecycle spans
    (``host_request``) also closes them (``host_request_end``), or
    each request's last span stays open (error);
  * their name arguments are ``H_*`` constants (error).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.framework import (
    PORT_SCOPE, Finding, Module, RepoIndex, Rule, register_rule,
)

TERMINAL_DISPS = ("D_DROP", "D_REJECT", "D_KILL")
RECORDER_MODULE = "repro_torch.telemetry.trace"


def _stage_name(node: ast.AST) -> Optional[str]:
    """``TR.ST_FMQ`` / ``trace.ST_FMQ`` / bare ``ST_FMQ`` -> 'ST_FMQ'."""
    if isinstance(node, ast.Attribute) and node.attr.startswith("ST_"):
        return node.attr
    if isinstance(node, ast.Name) and node.id.startswith("ST_"):
        return node.id
    return None


def _disp_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and node.attr.startswith("D_"):
        return node.attr
    if isinstance(node, ast.Name) and node.id.startswith("D_"):
        return node.id
    return None


def _span_calls(mod: Module) -> List[Tuple[str, ast.Call]]:
    """(method, call) for every ``*.span_begin/span_end/span_abandon``."""
    out = []
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("span_begin", "span_end",
                                       "span_abandon")):
            out.append((node.func.attr, node))
    return out


HOST_OPEN = ("host_root", "host_begin")
HOST_NAMED = {"host_root": 0, "host_begin": 0, "host_next": 0,
              "host_request": 2}


def _method_calls(node: ast.AST, names) -> List[Tuple[str, ast.Call]]:
    return [(n.func.attr, n) for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr in names]


def _host_findings(rule: Rule, mod: Module) -> List[Finding]:
    out: List[Finding] = []
    for method, call in _method_calls(mod.tree, HOST_NAMED):
        name = _arg(call, HOST_NAMED[method], "name")
        if not (isinstance(name, ast.Attribute) and name.attr.startswith("H_")
                or isinstance(name, ast.Name) and name.id.startswith("H_")):
            out.append(rule.finding(
                mod, call, f"{method} name argument must be an H_* "
                "constant, not a computed or numeric value"))
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = _method_calls(fn, HOST_OPEN + ("host_end",))
        opened = sum(m in HOST_OPEN for m, _ in calls)
        closed = len(calls) - opened
        if opened != closed:
            out.append(rule.finding(
                mod, fn, f"{fn.name} opens {opened} host span(s) and "
                f"closes {closed}: an unclosed step or call span nests "
                "every later span under it"))
    moved = _method_calls(mod.tree, ("host_request",))
    if moved and not _method_calls(mod.tree, ("host_request_end",)):
        out.append(rule.finding(
            mod, moved[0][1], "host_request without a host_request_end in "
            "this module: each request's last lifecycle span stays open"))
    return out


def _arg(call: ast.Call, pos: int, kw: str) -> Optional[ast.AST]:
    if len(call.args) > pos:
        return call.args[pos]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return None


@register_rule
class SpanBalanceRule(Rule):
    name = "span-balance"
    description = ("every span_begin stage must be span_end/abandoned in "
                   "the same module, and span_abandon dispositions must "
                   "be terminal (DROP/REJECT/KILL)")

    def __init__(self, scope: Tuple[str, ...] = PORT_SCOPE):
        self.scope = scope

    def run(self, index: RepoIndex) -> List[Finding]:
        findings: List[Finding] = []
        for mod in index.matching(list(self.scope)):
            if mod.dotted == RECORDER_MODULE:
                continue
            findings += _host_findings(self, mod)
            calls = _span_calls(mod)
            if not calls:
                continue
            begins: Dict[str, ast.Call] = {}
            closes: Dict[str, ast.Call] = {}
            for method, call in calls:
                stage_node = _arg(call, 0, "stage")
                stage = (_stage_name(stage_node)
                         if stage_node is not None else None)
                if stage is None:
                    findings.append(self.finding(
                        mod, call,
                        f"{method} stage argument must be an ST_* "
                        "constant, not a computed or numeric value"))
                    continue
                if method == "span_begin":
                    begins.setdefault(stage, call)
                else:
                    closes.setdefault(stage, call)
                if method == "span_abandon":
                    disp_node = _arg(call, 3, "disp")
                    disp = (_disp_name(disp_node)
                            if disp_node is not None else None)
                    if disp is None or disp not in TERMINAL_DISPS:
                        findings.append(self.finding(
                            mod, call,
                            f"span_abandon({stage}) disposition must be "
                            f"one of {'/'.join(TERMINAL_DISPS)}, got "
                            f"{disp or 'a non-D_* expression'}: an "
                            "abandoned span is a terminated packet"))
            for stage, call in begins.items():
                if stage not in closes:
                    findings.append(self.finding(
                        mod, call,
                        f"span_begin({stage}) has no span_end/"
                        f"span_abandon for {stage} in this module: the "
                        "span leaks to flush_open as permanently OPEN"))
            for stage, call in closes.items():
                if stage not in begins:
                    findings.append(self.finding(
                        mod, call,
                        f"span_end/span_abandon({stage}) without a "
                        f"span_begin({stage}) in this module raises "
                        "KeyError unless another path opened the pair",
                        severity="warning"))
        return findings
