"""Pass 1 — device purity: ``xp-purity`` and ``host-sync``.

The JAX package's ``jit-purity`` scopes the functions that take ``xp``
and those reached from ``jax.jit``.  The port has no ``jax.jit``; its
counterparts are the code that must never wait for the host: the
sweep's plain step (replayed as CUDA graphs), the ``"torch"`` telemetry
backend's commits (run under ``torch.cuda.set_sync_debug_mode("error")``)
and the serve step's functions (where the reference jits).  Two rules:

  * **xp-purity** — the reference's checks, unchanged, on the
    backend-generic functions (those taking ``xp``: ``core/
    sched_generic.py``, ``telemetry/metrics.py``) and what they call:
    no in-place numpy APIs or subscript stores, no bare ``np.*`` outside
    the host-constant allowlist, no Python branch on a traced value, no
    data-dependent shape.

  * **host-sync** — on the device roots:

      - every function called in the body of a ``with
        torch.cuda.graph(...)`` block (``kernels/ref.py``'s ``_step``);
      - every ``*_torch`` function of a sync-free module
        (``telemetry/*``: the ``"torch"`` backend's kernels);
      - the functions the serve step hands the engine: the
        ``prefill_chunk`` / ``prefill_rows`` / ``decode`` /
        ``reset_slots`` of each ``ServeFns(...)`` (both branches of
        ``serving/serve_step.py``; ``decode`` and ``prefill_rows`` are
        what ``serving/call_graphs.py`` captures), through names, lambdas,
        factories' returned closures and both arms of a conditional
        expression, also when bound to a local name first;

    and what they call, by the reference's call graph: module functions
    by name and import, nested closures, and function-typed arguments of
    control-flow helpers.  Inside that scope each of these is an error:

      - a host sync: ``.item()``, ``.tolist()``, ``.cpu()``,
        ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``, and
        ``float()`` / ``int()`` / ``bool()`` of a traced parameter;
      - a Python ``if`` / ``while`` / ternary / ``assert`` on a traced
        value (the reference's static tests: ``is None``, shapes and
        other tensor metadata, annotated Python scalars);
      - a data-dependent shape: ``nonzero``, ``unique``, ``argwhere``,
        ``masked_select``, ``bincount``, one-argument ``where``, a
        boolean-mask subscript;
      - a numpy call on a traced value (host constants pass, by the
        reference's allowlist).

    In-place tensor writes (``copy_``, ``scatter_``, dict stores into a
    state) are legal under capture and are not findings.  Method calls
    are not followed (their receiver's type is unknown here), and a
    method's ``self`` / ``cls`` counts as static, as ``xp`` does.  The
    first sync beyond that edge: the decode step reaches
    ``model.decode_step``, whose ragged MoE dispatch reads its group
    sizes with ``torch.bincount(...).tolist()`` (``models/moe.py:175``,
    ``apply_moe_ragged``); the serving path routes ``gshard``, which
    needs none.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.framework import (
    PORT_SCOPE, TORCH_KERNEL_SUFFIX, Finding, Module, RepoIndex, Rule,
    import_map, is_const, jnp_aliases, numpy_aliases, register_rule,
)

# modules whose xp-generic functions are subject to the kernel contract
# (roots may pull callees in from anywhere in the index)
DEFAULT_SCOPE = (
    "src/repro_torch/core/*", "src/repro_torch/telemetry/*",
    "src/repro_torch/serving/*", "src/repro_torch/sim/*",
    "src/repro_torch/kernels/*",
)

# host-sync: the modules that declare their ``*_torch`` functions sync-free
SYNC_FREE_MODULES = ("src/repro_torch/telemetry/*",)
# constructor -> the keyword arguments that carry device functions
DEVICE_FN_FIELDS = {"ServeFns": ("prefill_chunk", "prefill_rows", "decode",
                                 "reset_slots")}

# np attributes that are host constants / dtypes — fine under trace
NP_CONST_ATTRS = {
    "float16", "float32", "float64", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool_", "complex64",
    "complex128", "pi", "e", "inf", "nan", "newaxis", "ndarray", "dtype",
    "generic", "number", "integer", "floating", "finfo", "iinfo",
}

# numpy APIs that mutate an operand in place
NP_INPLACE_ATTRS = {"put", "place", "copyto", "putmask", "fill_diagonal"}

# callables whose function-typed arguments are traced (control-flow HOFs)
TRACED_HOF_ATTRS = {"scan", "cond", "while_loop", "fori_loop", "switch",
                    "map", "associative_scan", "checkpoint", "remat",
                    "vmap", "grad", "value_and_grad"}

DYNAMIC_SHAPE_ATTRS = {"nonzero", "flatnonzero", "unique", "argwhere"}
SYNC_SHAPE_ATTRS = DYNAMIC_SHAPE_ATTRS | {"masked_select", "bincount"}
# tensor methods that copy to the host and wait for the card
SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
SYNC_CASTS = {"float", "int", "bool"}

SCALAR_ANNOTATIONS = {"float", "int", "bool", "str"}

FuncKey = Tuple[str, str]  # (module path, function qualname)


def _name_of(node: ast.AST) -> Optional[str]:
    return node.id if isinstance(node, ast.Name) else None


def _attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None for non-trivial bases."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class _FuncTable:
    """Every function/lambda-free def in the index, keyed by
    (path, qualname), plus per-module import maps."""

    def __init__(self, index: RepoIndex):
        self.index = index
        self.defs: Dict[FuncKey, ast.AST] = {}
        self.imports: Dict[str, Dict[str, str]] = {}
        for mod in index.modules:
            self.imports[mod.path] = import_map(mod.tree)
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.defs[(mod.path, node.qual)] = node

    def resolve(self, mod: Module, scope_qual: str,
                node: ast.AST) -> Optional[FuncKey]:
        """Resolve a called expression to a function def in the index."""
        name = _name_of(node)
        if name is not None:
            # innermost enclosing scope first, then module level
            qual = scope_qual
            while True:
                cand = f"{qual}.{name}" if qual else name
                if (mod.path, cand) in self.defs:
                    return (mod.path, cand)
                if "." not in qual:
                    break
                qual = qual.rsplit(".", 1)[0]
            if (mod.path, name) in self.defs:
                return (mod.path, name)
            dotted = self.imports[mod.path].get(name)
            if dotted:
                return self._resolve_dotted(dotted)
            return None
        chain = _attr_chain(node)
        if chain and len(chain) >= 2:
            base = self.imports[mod.path].get(chain[0])
            if base:
                return self._resolve_dotted(".".join([base] + chain[1:]))
        return None

    def _resolve_dotted(self, dotted: str) -> Optional[FuncKey]:
        if "." not in dotted:
            return None
        mod_name, func = dotted.rsplit(".", 1)
        target = self.index.by_dotted(mod_name)
        if target is not None and (target.path, func) in self.defs:
            return (target.path, func)
        return None


def _called_funcs(fn: ast.AST, table: _FuncTable, mod: Module) -> Set[FuncKey]:
    """Repo-local callees of ``fn`` (direct calls + function-typed args of
    control-flow HOFs + nested defs, which run as closures)."""
    out: Set[FuncKey] = set()
    qual = fn.qual
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node is not fn:
                out.add((mod.path, node.qual))
            continue
        if not isinstance(node, ast.Call):
            continue
        key = table.resolve(mod, qual, node.func)
        if key is not None:
            out.add(key)
        chain = _attr_chain(node.func)
        if chain and chain[-1] in TRACED_HOF_ATTRS:
            for arg in node.args:
                akey = table.resolve(mod, qual, arg)
                if akey is not None:
                    out.add(akey)
    return out


def _reach(index: RepoIndex, table: _FuncTable,
           roots: Set[FuncKey]) -> Set[FuncKey]:
    """``roots`` and every function they reach through ``_called_funcs``."""
    in_scope = set(roots)
    work = list(in_scope)
    while work:
        key = work.pop()
        fn = table.defs.get(key)
        if fn is None:
            continue
        mod = index.get(key[0])
        for callee in _called_funcs(fn, table, mod):
            if callee not in in_scope:
                in_scope.add(callee)
                work.append(callee)
    return in_scope


def _param_info(fn: ast.AST, static_names=("xp",)
                ) -> Tuple[Set[str], Set[str]]:
    """(all param names, static param names).  A parameter is static when
    annotated as a Python scalar (a trace-time constant) or named in
    ``static_names``."""
    args = fn.args
    every = [a for a in (args.posonlyargs + args.args + args.kwonlyargs)]
    if args.vararg:
        every.append(args.vararg)
    if args.kwarg:
        every.append(args.kwarg)
    names = {a.arg for a in every}
    static = set(static_names)
    for a in every:
        ann = a.annotation
        if isinstance(ann, ast.Name) and ann.id in SCALAR_ANNOTATIONS:
            static.add(a.arg)
        elif isinstance(ann, ast.Constant) and ann.value in SCALAR_ANNOTATIONS:
            static.add(a.arg)
        elif (isinstance(ann, ast.Subscript)
              and isinstance(ann.slice, ast.Name)
              and ann.slice.id in SCALAR_ANNOTATIONS):
            static.add(a.arg)  # Optional[float] etc.
    return names, static


STATIC_ATTRS = {"shape", "ndim", "size", "dtype"}  # trace-time metadata
# a tensor's metadata on the host: reading it does not wait for the card
TORCH_STATIC_ATTRS = STATIC_ATTRS | {
    "device", "is_cuda", "dim", "numel", "layout", "stride",
    "is_contiguous", "is_floating_point", "element_size", "requires_grad",
}


def _traced_ref(node: ast.Name, static_attrs=STATIC_ATTRS) -> bool:
    """False when the name is only read through trace-time metadata
    (``x.shape``, ``x.ndim``, ``len(x)``) — those comparisons are static."""
    cur: ast.AST = node
    par = getattr(cur, "parent", None)
    while isinstance(par, (ast.Attribute, ast.Subscript, ast.Call)):
        if isinstance(par, ast.Attribute) and par.attr in static_attrs:
            return False
        if (isinstance(par, ast.Call) and isinstance(par.func, ast.Name)
                and par.func.id == "len" and cur in par.args):
            return False
        cur, par = par, getattr(par, "parent", None)
    return True


def _is_static_test(test: ast.AST, params: Set[str], static: Set[str],
                    static_attrs=STATIC_ATTRS) -> bool:
    """True when a branch condition is trace-time static: only ``is`` /
    ``is not`` comparisons, shape/metadata comparisons, or no reference
    to a non-static parameter."""
    traced = params - static
    for node in ast.walk(test):
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                continue
            for sub in [node.left] + node.comparators:
                for n in ast.walk(sub):
                    if (isinstance(n, ast.Name) and n.id in traced
                            and _traced_ref(n, static_attrs)):
                        return False
        elif isinstance(node, ast.Name) and node.id in traced:
            par = node.parent
            if node is test or isinstance(par, (ast.BoolOp, ast.UnaryOp)):
                return False
    return True


def _body_nodes(fn: ast.AST) -> List[ast.AST]:
    """The function body's nodes, nested defs skipped (they are separate
    units)."""

    def walk(node: ast.AST):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            yield child
            yield from walk(child)

    return [n for stmt in fn.body for n in [stmt] + list(walk(stmt))]


class _PurityRule(Rule):
    """A rule that checks every function its roots reach."""

    def __init__(self, scope: Tuple[str, ...]):
        self.scope = scope

    def _roots(self, index: RepoIndex, table: _FuncTable) -> Set[FuncKey]:
        raise NotImplementedError  # pragma: no cover

    def in_scope(self, index: RepoIndex) -> Set[FuncKey]:
        """The functions this rule checks: its roots and their callees."""
        table = _FuncTable(index)
        return _reach(index, table, self._roots(index, table))

    def run(self, index: RepoIndex) -> List[Finding]:
        table = _FuncTable(index)
        findings: List[Finding] = []
        for key in sorted(_reach(index, table, self._roots(index, table))):
            fn = table.defs.get(key)
            mod = index.get(key[0])
            if fn is None or mod is None:
                continue
            findings.extend(self._check_function(mod, fn))
        return findings

    def _check_function(self, mod: Module,
                        fn: ast.AST) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError


@register_rule
class XpPurityRule(_PurityRule):
    name = "xp-purity"
    description = ("backend-generic (xp) kernels must stay pure: no numpy "
                   "mixing, in-place stores, traced-value branches, or "
                   "data-dependent shapes")

    def __init__(self, scope: Tuple[str, ...] = DEFAULT_SCOPE):
        super().__init__(scope)

    def _roots(self, index: RepoIndex, table: _FuncTable) -> Set[FuncKey]:
        scoped = {m.path for m in index.matching(list(self.scope))}
        return {(path, qual) for (path, qual), fn in table.defs.items()
                if path in scoped and "xp" in _param_info(fn)[0]}

    def _check_function(self, mod: Module, fn: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        np_names = numpy_aliases(mod.tree)
        jnp_names = jnp_aliases(mod.tree)
        params, static = _param_info(fn)
        guarded = _np_guarded_nodes(fn, np_names)
        consts = _module_constants(mod.tree)

        for node in _body_nodes(fn):
            # np.<ufunc>.at(...) — in-place scatter
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "at"):
                chain = _attr_chain(node.func)
                if chain and chain[0] in np_names:
                    findings.append(self.finding(
                        mod, node,
                        f"in-place `{'.'.join(chain)}` update inside a "
                        "backend-generic/jit-traced kernel"))
                    continue
            # subscript stores
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        findings.append(self.finding(
                            mod, t,
                            "subscript store mutates an array in place; "
                            "kernels must return new arrays "
                            "(use `xp.where` / one-hot adds)"))
            # bare numpy references (backend mixing)
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in np_names):
                if _np_use_allowed(node, guarded, consts):
                    continue
                findings.append(self.finding(
                    mod, node,
                    f"`{node.value.id}.{node.attr}` inside a backend-"
                    "generic/jit-traced kernel mixes numpy into the "
                    "traced path (use `xp`)"))
            # Python branches on traced values
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if not _is_static_test(node.test, params, static):
                    kind = ("while" if isinstance(node, ast.While) else "if")
                    findings.append(self.finding(
                        mod, node,
                        f"Python `{kind}` on a traced value; use "
                        "`xp.where` (only `is None` / annotated-scalar "
                        "config branches are static under jit)"))
            # data-dependent shapes
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                attr = chain[-1] if chain else None
                base_ok = (chain and (chain[0] in np_names
                                      or chain[0] in jnp_names
                                      or chain[0] == "xp"))
                if attr in DYNAMIC_SHAPE_ATTRS and chain is not None:
                    findings.append(self.finding(
                        mod, node,
                        f"`{attr}` produces a data-dependent shape; "
                        "jit-traced kernels must stay fixed-shape"))
                elif (attr == "where" and base_ok and len(node.args) == 1
                      and not node.keywords):
                    findings.append(self.finding(
                        mod, node,
                        "one-argument `where` returns data-dependent "
                        "indices; use the three-argument select form"))
        return findings


@register_rule
class HostSyncRule(_PurityRule):
    name = "host-sync"
    description = ("CUDA-graph bodies, sync-free *_torch kernels and the "
                   "serve step's functions must not sync the host: no "
                   ".item()/.cpu()-style copies, traced-value branches, "
                   "data-dependent shapes or numpy on device values")

    def __init__(self, scope: Tuple[str, ...] = PORT_SCOPE,
                 sync_free: Tuple[str, ...] = SYNC_FREE_MODULES):
        super().__init__(scope)
        self.sync_free = sync_free

    # -- roots ---------------------------------------------------------------
    def _roots(self, index: RepoIndex, table: _FuncTable) -> Set[FuncKey]:
        roots: Set[FuncKey] = set()
        sync_free = {m.path for m in index.matching(list(self.sync_free))}
        for mod in index.matching(list(self.scope)):
            for node in ast.walk(mod.tree):
                if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and mod.path in sync_free
                        and node.name.endswith(TORCH_KERNEL_SUFFIX)):
                    roots.add((mod.path, node.qual))
                elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                        _is_graph_capture(item.context_expr)
                        for item in node.items):
                    for stmt in node.body:
                        for sub in ast.walk(stmt):
                            if isinstance(sub, ast.Call):
                                key = table.resolve(mod, node.qual, sub.func)
                                if key is not None:
                                    roots.add(key)
                elif isinstance(node, ast.Call):
                    chain = _attr_chain(node.func)
                    fields = DEVICE_FN_FIELDS.get(chain[-1] if chain else "")
                    for kw in node.keywords:
                        if fields and kw.arg in fields:
                            roots |= _function_values(table, mod, node.qual,
                                                      kw.value)
        return roots

    # -- checks --------------------------------------------------------------
    def _check_function(self, mod: Module, fn: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        np_names = numpy_aliases(mod.tree)
        params, static = _param_info(fn, ("xp", "self", "cls"))
        traced = params - static
        guarded = _np_guarded_nodes(fn, np_names)
        consts = _module_constants(mod.tree)

        def reads_traced(expr: ast.AST) -> bool:
            return any(isinstance(n, ast.Name) and n.id in traced
                       and _traced_ref(n, TORCH_STATIC_ATTRS)
                       for n in ast.walk(expr))

        for node in _body_nodes(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                if not _is_static_test(node.test, params, static,
                                       TORCH_STATIC_ATTRS):
                    kind = {ast.While: "while", ast.Assert: "assert"}.get(
                        type(node), "if")
                    findings.append(self.finding(
                        mod, node,
                        f"Python `{kind}` on a traced value syncs the host "
                        "(use `torch.where`; only `is None` / metadata / "
                        "annotated-scalar tests are static)"))
            elif (isinstance(node, ast.Subscript)
                  and isinstance(node.slice, ast.Compare)):
                findings.append(self.finding(
                    mod, node,
                    "boolean-mask indexing yields a data-dependent shape "
                    "and syncs the host"))
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else _name_of(node.func))
            if (attr in SYNC_METHODS and isinstance(node.func, ast.Attribute)
                    and not node.args and not node.keywords):
                findings.append(self.finding(
                    mod, node, f"`.{attr}()` copies to the host and waits "
                               "for the card"))
            elif attr == "to" and _to_cpu(node):
                findings.append(self.finding(
                    mod, node, "`.to(\"cpu\")` copies to the host and waits "
                               "for the card"))
            elif chain and chain[-2:] == ["cuda", "synchronize"]:
                findings.append(self.finding(
                    mod, node, "`torch.cuda.synchronize()` waits for the "
                               "card"))
            elif (isinstance(node.func, ast.Name) and attr in SYNC_CASTS
                  and any(reads_traced(a) for a in node.args)):
                findings.append(self.finding(
                    mod, node, f"`{attr}()` of a traced value copies it to "
                               "the host and waits for the card"))
            elif attr in SYNC_SHAPE_ATTRS:
                findings.append(self.finding(
                    mod, node, f"`{attr}` produces a data-dependent shape "
                               "and syncs the host"))
            elif attr == "where" and len(node.args) == 1 and not node.keywords:
                findings.append(self.finding(
                    mod, node, "one-argument `where` returns data-dependent "
                               "indices and syncs the host; use the "
                               "three-argument select form"))
            elif (chain and chain[0] in np_names
                  and isinstance(node.func, ast.Attribute)
                  and not _np_use_allowed(node.func, guarded, consts)
                  and any(reads_traced(a) for a in
                          node.args + [k.value for k in node.keywords])):
                findings.append(self.finding(
                    mod, node, f"`{'.'.join(chain)}` on a traced value "
                               "runs on the host (use `torch`)"))
        return findings


def _is_graph_capture(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (or ``cuda.graph(...)``)."""
    if not isinstance(expr, ast.Call):
        return False
    chain = _attr_chain(expr.func)
    return bool(chain) and chain[-2:] == ["cuda", "graph"]


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to("cpu:0")``."""
    args = list(call.args[:1]) + [k.value for k in call.keywords
                                  if k.arg == "device"]
    return any(isinstance(a, ast.Constant) and isinstance(a.value, str)
               and a.value.split(":")[0] == "cpu" for a in args)


def _function_values(table: _FuncTable, mod: Module, qual: str,
                     expr: ast.AST) -> Set[FuncKey]:
    """The repo functions a function-valued expression can be: a named
    def, the closures a factory call returns, what a lambda calls, and
    either branch of a conditional expression; also through a local name
    bound to such a call or conditional."""
    if isinstance(expr, ast.IfExp):
        return (_function_values(table, mod, qual, expr.body)
                | _function_values(table, mod, qual, expr.orelse))
    if isinstance(expr, ast.Lambda):
        out: Set[FuncKey] = set()
        for sub in ast.walk(expr.body):
            if isinstance(sub, ast.Call):
                out |= _function_values(table, mod, qual, sub.func)
        return out
    if isinstance(expr, ast.Call):
        factory = table.resolve(mod, qual, expr.func)
        return _returned_closures(table, factory) if factory else set()
    key = table.resolve(mod, qual, expr)
    if key is not None:
        return {key}
    name = _name_of(expr)
    scope = table.defs.get((mod.path, qual))
    if name is None or scope is None:
        return set()
    out = set()
    for node in ast.walk(scope):
        if (isinstance(node, ast.Assign)
                and isinstance(node.value, (ast.Call, ast.IfExp))
                and any(_name_of(t) == name for t in node.targets)):
            out |= _function_values(table, mod, qual, node.value)
    return out


def _returned_closures(table: _FuncTable, factory: FuncKey) -> Set[FuncKey]:
    """The nested defs a factory returns by name."""
    fn = table.defs.get(factory)
    if fn is None:
        return set()
    path, qual = factory
    return {(path, f"{qual}.{node.value.id}") for node in _body_nodes(fn)
            if isinstance(node, ast.Return)
            and isinstance(node.value, ast.Name)
            and (path, f"{qual}.{node.value.id}") in table.defs}


def _np_use_allowed(node: ast.Attribute, guarded: Set[ast.AST],
                    consts: Set[str]) -> bool:
    if node.attr in NP_CONST_ATTRS:
        return True
    if node in guarded:
        return True
    par = node.parent
    # np.f(<literals / ALL_CAPS consts>): host-constant math
    if isinstance(par, ast.Call) and par.func is node:
        if node.attr in NP_INPLACE_ATTRS:
            return False
        args = list(par.args) + [k.value for k in par.keywords]
        if args and all(
                is_const(a)
                or (isinstance(a, ast.Name)
                    and (a.id.isupper() or a.id in consts))
                for a in args):
            return True
    return False


def _module_constants(tree: ast.Module) -> Set[str]:
    """Module-level ALL_CAPS constant names."""
    out: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id.isupper():
                    out.add(t.id)
        elif isinstance(stmt, ast.AnnAssign):
            if isinstance(stmt.target, ast.Name) and stmt.target.id.isupper():
                out.add(stmt.target.id)
    return out


def _np_guarded_nodes(fn: ast.AST, np_names: Set[str]) -> Set[ast.AST]:
    """Nodes inside an ``xp is np`` guard (either branch of an If/IfExp
    whose test is an xp-identity check) — numpy use there is the
    sanctioned eager fast path."""
    out: Set[ast.AST] = set()

    def is_xp_np_test(test: ast.AST) -> bool:
        for node in ast.walk(test):
            if (isinstance(node, ast.Compare)
                    and all(isinstance(op, (ast.Is, ast.IsNot))
                            for op in node.ops)):
                names = {n.id for n in ast.walk(node)
                         if isinstance(n, ast.Name)}
                if "xp" in names and names & np_names:
                    return True
        return False

    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.IfExp)) and is_xp_np_test(node.test):
            branches = (node.body + node.orelse
                        if isinstance(node, ast.If)
                        else [node.body, node.orelse])
            for b in branches:
                out.add(b)
                out.update(ast.walk(b))
    return out
