"""Rule engine for the port's static checkers (``python -m
repro_torch.analysis.check``).

Small, dependency-free core: a ``RepoIndex`` of parsed modules, a
``Rule`` base class + registry, ``Finding`` records with stable baseline
keys, and ``Baseline`` load/save/diff.  Rules are pure functions of the
index — they never import the code under analysis, so the suite runs in
any environment (the card's machine included) without torch, jax or the
repo's runtime deps.

Baseline keys deliberately exclude line numbers (``rule::path::symbol::
message``) so unrelated edits that shift code do not invalidate pinned
findings; moving or renaming the offending symbol does, which is the
point — a grandfathered finding must be re-justified when its code is
touched.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Type

SEVERITIES = ("error", "warning")

# directories never scanned (fixtures contain deliberate violations)
DEFAULT_EXCLUDES = (
    "tests/data/*", "*/.git/*", "*/__pycache__/*", "build/*", "dist/*",
)
# the port and its card driver: the gate's roots and the rules' scope
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")
PORT_SCOPE = ("src/repro_torch/*", "chip_smoke.py")
# the suffix of a device kernel's name, the torch counterpart of an
# ``xp`` one (``hist_add`` -> ``hist_add_torch``)
TORCH_KERNEL_SUFFIX = "_torch"


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str            # repo-relative, posix separators
    line: int
    col: int
    rule: str
    severity: str        # "error" | "warning"
    message: str
    symbol: str = ""     # enclosing function/class qualname ("" = module)

    @property
    def key(self) -> str:
        """Stable baseline key — no line/col, so edits elsewhere in the
        file do not churn the baseline."""
        return f"{self.rule}::{self.path}::{self.symbol}::{self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["key"] = self.key
        return d

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} {self.severity}: {self.message}{sym}")


# ---------------------------------------------------------------------------
# parsed-module index
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Module:
    path: str            # repo-relative posix path
    tree: ast.Module
    source: str

    @property
    def dotted(self) -> str:
        """Best-effort dotted module name (``src/repro_torch/a/b.py`` ->
        ``repro_torch.a.b``) used for import resolution."""
        p = self.path
        if p.endswith(".py"):
            p = p[:-3]
        parts = [q for q in p.split("/") if q]
        if parts and parts[0] == "src":
            parts = parts[1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


def attach_parents(tree: ast.AST) -> None:
    """Annotate every node with ``.parent`` (None at the root)."""
    tree.parent = None  # type: ignore[attr-defined]
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def attach_qualnames(tree: ast.AST) -> None:
    """Annotate every node with ``.qual``: the enclosing def/class
    qualname (the node's own name for def/class nodes themselves)."""

    def visit(node: ast.AST, stack: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            stack = stack + (node.name,)
        node.qual = ".".join(stack)  # type: ignore[attr-defined]
        for child in ast.iter_child_nodes(node):
            visit(child, stack)

    visit(tree, ())


class RepoIndex:
    """All parsed Python modules under a repo root."""

    def __init__(self, root: str, modules: Sequence[Module]):
        self.root = root
        self.modules: List[Module] = list(modules)
        self._by_path = {m.path: m for m in self.modules}
        self._by_dotted = {m.dotted: m for m in self.modules}

    @classmethod
    def load(cls, root: str, paths: Optional[Sequence[str]] = None,
             excludes: Sequence[str] = DEFAULT_EXCLUDES) -> "RepoIndex":
        root = os.path.abspath(root)
        modules: List[Module] = []
        roots = [os.path.join(root, p) for p in (paths or DEFAULT_PATHS)]
        roots = [r for r in roots if os.path.exists(r)]
        for r in roots:
            if os.path.isfile(r):
                files: Iterable[str] = [r]
            else:
                files = sorted(
                    os.path.join(dp, f)
                    for dp, _, fs in os.walk(r)
                    for f in fs if f.endswith(".py"))
            for f in files:
                rel = os.path.relpath(f, root).replace(os.sep, "/")
                if any(fnmatch.fnmatch(rel, pat) for pat in excludes):
                    continue
                mod = cls.parse_file(f, rel)
                if mod is not None:
                    modules.append(mod)
        return cls(root, modules)

    @staticmethod
    def parse_file(abspath: str, rel: str) -> Optional[Module]:
        try:
            with open(abspath, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=rel)
        except (OSError, SyntaxError):
            return None
        attach_parents(tree)
        attach_qualnames(tree)
        return Module(path=rel, tree=tree, source=source)

    def get(self, path: str) -> Optional[Module]:
        return self._by_path.get(path)

    def by_dotted(self, dotted: str) -> Optional[Module]:
        return self._by_dotted.get(dotted)

    def matching(self, patterns: Sequence[str]) -> List[Module]:
        return [m for m in self.modules
                if any(fnmatch.fnmatch(m.path, p) for p in patterns)]


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------
class Rule:
    """One analysis pass.  Subclasses set ``name``/``description`` and
    implement ``run(index) -> [Finding]``."""

    name: str = "abstract"
    description: str = ""

    def run(self, index: RepoIndex) -> List[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str,
                severity: str = "error") -> Finding:
        assert severity in SEVERITIES
        return Finding(path=module.path,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       rule=self.name, severity=severity, message=message,
                       symbol=getattr(node, "qual", ""))


RULE_REGISTRY: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    RULE_REGISTRY[cls.name] = cls
    return cls


def run_rules(index: RepoIndex,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Run rule instances (default: one of each registered rule) over the
    index; findings come back sorted by location."""
    if rules is None:
        rules = [cls() for _, cls in sorted(RULE_REGISTRY.items())]
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.run(index))
    return sorted(findings)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------
class Baseline:
    """Grandfathered findings: ``key -> justification``.

    Every entry must carry a human-written justification; ``--fix-baseline``
    inserts ``TODO: justify`` placeholders which the repo-wide test treats
    as findings of their own.
    """

    VERSION = 1

    def __init__(self, entries: Optional[Dict[str, str]] = None):
        self.entries: Dict[str, str] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        entries = {e["key"]: e.get("justification", "")
                   for e in data.get("entries", [])}
        return cls(entries)

    def save(self, path: str) -> None:
        data = {
            "version": self.VERSION,
            "entries": [{"key": k, "justification": v}
                        for k, v in sorted(self.entries.items())],
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=2, sort_keys=False)
            fh.write("\n")

    def diff(self, findings: Sequence[Finding]
             ) -> Tuple[List[Finding], List[str]]:
        """Split findings into (new, stale-baseline-keys)."""
        seen = {f.key for f in findings}
        new = [f for f in findings if f.key not in self.entries]
        stale = sorted(k for k in self.entries if k not in seen)
        return new, stale

    def absorb(self, findings: Sequence[Finding]) -> None:
        """--fix-baseline: pin current findings, drop stale entries."""
        seen = {f.key for f in findings}
        self.entries = {k: v for k, v in self.entries.items() if k in seen}
        for f in findings:
            self.entries.setdefault(f.key, "TODO: justify")


# ---------------------------------------------------------------------------
# shared AST helpers used by several rules
# ---------------------------------------------------------------------------
def numpy_aliases(tree: ast.Module) -> set:
    """Names the module binds to the ``numpy`` top-level module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy":
                    out.add(a.asname or "numpy")
    return out


def jnp_aliases(tree: ast.Module) -> set:
    """Names the module binds to ``jax.numpy``."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "jax.numpy" and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "jax" and node.level == 0:
                for a in node.names:
                    if a.name == "numpy":
                        out.add(a.asname or "numpy")
    return out


def import_map(tree: ast.Module) -> Dict[str, str]:
    """Local name -> dotted target for module/function imports.

    ``from repro_torch.core import sched_generic as G`` maps ``G`` to
    ``repro_torch.core.sched_generic``; ``from repro_torch.x import f``
    maps ``f`` to ``repro_torch.x.f``; ``import repro_torch.x as rx`` maps
    ``rx`` to ``repro_torch.x``.
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def const_value(node: ast.AST):
    """The literal value of a Constant (or unary-minus Constant), else
    a sentinel."""
    if isinstance(node, ast.Constant):
        return node.value
    if (isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub)
            and isinstance(node.operand, ast.Constant)):
        v = node.operand.value
        if isinstance(v, (int, float)):
            return -v
    return _NO_CONST


_NO_CONST = object()


def is_const(node: ast.AST) -> bool:
    return const_value(node) is not _NO_CONST


def lookup_order(index: RepoIndex, scope: Sequence[str]) -> List[Module]:
    """The index's modules with those matching ``scope`` first: a rule
    that reads a definition (``EventKind``, ``TIME_UNITS``, ...) takes the
    one inside its own scope, and the whole index's only when the scope
    has none (fixture runs), so a tree that also holds the JAX package
    does not change what the port's rules report."""
    inside = index.matching(scope)
    return inside + [m for m in index.modules if m not in inside]
