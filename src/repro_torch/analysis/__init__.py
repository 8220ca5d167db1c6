"""The port's static analysis suite (the JAX package's ``analysis``).

AST-level checkers for the invariants the dynamic test suite can only
sample: purity of backend-generic kernels and no host sync in device
code (CUDA-graph bodies, the ``"torch"`` telemetry kernels, the serve
step), time-unit flow across the ns/us/cycles/steps domains, EventKind
emit/consume exhaustiveness, frozen-spec / fixed-shape discipline, trace
span balance and exported metric names.  Run via::

    python -m repro_torch.analysis.check [--json] [--baseline FILE] [--fix-baseline]

The framework (rule registry, repo index, baseline handling) lives in
``framework``; each pass is one module registering one or more rules.
Importing this package pulls in every built-in rule.  Standard library
only: it imports neither torch nor the code it analyses.
"""
from repro_torch.analysis.framework import (  # noqa: F401
    Baseline, Finding, Module, RepoIndex, Rule, RULE_REGISTRY,
    register_rule, run_rules,
)
from repro_torch.analysis import (purity, units, events, frozen,  # noqa: F401
                                  spans, metrics_names)

__all__ = [
    "Baseline", "Finding", "Module", "RepoIndex", "Rule", "RULE_REGISTRY",
    "register_rule", "run_rules",
]
