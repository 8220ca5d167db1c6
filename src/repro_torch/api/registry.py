"""Named scenario registry.

Scenarios register a *factory* — a function of keyword parameters that
returns a ``ScenarioSpec`` — so one name covers a family of variants
(``get_scenario("fig9_congestor_victim", scheduler="rr")``) while the
no-argument call yields the canonical declarative spec.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.api.spec import ScenarioSpec

_REGISTRY: Dict[str, Callable[..., ScenarioSpec]] = {}


def register_scenario(name: str):
    """Decorator: register ``factory(**params) -> ScenarioSpec``."""
    def deco(factory: Callable[..., ScenarioSpec]):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = factory
        return factory
    return deco


def scenario_params(name: str) -> set:
    """Names of the keyword parameters a scenario's factory accepts —
    CLIs use this to forward only applicable knobs."""
    import inspect
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}")
    return set(inspect.signature(_REGISTRY[name]).parameters)


def get_scenario(name: str, **params) -> ScenarioSpec:
    _ensure_loaded()
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None
    spec = factory(**params)
    if spec.name != name:
        spec = spec.replace(name=name)
    return spec


def list_scenarios() -> List[dict]:
    """[{name, description, backends, tenants, analytic}] for every
    registered scenario (built with default parameters)."""
    _ensure_loaded()
    out = []
    for name in sorted(_REGISTRY):
        spec = get_scenario(name)
        out.append({"name": name, "description": spec.description,
                    "backends": list(spec.backends),
                    "tenants": len(spec.tenants),
                    "analytic": spec.analytic})
    return out


def _ensure_loaded() -> None:
    """Import the built-in scenario catalog exactly once."""
    import repro_torch.api.scenarios  # noqa: F401  (registers on import)
