"""Sweep plans: a base ``ScenarioSpec`` × knob axes × seeds (DESIGN.md
§13.2).

A ``SweepSpec`` is the declarative unit the device datapath consumes: the
cartesian expansion ``replicas()`` yields one concrete ``ScenarioSpec``
per (axis-value combination, seed) — thousands of replica lanes that
``repro_torch.sim.devicepath.run_sweep_specs`` runs as one batch of
replica rows on the card.

Knob paths are dotted field references into the frozen spec tree:

* top-level fields            — ``"fifo_capacity"``, ``"scheduler"``
* one tenant's subtree        — ``"tenants.0.priority"``,
  ``"tenants.1.workload.compute_per_byte"``
* every tenant at once        — ``"tenants.*.kernel_cycle_limit"``

Values are applied with ``dataclasses.replace`` down the path, so a typo
raises immediately (frozen dataclasses reject unknown fields) instead of
silently sweeping nothing.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Tuple

from repro_torch.api.spec import ScenarioSpec


def apply_knob(spec, path: str, value):
    """Return a copy of ``spec`` with the dotted ``path`` set to
    ``value`` (``tenants.*`` fans out over every tenant)."""
    return _set_path(spec, path.split("."), value)


def _set_path(obj, parts: List[str], value):
    field = parts[0]
    if field == "tenants":
        sel, rest = parts[1], parts[2:]
        tenants = list(obj.tenants)
        idxs = range(len(tenants)) if sel == "*" else [int(sel)]
        for i in idxs:
            tenants[i] = _set_path(tenants[i], rest, value)
        return dataclasses.replace(obj, tenants=tuple(tenants))
    if len(parts) == 1:
        if not any(f.name == field
                   for f in dataclasses.fields(obj)):  # pragma: no cover
            raise KeyError(f"{type(obj).__name__} has no knob {field!r}")
        return dataclasses.replace(obj, **{field: value})
    return dataclasses.replace(
        obj, **{field: _set_path(getattr(obj, field), parts[1:], value)})


@dataclasses.dataclass(frozen=True)
class SweepAxis:
    """One swept knob: a dotted path and the values it takes."""
    knob: str
    values: Tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Base scenario × knob axes × seeds; ``replicas()`` is the full
    cartesian expansion (axes are the outer loops, seeds the inner)."""
    name: str
    base: ScenarioSpec
    axes: Tuple[SweepAxis, ...] = ()
    seeds: Tuple[int, ...] = (0,)

    def __post_init__(self):
        object.__setattr__(self, "axes", tuple(self.axes))
        object.__setattr__(self, "seeds", tuple(self.seeds))

    def __len__(self) -> int:
        n = len(self.seeds)
        for ax in self.axes:
            n *= len(ax.values)
        return n

    def replicas(self) -> Iterator[Tuple[Dict, ScenarioSpec]]:
        """Yield ``(knobs, spec)`` per replica; ``knobs`` holds each
        swept value plus the seed (the sweep report row key)."""
        grids = [ax.values for ax in self.axes]
        for combo in itertools.product(*grids):
            spec = self.base
            knobs: Dict = {}
            for ax, v in zip(self.axes, combo):
                spec = apply_knob(spec, ax.knob, v)
                knobs[ax.knob] = v
            for seed in self.seeds:
                yield ({**knobs, "seed": seed},
                       dataclasses.replace(spec, seed=seed))

    def specs(self) -> List[ScenarioSpec]:
        return [spec for _, spec in self.replicas()]

    # -- serde --------------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "base": self.base.to_dict(),
            "axes": [{"knob": ax.knob, "values": list(ax.values)}
                     for ax in self.axes],
            "seeds": list(self.seeds),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "SweepSpec":
        return cls(
            name=d["name"],
            base=ScenarioSpec.from_dict(d["base"]),
            axes=tuple(SweepAxis(knob=a["knob"], values=tuple(a["values"]))
                       for a in d.get("axes", ())),
            seeds=tuple(d.get("seeds", (0,))),
        )
