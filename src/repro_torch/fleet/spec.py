"""Fleet-plane scenario specs (DESIGN.md §12).

``FleetSpec`` extends ``ScenarioSpec`` with the fabric half of a
multi-NIC deployment: how many per-NIC engines to instantiate, where
each tenant's flow terminates (the placement map), the modeled switch
(VOQ depth, crossbar arbiter, per-link serialization + propagation
delay), the co-simulation epoch, and the global QoS tier that sits
above the per-NIC AIMD controllers.

Like its base class it is a frozen dataclass of plain scalars/tuples:
hashable, JSON round-trippable, and ``replace``-derivable (so the
launch CLI's ``--fast`` duration cap works unchanged).  ``plain()``
projects the fleet spec down to the single-NIC ``ScenarioSpec`` twin
that each per-NIC engine runs — the N=1 zero-delay fleet is
bit-identical to running that twin through ``run_scenario`` directly
(pinned in tests/test_torch_fleet.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.api.spec import ScenarioSpec


@dataclasses.dataclass(frozen=True)
class GlobalQoSSpec:
    """The fleet-level control loop (DESIGN.md §12.4).

    Runs every ``interval_epochs`` co-sim epochs on the per-NIC
    ``SignalFrame``s read off the MetricsBus.  Two actuators, both
    *above* the per-NIC AIMD controllers:

      * weight rebalancing — scale the per-NIC scheduler *base*
        weights of SLO-violating tenants by ``rebalance_gain`` (the
        per-NIC controller keeps applying its own AIMD boost on top);
      * live migration — move the worst violating tenant off the
        most-loaded NIC onto the least-loaded one (drain + replay
        through the fabric), at most ``max_migrations`` per run and
        once per ``cooldown_epochs`` per tenant.

    Decisions read only drift-free signals (p99, queue_mean), so the
    event and batched datapaths take identical actions.
    """
    interval_epochs: int = 2
    rebalance: bool = False          # requires a per-NIC ControllerSpec
    rebalance_gain: float = 1.5
    boost_cap: float = 8.0
    migrate: bool = True
    max_migrations: int = 4          # total over the run
    cooldown_epochs: int = 4         # per-tenant re-migration spacing
    load_margin: float = 1.2         # migrate only if src load > margin*dst


@dataclasses.dataclass(frozen=True)
class FleetSpec(ScenarioSpec):
    """A multi-NIC scenario: N per-NIC engines over a modeled switch.

    ``placement`` maps tenant id -> home NIC (empty = ``i % num_nics``);
    a tenant's ingress port on the fabric is always ``i % num_nics``,
    so placement alone decides which flows cross the crossbar.
    ``link_gbps == 0`` together with ``prop_delay_ns == 0`` selects the
    ideal (passthrough) fabric: injections deliver verbatim, which is
    the N=1 bit-identity configuration.
    """
    num_nics: int = 2
    placement: Tuple[int, ...] = ()      # tenant -> home NIC
    link_gbps: float = 400.0             # 0 = ideal link (no serialization)
    prop_delay_ns: float = 50.0
    voq_depth: int = 1024                # per-(input,output) VOQ bound
    switch_arbiter: str = "rr"           # "rr" | "mdrr"
    quantum_bytes: int = 4096            # mdrr per-round credit
    epoch_ns: float = 8000.0             # co-sim step (multiple of the
    #                                      engines' 2000ns IO window)
    migration_delay_ns: float = 2000.0   # fixed drain -> replay handoff
    migration_gbps: float = 0.0          # state-transfer link: > 0 adds
    #                                      drained_bytes * 8 / gbps ns to
    #                                      the handoff (0 = fixed only)
    global_qos: Optional[GlobalQoSSpec] = None
    trace_fleet: bool = False            # switch-traversal + migration
    #                                      spans into a fleet TraceRecorder

    def nic_of(self, tenant: int) -> int:
        """Initial home NIC of a tenant (before any migration)."""
        if self.placement:
            return self.placement[tenant]
        return tenant % self.num_nics

    def initial_placement(self) -> Tuple[int, ...]:
        return tuple(self.nic_of(i) for i in range(len(self.tenants)))

    def plain(self) -> ScenarioSpec:
        """The single-NIC ``ScenarioSpec`` twin each per-NIC engine
        runs: every base field verbatim, no fleet fields."""
        base = {f.name: getattr(self, f.name)
                for f in dataclasses.fields(ScenarioSpec)}
        return ScenarioSpec(**base)

    @classmethod
    def from_dict(cls, d: Dict) -> "FleetSpec":
        d = dict(d)
        d["placement"] = tuple(d.get("placement", ()))
        if d.get("global_qos") is not None:
            d["global_qos"] = GlobalQoSSpec(**d["global_qos"])
        return super().from_dict(d)
