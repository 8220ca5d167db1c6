"""Fleet-plane scenario catalog: multi-NIC runs over the modeled
VOQ/crossbar fabric (DESIGN.md §12).

These are the *fabric* family — N engines exchanging traffic through
``CrossbarSwitch`` — as opposed to ``fleet_sweep`` in the base catalog,
which packs many tenants onto ONE simulated NIC.  Imported from
``repro_torch.api.scenarios`` so the registry sees both families.

    PYTHONPATH=src python -m repro_torch.launch.scenario fleet_fabric
"""
from __future__ import annotations

from repro_torch.api.registry import register_scenario
from repro_torch.api.spec import (ArrivalSpec, ControllerSpec,
                                  TenantSpec, WorkloadSpec)
from repro_torch.fleet.spec import FleetSpec, GlobalQoSSpec


def _spin(name: str, cpb: float, base: float = 40.0) -> WorkloadSpec:
    return WorkloadSpec(name=name, compute_base=base, compute_per_byte=cpb)


@register_scenario("fleet_fabric")
def fleet_fabric(*, num_nics: int = 4, duration_us: float = 120.0,
                 pkt_size: int = 1024, link_gbps: float = 400.0,
                 switch_arbiter: str = "mdrr", datapath: str = "event",
                 seed: int = 0) -> FleetSpec:
    """All-to-all fleet baseline: ``num_nics`` NICs, two tenants homed
    per NIC — one serving local traffic (ingress port == home NIC), one
    whose flow crosses the crossbar to the next NIC over.  Every link
    carries cross-traffic, no output saturates: the steady-state
    sanity scenario for VOQ occupancy, MDRR grants and per-link
    serialization accounting."""
    n = num_nics
    tenants = []
    placement = []
    for k in range(n):
        tenants.append(TenantSpec(
            f"local{k}", workload=_spin(f"local{k}", 1.0),
            arrival=ArrivalSpec(size=pkt_size, share=0.12, seed_offset=k)))
        placement.append(k)                   # ingress k -> home k
    for k in range(n):
        tenants.append(TenantSpec(
            f"cross{k}", workload=_spin(f"cross{k}", 1.0),
            arrival=ArrivalSpec(size=pkt_size // 2, share=0.10,
                                seed_offset=n + k)))
        placement.append((k + 1) % n)         # ingress k -> home k+1
    return FleetSpec(
        name="fleet_fabric",
        description=f"{n}-NIC fabric baseline: local + cross flows on "
                    "every link (DESIGN.md §12)",
        tenants=tuple(tenants), placement=tuple(placement),
        num_nics=n, link_gbps=link_gbps, switch_arbiter=switch_arbiter,
        datapath=datapath, duration_us=duration_us, seed=seed)


@register_scenario("fleet_incast")
def fleet_incast(*, num_nics: int = 16, duration_us: float = 80.0,
                 pkt_size: int = 1024, sender_share: float = 0.09,
                 quiet_share: float = 0.03, voq_depth: int = 512,
                 datapath: str = "event", seed: int = 0) -> FleetSpec:
    """The VOQ/HoL-blocking pin: ``num_nics - 1``
    senders, one per ingress port, all homed on NIC 0 — the classic
    incast that oversubscribes output link 0 (~1.35x at defaults).
    Tenant ``num_nics - 1`` stays on its own NIC, so its (N-1, N-1)
    fabric pair shares *nothing* with the hot output.  With per-output
    VOQs its latency stays at serialization + propagation while link 0
    saturates; a single shared input FIFO would have stalled it behind
    the incast (tests/test_torch_fleet.py pins the separation)."""
    n = num_nics
    tenants = []
    for k in range(n - 1):
        tenants.append(TenantSpec(
            f"incast{k}", workload=_spin(f"incast{k}", 0.5),
            arrival=ArrivalSpec(size=pkt_size, share=sender_share,
                                seed_offset=k)))
    tenants.append(TenantSpec(
        "quiet", workload=_spin("quiet", 0.5),
        arrival=ArrivalSpec(size=pkt_size // 2, share=quiet_share,
                            seed_offset=n - 1)))
    placement = tuple([0] * (n - 1) + [n - 1])
    return FleetSpec(
        name="fleet_incast",
        description=f"{n}-NIC incast onto output 0; VOQ keeps the "
                    "quiet pair's latency flat (DESIGN.md §12.2)",
        tenants=tuple(tenants), placement=placement,
        num_nics=n, voq_depth=voq_depth, switch_arbiter="rr",
        datapath=datapath, duration_us=duration_us, seed=seed)


@register_scenario("fleet_migrate")
def fleet_migrate(*, duration_us: float = 240.0, epoch_ns: float = 8000.0,
                  p99_target_ns: float = 1000.0, migrate: bool = True,
                  rebalance: bool = True, datapath: str = "event",
                  seed: int = 0) -> FleetSpec:
    """The live-migration pin: NIC 0 hosts two heavy
    congestors plus a latency-SLO victim; NIC 1 hosts one light tenant.
    Each NIC runs its own AIMD controller, and the global QoS tier
    watches the per-NIC frames: the victim's p99 blows through target
    on NIC 0, so the tier drains its FMQ, replays the queue across the
    fabric, and re-homes it on NIC 1 (MIGRATE_START/MIGRATE_DONE in
    the EQ stream).  ``migrate=False`` is the control arm the test
    compares against: victim p99 improves, fleet Jain holds."""
    return FleetSpec(
        name="fleet_migrate",
        description="global QoS migrates an SLO victim off a congested "
                    "NIC; p99 recovers, Jain holds (DESIGN.md §12.4)",
        tenants=(
            TenantSpec("congestor0", workload=_spin("congestor0", 2.0),
                       arrival=ArrivalSpec(size=1024, share=0.25)),
            TenantSpec("congestor1", workload=_spin("congestor1", 2.0),
                       arrival=ArrivalSpec(size=1024, share=0.20,
                                           seed_offset=1)),
            TenantSpec("victim", workload=_spin("victim", 2.0),
                       arrival=ArrivalSpec(size=256, share=0.06,
                                           seed_offset=2),
                       p99_target=p99_target_ns),
            TenantSpec("light", workload=_spin("light", 1.0),
                       arrival=ArrivalSpec(size=512, share=0.05,
                                           seed_offset=3)),
        ),
        placement=(0, 0, 0, 1), num_nics=2,
        controller=ControllerSpec(interval_ns=8000.0),
        global_qos=GlobalQoSSpec(interval_epochs=2, migrate=migrate,
                                 rebalance=rebalance, rebalance_gain=1.3,
                                 boost_cap=4.0, max_migrations=2,
                                 cooldown_epochs=4, load_margin=1.1),
        epoch_ns=epoch_ns, datapath=datapath,
        duration_us=duration_us, seed=seed)
