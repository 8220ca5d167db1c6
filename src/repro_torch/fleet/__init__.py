"""Fleet plane: multi-NIC co-simulation over a modeled VOQ/crossbar
switch fabric, with tenant placement, live migration, and a global QoS
tier above the per-NIC controllers (DESIGN.md §12).  Host numpy on
every machine: the fabric has no card path (the sweep datapath refuses
a fleet spec), so a fleet run is host code whatever ``--device`` says.
"""
from repro_torch.fleet.engine import (FLEET_EXTRAS_KEYS, FleetEngine,
                                      fleet_metric_rows, run_fleet)
from repro_torch.fleet.qos import GlobalQoS
from repro_torch.fleet.spec import FleetSpec, GlobalQoSSpec
from repro_torch.fleet.switch import CrossbarSwitch

__all__ = [
    "CrossbarSwitch", "FLEET_EXTRAS_KEYS", "FleetEngine", "FleetSpec",
    "GlobalQoS", "GlobalQoSSpec", "fleet_metric_rows", "run_fleet",
]
