"""Kernel cost models for the PsPIN datapath simulator (paper §3, §7.4).

Cycle costs are calibrated to the paper's qualitative anchors:
  * Fig. 3: every workload at ≤64B packets exceeds PPB(32PU, P, 400G);
    compute-bound kernels scale linearly with payload and exceed PPB at all
    sizes; IO-bound kernels ≥256B fit PPB.
  * Fig. 7: 4 clusters (32 PUs) sustain Reduce up to 512B packets:
    PPB(32, 512B, 400G) ≈ 327 cycles -> reduce ≈ 0.6 cy/B + base.
Exact constants are estimates; every experiment compares policies under
*identical* cost models, so conclusions track the paper's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    name: str
    compute_base: float = 50.0       # handler entry/exit cycles
    compute_per_byte: float = 0.0    # PU cycles per payload byte
    io_kind: str = "none"            # none | dma_read | dma_write | egress
    io_bytes_factor: float = 1.0     # transfer bytes = factor * payload
    io_fixed_bytes: int = 0          # storage-RPC amplification: a small
    #                                  request triggers a fixed-size transfer
    blocking_io: bool = True         # PU held until the transfer completes
    spin_factor: float = 1.0         # synthetic congestor multiplier

    def compute_cycles(self, payload: int) -> float:
        return self.spin_factor * (self.compute_base
                                   + self.compute_per_byte * payload)

    def io_bytes(self, payload: int) -> int:
        if self.io_kind == "none":
            return 0
        if self.io_fixed_bytes:
            return self.io_fixed_bytes
        return int(self.io_bytes_factor * payload)


# -- paper workload set (§7.4) ------------------------------------------------
AGGREGATE = WorkloadModel("aggregate", 40, 0.50)
REDUCE = WorkloadModel("reduce", 50, 0.60, io_kind="egress",
                       io_bytes_factor=1.0)
HISTOGRAM = WorkloadModel("histogram", 60, 1.10)
IO_READ = WorkloadModel("io_read", 80, 0.05, io_kind="dma_read")
IO_WRITE = WorkloadModel("io_write", 80, 0.05, io_kind="dma_write")
FILTERING = WorkloadModel("filtering", 90, 0.30, io_kind="dma_write")
EGRESS_SEND = WorkloadModel("egress_send", 60, 0.05, io_kind="egress")

WORKLOADS: Dict[str, WorkloadModel] = {
    w.name: w for w in (AGGREGATE, REDUCE, HISTOGRAM, IO_READ, IO_WRITE,
                        FILTERING, EGRESS_SEND)
}


def spin_workload(name: str, cycles_per_byte: float,
                  base: float = 40.0) -> WorkloadModel:
    """Pure compute spin loop (paper §7.3 Congestor/Victim)."""
    return WorkloadModel(name, base, cycles_per_byte)


def ppb(num_pus: int, packet_bytes: int, link_gbps: float) -> float:
    """Per-packet budget in cycles at 1 GHz (paper §3): N * P / B."""
    return num_pus * packet_bytes * 8.0 / link_gbps
