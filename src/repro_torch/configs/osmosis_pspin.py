"""PsPIN / OSMOSIS hardware model constants (paper §6-§7 setup): the
cycle-level simulator's NIC, which every sim scenario and the device
sweep datapath share."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PsPINConfig:
    """Cycle-level simulator hardware model (paper experimental setup)."""
    num_clusters: int = 4
    pus_per_cluster: int = 8
    clock_ghz: float = 1.0                  # 1 cycle == 1 ns
    ingress_gbps: float = 400.0             # full-duplex link
    egress_gbps: float = 400.0
    axi_gbps: float = 512.0                 # shared L2/host interconnect
    l2_packet_buf_bytes: int = 4 << 20
    l2_kernel_buf_bytes: int = 4 << 20
    l1_bytes: int = 1 << 20
    max_fmqs: int = 128
    sched_decision_cycles: int = 5          # WLBVT pipeline depth (paper §6.2)
    dma_setup_cycles: int = 13              # 64B packet L2->L1 DMA (paper §6.2)
    header_bytes: int = 28                  # IPv4/UDP header

    @property
    def num_pus(self) -> int:
        return self.num_clusters * self.pus_per_cluster

    @property
    def ns_per_cycle(self) -> float:
        return 1.0 / self.clock_ghz

    def cycles_ns(self, cycles: float) -> float:
        """PU cycles -> virtual nanoseconds.  The event loops advance a
        ns clock; every hardware cost expressed in cycles
        (``dma_setup_cycles``, kernel compute, fragmentation overhead)
        must pass through here before touching it.  At the default
        1 GHz this is an exact ``* 1.0`` — time traces are bit-identical
        to the historical cycles==ns behaviour."""
        return cycles * self.ns_per_cycle

    def wire_ns_per_byte(self, gbps: float) -> float:
        return 8.0 / gbps                   # ns per byte at `gbps`


PSPIN = PsPINConfig()
