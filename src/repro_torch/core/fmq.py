"""Flow Management Queues — paper §5.3 hardware flow abstraction.

An FMQ is a FIFO of packet descriptors plus scheduling state (the BVT
counters live in the shared WLBVT arrays, indexed by ``index``) plus the
pointers into the ECTX.  The 64-bit BVT counter / 16-bit priority register
widths from §6.2 are modeled by the array dtypes in wlbvt.py.

Overflow follows the paper's ECN mark-before-drop discipline: once the
FIFO depth crosses ``ecn_threshold`` the packet is still accepted but
ECN-marked (``PushResult.MARKED``, counted in ``ecn_marks``) so the
telemetry/control plane sees congestion *before* losses start; only a
full FIFO drops (``PushResult.DROPPED``).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Optional

from repro_torch.core.slo import ECTX


class PushResult(enum.IntEnum):
    """Truthiness = "was the packet accepted" (MARKED packets are)."""
    DROPPED = 0
    OK = 1
    MARKED = 2


@dataclasses.dataclass
class PacketDescriptor:
    tenant: int
    size_bytes: int           # payload + header
    arrival: float            # cycles
    transfer_id: int = -1
    ecn: bool = False         # set when the FMQ marked this packet
    meta: Optional[dict] = None


@dataclasses.dataclass
class FMQ:
    index: int
    ectx: ECTX
    capacity: int = 1024      # descriptor FIFO depth
    ecn_threshold: int = 0    # mark depth; 0 = 3/4 of capacity
    fifo: Deque[PacketDescriptor] = dataclasses.field(default_factory=deque)
    drops: int = 0
    ecn_marks: int = 0
    enqueued: int = 0
    completed: int = 0

    def __post_init__(self):
        if self.ecn_threshold <= 0:
            self.ecn_threshold = max(1, (3 * self.capacity) // 4)

    def push(self, pkt: PacketDescriptor) -> PushResult:
        """DROPPED => FIFO overflow; MARKED => accepted but ECN-marked
        (depth at/above the mark-before-drop threshold)."""
        if len(self.fifo) >= self.capacity:
            self.drops += 1
            return PushResult.DROPPED
        self.fifo.append(pkt)
        self.enqueued += 1
        if len(self.fifo) >= self.ecn_threshold:
            self.ecn_marks += 1
            pkt.ecn = True
            return PushResult.MARKED
        return PushResult.OK

    def pop(self) -> Optional[PacketDescriptor]:
        return self.fifo.popleft() if self.fifo else None

    def __len__(self) -> int:
        return len(self.fifo)
