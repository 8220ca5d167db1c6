"""Static memory admission control — paper §5.2 "sNIC memory segments" +
R3: lightweight allocation, no paging; over-quota ECTX creation errors out.

Used for sNIC L2 segments in the simulator and KV-cache quotas in the
serving engine (both are fixed pools carved into per-tenant segments)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


class AdmissionError(Exception):
    pass


@dataclasses.dataclass
class SegmentAllocator:
    """First-fit static segment allocator over a fixed pool."""
    pool_size: int
    _segments: Dict[int, Tuple[int, int]] = dataclasses.field(
        default_factory=dict)  # tenant -> (offset, size)

    def allocate(self, tenant: int, size: int) -> Tuple[int, int]:
        if size <= 0:
            raise AdmissionError(f"invalid segment size {size}")
        if tenant in self._segments:
            raise AdmissionError(f"tenant {tenant} already has a segment")
        taken = sorted(self._segments.values())
        off = 0
        for s_off, s_size in taken:
            if off + size <= s_off:
                break
            off = max(off, s_off + s_size)
        if off + size > self.pool_size:
            raise AdmissionError(
                f"pool exhausted: need {size} at {off}, pool {self.pool_size}")
        self._segments[tenant] = (off, size)
        return off, size

    def free(self, tenant: int) -> None:
        self._segments.pop(tenant, None)

    def segment(self, tenant: int) -> Optional[Tuple[int, int]]:
        return self._segments.get(tenant)

    def check_access(self, tenant: int, offset: int, nbytes: int) -> bool:
        """PMP-style bounds check (paper §6.1 memory isolation)."""
        seg = self._segments.get(tenant)
        if seg is None:
            return False
        s_off, s_size = seg
        return s_off <= offset and offset + nbytes <= s_off + s_size

    @property
    def used(self) -> int:
        return sum(s for _, s in self._segments.values())
