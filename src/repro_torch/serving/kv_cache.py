"""Slot-based KV cache manager with static per-tenant quotas (R3).

The paper allocates each tenant a *static* sNIC memory segment at ECTX
creation; here the fixed pool is ``max_slots × max_len`` cache tokens and a
tenant's segment caps how many concurrent batch slots it may hold
(``quota_tokens // max_len``).  No paging — an over-quota admission errors
out (AdmissionError), and slot writes are bounds-checked against the
owning tenant (the PMP analogue).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core.admission import AdmissionError, SegmentAllocator


@dataclasses.dataclass
class SlotManager:
    max_slots: int
    max_len: int
    overcommit: float = 1.0   # >1: bounded quota oversubscription; physical
    #                           exhaustion then backpressures at take()

    def __post_init__(self):
        self.alloc = SegmentAllocator(
            pool_size=int(self.max_slots * self.max_len * self.overcommit))
        self.slot_tenant = np.full(self.max_slots, -1, np.int64)
        self.quota_slots: Dict[int, int] = {}

    # -- admission (control plane) -----------------------------------------
    def admit(self, tenant: int, kv_quota_tokens: int = 0) -> int:
        """Reserve a static segment; returns the tenant's slot cap."""
        quota = kv_quota_tokens or self.max_len  # default: 1 slot worth
        self.alloc.allocate(tenant, quota)
        cap = max(1, quota // self.max_len)
        self.quota_slots[tenant] = cap
        return cap

    def evict(self, tenant: int) -> None:
        self.alloc.free(tenant)
        self.quota_slots.pop(tenant, None)
        self.slot_tenant[self.slot_tenant == tenant] = -1

    # -- slot data plane -----------------------------------------------------
    def free_slots(self) -> np.ndarray:
        return np.flatnonzero(self.slot_tenant < 0)

    def held(self, tenant: int) -> int:
        return int((self.slot_tenant == tenant).sum())

    def can_take(self, tenant: int) -> bool:
        return self.held(tenant) < self.quota_slots.get(tenant, 0)

    def quota_caps(self, num_tenants: int) -> np.ndarray:
        """Vectorized per-tenant slot caps (0 for unadmitted tenants) —
        folded into batched scheduler eligibility (R3)."""
        caps = np.zeros(num_tenants, np.int64)
        for t, c in self.quota_slots.items():
            if 0 <= t < num_tenants:
                caps[t] = c
        return caps

    def take(self, tenant: int) -> int:
        if not self.can_take(tenant):
            raise AdmissionError(f"tenant {tenant} over KV quota")
        free = self.free_slots()
        if free.size == 0:
            raise AdmissionError("no free slots")
        s = int(free[0])
        self.slot_tenant[s] = tenant
        return s

    def release(self, slot: int) -> None:
        self.slot_tenant[slot] = -1

    def check_access(self, tenant: int, slot: int) -> bool:
        """PMP-style bounds check: a tenant may only touch its own slots."""
        return 0 <= slot < self.max_slots and self.slot_tenant[slot] == tenant
