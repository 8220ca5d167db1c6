"""SLO policies and tenant execution contexts (ECTX) — paper §5.2.

The SLO knobs mirror Table 3: per-resource priorities, a kernel cycle
budget (watchdog), and a static memory allocation size.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    priority: float = 1.0            # PU (compute) priority weight
    dma_priority: float = 1.0        # DMA WRR weight
    egress_priority: float = 1.0     # egress WRR weight
    kernel_cycle_limit: int = 0      # 0 = unlimited (watchdog, paper §5.3)
    total_cycle_limit: int = 0       # per-tenant lifetime budget (billing)
    memory_bytes: int = 1 << 20      # static sNIC memory segment
    # TPU serving adaptation:
    kv_quota_tokens: int = 0         # static KV segment (0 = engine default)
    max_chunk_tokens: int = 0        # fragmentation grain override

    def __post_init__(self):
        for knob in ("priority", "dma_priority", "egress_priority"):
            if getattr(self, knob) <= 0:
                raise ValueError(f"{knob} must be positive, got "
                                 f"{getattr(self, knob)}")
        for limit in ("kernel_cycle_limit", "total_cycle_limit",
                      "memory_bytes", "kv_quota_tokens",
                      "max_chunk_tokens"):
            if getattr(self, limit) < 0:
                raise ValueError(f"{limit} must be >= 0 (0 = unlimited/"
                                 f"default), got {getattr(self, limit)}")


@dataclasses.dataclass
class ECTX:
    """Flow execution context (paper §5.1 step 1-2).

    Encapsulates everything the control plane installs on the device:
    matching rule, kernel (cost model or serving request handler), SLO
    policy, and the statically allocated memory segment.
    """
    tenant_id: int
    name: str
    slo: SLOPolicy
    kernel: Optional[object] = None      # sim: WorkloadModel; serving: arch id
    match_rule: Optional[object] = None  # matching.MatchRule
    memory_segment: Optional[tuple] = None  # (offset, size) once admitted
    fmq_index: int = -1                  # assigned at admission

    @property
    def admitted(self) -> bool:
        return self.fmq_index >= 0
