"""Matching engine — paper §5.1 step 3: map inbound packets to FMQs by
UDP 3-tuple / TCP 5-tuple; in the serving adaptation, by tenant id."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MatchRule:
    """Wildcard fields are None."""
    src_ip: Optional[int] = None
    dst_ip: Optional[int] = None
    src_port: Optional[int] = None
    dst_port: Optional[int] = None
    proto: str = "udp"

    def matches(self, pkt: dict) -> bool:
        for f in ("src_ip", "dst_ip", "src_port", "dst_port"):
            want = getattr(self, f)
            if want is not None and pkt.get(f) != want:
                return False
        return pkt.get("proto", "udp") == self.proto


class MatchingEngine:
    """Exact-match table with rule priority = installation order."""

    def __init__(self) -> None:
        self._rules: Dict[int, Tuple[MatchRule, int]] = {}
        self._next = 0

    def install(self, rule: MatchRule, fmq_index: int) -> int:
        rid = self._next
        self._next += 1
        self._rules[rid] = (rule, fmq_index)
        return rid

    def remove(self, rule_id: int) -> None:
        self._rules.pop(rule_id, None)

    def match(self, pkt: dict) -> int:
        """Returns FMQ index or -1 (-> conventional NIC path, paper Fig. 2)."""
        for rid in sorted(self._rules):
            rule, fmq = self._rules[rid]
            if rule.matches(pkt):
                return fmq
        return -1
