"""OSMOSIS core: schedulers, FMQs, SLO, fragmentation, matching,
accounting, events and the shared engine layer."""
from repro_torch.core.accounting import (FCTTracker, TimeAveragedJain,
                                         jain_fairness, weighted_jain)
from repro_torch.core.admission import AdmissionError, SegmentAllocator
from repro_torch.core.engine_base import BudgetLedger, EngineBase, EQHub
from repro_torch.core.events import Event, EventKind, EventQueue
from repro_torch.core.fmq import FMQ, PacketDescriptor, PushResult
from repro_torch.core.fragmentation import (Fragment, FragmentationPolicy,
                                            fragment_tokens,
                                            fragment_transfer)
from repro_torch.core.matching import MatchingEngine, MatchRule
from repro_torch.core.slo import ECTX, SLOPolicy
from repro_torch.core import sched_generic, wlbvt

__all__ = [
    "FCTTracker", "TimeAveragedJain", "jain_fairness", "weighted_jain",
    "AdmissionError", "SegmentAllocator", "BudgetLedger", "EngineBase",
    "EQHub", "Event", "EventKind", "EventQueue",
    "FMQ", "PacketDescriptor", "PushResult", "Fragment",
    "FragmentationPolicy",
    "fragment_tokens", "fragment_transfer", "MatchingEngine", "MatchRule",
    "ECTX", "SLOPolicy", "sched_generic", "wlbvt",
]
