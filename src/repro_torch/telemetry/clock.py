"""The host clock of the serving path's wall-clock spans (DESIGN.md §10.6).

``now_ns()`` is nanoseconds on the timeline ``torch.profiler`` stamps its
events with: Unix time, onto which Kineto also converts the card's
activity.  So a span the program records can be laid directly over the
device operations of a profiler trace taken around it.  The clock is
``time.perf_counter_ns()`` (monotonic: a span's end never precedes its
start) shifted onto Unix time by one offset read when the module loads.
"""
from __future__ import annotations

import time

_UNIX_OFFSET_NS = time.time_ns() - time.perf_counter_ns()


def now_ns() -> int:
    """Host time, ns, on the profiler's (Unix) timeline."""
    return time.perf_counter_ns() + _UNIX_OFFSET_NS
