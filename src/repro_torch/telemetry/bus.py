"""Streaming metrics bus (DESIGN.md §11): live per-interval observability.

The telemetry plane (§6) and the trace plane (§10) only materialize
*after* a run completes; nothing can observe, alert on, or attribute
SLO violations while the controller is acting.  The bus closes that
gap: every engine — the event-loop sim, the batched sim and the serving
engine — publishes one ``BusFrame`` per observation interval through a
shared ``EngineBase`` hook (``observe_tick``), in virtual-ns or step
time order, and consumers attach without perturbing the telemetry
commit path (frames are built from the same host-side
``Telemetry.snapshot`` sync point the QoS controller already uses; on
the ``"torch"`` backend that is the one device-to-host copy).

Two consumption surfaces:

  * ``subscribe()``   — a bounded **drop-oldest** queue
    (``Subscription``): a slow consumer loses the *oldest* frames, the
    producer never blocks, and the drop count is explicit.
  * ``add_sink()``    — a synchronous tap (``on_frame``/``close``):
    streaming exporters and the live dashboard run inline at publish
    time; the run's wall clock pays exactly what the sink costs.

With nothing attached the engines' per-interval cost is one attribute
check.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.signals import SignalFrame

DEFAULT_QUEUE_DEPTH = 256


@dataclasses.dataclass(frozen=True)
class BusFrame:
    """One observation interval, as published on the bus.

    ``t`` is the interval's *end* in the backend's declared time unit
    (virtual ns on the simulators, engine steps on the serving engine);
    ``seq`` is the 0-based interval index.  ``signals`` is the
    interval-differenced ``SignalFrame``; ``counts`` the cumulative
    committed counter matrix ``[T, C]`` and ``interval_counts`` its
    difference against the previous frame.  ``weights``/``admit`` are
    the live scheduler arrays (post any controller actuation of the
    *previous* interval).  ``alerts`` carries the SLO burn-rate alerts
    raised in this interval (``slo_audit.SLOAlert``), empty when no
    audit is attached.  ``nic`` distinguishes publishers sharing one
    bus in a fleet run (``"nic<k>"``; empty on single-engine runs).
    """
    t: float
    seq: int
    time_unit: str
    backend: str
    signals: SignalFrame
    counts: np.ndarray
    interval_counts: np.ndarray
    weights: np.ndarray
    admit: np.ndarray
    alerts: Tuple = ()
    nic: str = ""


class Subscription:
    """Bounded drop-oldest frame queue handed out by ``subscribe``."""

    def __init__(self, maxlen: int = DEFAULT_QUEUE_DEPTH, name: str = ""):
        if maxlen <= 0:
            raise ValueError(f"subscription depth must be > 0, got {maxlen}")
        self.name = name
        self._q: Deque[BusFrame] = deque(maxlen=maxlen)
        self.dropped = 0          # frames evicted before being drained
        self.delivered = 0        # frames ever enqueued
        self.closed = False

    def _offer(self, frame: BusFrame) -> None:
        if self.closed:
            return
        if len(self._q) == self._q.maxlen:
            self.dropped += 1
        self._q.append(frame)
        self.delivered += 1

    def drain(self) -> List[BusFrame]:
        out = list(self._q)
        self._q.clear()
        return out

    def latest(self) -> Optional[BusFrame]:
        """Most recent frame, discarding anything older."""
        if not self._q:
            return None
        frame = self._q[-1]
        self._q.clear()
        return frame

    def close(self) -> None:
        self.closed = True
        self._q.clear()

    def __len__(self) -> int:
        return len(self._q)


class MetricsBus:
    """Fan-out hub between the engines' observe hook and consumers."""

    def __init__(self) -> None:
        self._subs: List[Subscription] = []
        self._sinks: List = []
        self.published = 0
        self.closed = False

    # -- consumer surface ---------------------------------------------------
    def subscribe(self, maxlen: int = DEFAULT_QUEUE_DEPTH,
                  name: str = "") -> Subscription:
        sub = Subscription(maxlen=maxlen, name=name)
        self._subs.append(sub)
        return sub

    def add_sink(self, sink):
        """Register a synchronous tap: ``sink.on_frame(frame)`` runs at
        every publish; ``sink.close()`` (if present) runs at bus close.
        Returns the sink for chaining."""
        self._sinks.append(sink)
        return sink

    # -- producer surface ---------------------------------------------------
    def publish(self, frame: BusFrame) -> None:
        if self.closed:
            raise RuntimeError("publish on a closed MetricsBus")
        self.published += 1
        for sub in self._subs:
            sub._offer(frame)
        for sink in self._sinks:
            sink.on_frame(frame)

    def close(self) -> None:
        """Flush + close every sink (exporters write their files here);
        subscriptions keep their queued frames for a final drain."""
        if self.closed:
            return
        self.closed = True
        for sink in self._sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()

    @property
    def dropped(self) -> int:
        return sum(s.dropped for s in self._subs)
