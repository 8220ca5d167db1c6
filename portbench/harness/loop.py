"""The served path under load: the program's ``ServeRuntime`` over its
``Engine`` and ``ModelExecutor``, driven step by step while the traffic
arrives, with every call into the executor timed.

``TimedExecutor`` wraps the program's executor: it forwards each
``prefill`` / ``decode`` / ``reset`` unchanged and in order, stamps its
start and end on the host clock, marks it for the profiler
(``record_function``) and keeps the call's lengths, so that the counts
can be taken afterwards.  ``Driver`` submits the requests as they fall
due, steps the engine, and stamps every token when the call that made it
returned it to the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

clock = time.perf_counter


@dataclasses.dataclass
class Call:
    kind: str                    # prefill | decode | reset
    t0: float
    t1: float
    lengths: Optional[np.ndarray] = None
    rows: Optional[np.ndarray] = None      # valid_n (prefill) or active
    samples: Optional[np.ndarray] = None   # prefill rows whose chunk ends
    #                                        their prompt (a token sampled)


class TimedExecutor:
    """Forwards to the program's executor; times and records each call."""

    def __init__(self, inner):
        self.inner = inner
        self.device = inner.device
        self.engine = None              # set once the engine exists
        self.calls: List[Call] = []
        self.last: Dict[str, float] = {}

    def _call(self, kind, fn, *args):
        t0 = clock()
        with torch.profiler.record_function(f"portbench.{kind}"):
            out = fn(*args)
        t1 = clock()
        self.last[kind] = t1
        return out, t0, t1

    def prefill(self, tokens, lengths, valid_n):
        slots = self.engine.slot_req
        samples = np.array([n > 0 and r is not None
                            and r.prefill_done + n >= r.prompt_len
                            for n, r in zip(valid_n, slots)])
        out, t0, t1 = self._call("prefill", self.inner.prefill, tokens,
                                 lengths, valid_n)
        self.calls.append(Call("prefill", t0, t1, lengths.copy(),
                               valid_n.copy(), samples))
        return out

    def decode(self, tokens, lengths, active):
        out, t0, t1 = self._call("decode", self.inner.decode, tokens,
                                 lengths, active)
        self.calls.append(Call("decode", t0, t1, lengths.copy(),
                               np.asarray(active, bool).copy()))
        return out

    def reset(self, keep):
        _, t0, t1 = self._call("reset", self.inner.reset, keep)
        self.calls.append(Call("reset", t0, t1))


@dataclasses.dataclass
class Rec:
    """One request as the client sees it (host clock, seconds)."""
    tenant: int
    victim: bool
    due: float
    submitted: float
    req: object                       # the program's Request
    grant: Optional[float] = None
    times: List[float] = dataclasses.field(default_factory=list)
    end: Optional[float] = None
    status: str = ""


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    calls: float                      # seconds inside executor calls


class Driver:
    """Sends a mix's requests into a ``ServeRuntime`` and steps it."""

    def __init__(self, rt, exe: TimedExecutor, traffic, request_cls):
        self.rt, self.eng, self.exe = rt, rt.engine, exe
        self.traffic, self.Request = traffic, request_cls
        self.recs: List[Rec] = []
        self.steps: List[Step] = []
        self.start: Optional[float] = None
        self._by_req: Dict[int, Rec] = {}
        self._done_i = 0
        self.max_late = 0.0

    def _submit(self, item, now: float) -> None:
        req = self.Request(item.tenant, item.prompt,
                           max_new_tokens=item.max_new_tokens)
        rec = Rec(item.tenant, self.traffic.victim(item.tenant),
                  self.start + item.due, now, req)
        self.max_late = max(self.max_late, now - rec.due)
        self.recs.append(rec)
        self.rt.inject([req])
        if req.status.value == "rejected":
            rec.end, rec.status = now, "rejected"
            self._refill(rec, now)
        else:
            self._by_req[id(req)] = rec

    def _refill(self, rec: Rec, now: float) -> None:
        item = self.traffic.closed(rec.tenant, now - self.start)
        if item is not None:
            self._submit(item, now)

    def begin(self) -> None:
        self.start = clock()
        for item in self.traffic.initial():
            self._submit(item, self.start)

    def run(self, until: float) -> None:
        """Step until the host clock passes ``until``."""
        eng, exe = self.eng, self.exe
        while True:
            now = clock()
            if now >= until:
                return
            for item in self.traffic.arrivals(now - self.start):
                self._submit(item, now)
            live = [r for r in eng.slot_req if r is not None]
            n_calls = len(exe.calls)
            exe.last.clear()
            t0 = clock()
            with torch.profiler.record_function("portbench.step"):
                eng.step()
            t1 = clock()
            inside = sum(c.t1 - c.t0 for c in exe.calls[n_calls:])
            self.steps.append(Step(t0, t1, inside))
            live += [r for r in eng.slot_req
                     if r is not None and r.start_step == eng.step_count - 1]
            for req in live:
                rec = self._by_req.get(id(req))
                if rec is None:
                    continue
                if rec.grant is None:
                    rec.grant = t0
                have, seen = len(req.generated), len(rec.times)
                if have > seen:
                    if seen == 0:
                        rec.times.append(exe.last.get("prefill", t1))
                    rec.times += [exe.last.get("decode", t1)] * (
                        have - len(rec.times))
            done = eng.done
            while self._done_i < len(done):
                req = done[self._done_i]
                self._done_i += 1
                rec = self._by_req.pop(id(req), None)
                if rec is None:
                    continue
                rec.end, rec.status = t1, req.status.value
                self._refill(rec, t1)
