"""The device trace of the measured window, reduced.

``torch.profiler`` records the window with CPU and CUDA activity; the
harness's own marks (``portbench.window``, ``.step``, ``.prefill``,
``.decode``, ``.reset``) are user annotations in the same clock as the
device's operations.  ``reduce`` reads the raw events once and returns
the device's busy time (the union of every operation's interval), the
device time of the operations that each kind of call launched (an
operation belongs to the call inside whose span it starts: every call
ends by reading its tokens back, so its operations end inside it too),
the time of each operation by name, and the idle gaps by what the host
was doing when they began.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Tuple

CALLS = ("prefill", "decode", "reset")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    call_device_s: Dict[str, float]            # kind -> device seconds
    call_count: Dict[str, int]
    by_name: Dict[str, float]                  # op name -> device seconds
    idle: Dict[str, float]                     # what the host did -> idle s
    gaps: List[Tuple[str, float]]              # the longest idle gaps

    def op_seconds(self, part: str) -> float:
        """Device seconds of the operations whose name holds ``part``."""
        return sum(t for n, t in self.by_name.items() if part in n)

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(self.idle.items(), key=lambda kv: -kv[1])
        gaps = [[f"{k} (idle in all)", v] for k, v in idle][:TOP // 2]
        gaps += [[f"{k} (one gap)", v] for k, v in self.gaps]
        return {"device_ops": [[n[:160], t] for n, t in top],
                "idle_gaps": gaps[:TOP]}


def raw_events(prof):
    """(device ops, harness spans): lists of (name, start_s, end_s)."""
    from torch.autograd import DeviceType
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if hasattr(e, "start_ns"):
            t0, t1 = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        else:
            t0 = e.start_us() * 1e-6
            t1 = t0 + e.duration_us() * 1e-6
        mine = name.startswith("portbench.")
        if e.device_type() == DeviceType.CUDA:
            if not mine:        # a mark's shadow on the device's timeline
                ops.append((name, t0, t1))
        elif mine:
            spans.append((name[len("portbench."):], t0, t1))
    return ops, spans


def reduce(ops, spans) -> Trace:
    win = [(a, b) for n, a, b in spans if n == "window"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans")
    w0, w1 = win[0]
    ops = [(n, max(a, w0), min(b, w1)) for n, a, b in ops
           if b > w0 and a < w1]
    ops.sort(key=lambda o: o[1])
    calls = sorted((a, b, n) for n, a, b in spans if n in CALLS)
    steps = sorted((a, b) for n, a, b in spans if n == "step")
    starts = [c[0] for c in calls]
    step_starts = [s[0] for s in steps]

    def inside(t, lst, starts_):
        i = bisect.bisect_right(starts_, t) - 1
        return i if i >= 0 and t <= lst[i][1] else -1

    by_name = collections.defaultdict(float)
    call_dev = collections.defaultdict(float)
    busy, cur_a, cur_b = 0.0, None, None
    idle = collections.defaultdict(float)
    gaps = []

    def label(t):
        i = inside(t, calls, starts)
        if i >= 0:
            return calls[i][2] + "_call"
        return "engine_host" if inside(t, steps, step_starts) >= 0 \
            else "harness"

    last_end = w0
    for name, a, b in ops:
        by_name[name] += b - a
        i = inside(a, calls, starts)
        if i >= 0:
            call_dev[calls[i][2]] += b - a
        if a > last_end:
            g = a - last_end
            lab = label(last_end)
            idle[lab] += g
            gaps.append((lab, g))
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        last_end = max(last_end, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if w1 > last_end:
        idle[label(last_end)] += w1 - last_end
        gaps.append((label(last_end), w1 - last_end))
    gaps.sort(key=lambda g: -g[1])
    count = collections.Counter(c[2] for c in calls)
    return Trace(w1 - w0, busy, dict(call_dev), dict(count),
                 dict(by_name), dict(idle), gaps[:TOP // 2])
