"""Mean host time of an engine step outside the executor's calls (the
engine's control plane, scheduling, telemetry), ms, over the window."""
import numpy as np


def read(run):
    if not run.steps:
        return None
    return float(np.mean([s.t1 - s.t0 - s.calls for s in run.steps])) * 1e3
