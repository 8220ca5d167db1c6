"""Mean wall time of a decode call of the executor in the window, up to its
tokens on the host, ms."""
import numpy as np


def read(run):
    t = [c.t1 - c.t0 for c in run.calls if c.kind == "decode"]
    return float(np.mean(t)) * 1e3 if t else None
