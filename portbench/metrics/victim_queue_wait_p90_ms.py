"""90th percentile, over the victims' requests due in the window, of the
wait from a request's due time to the start of the engine step that
granted it a slot; a request still waiting at the window's end counts
its wait up to then.  ms."""
import numpy as np


def read(run):
    waits = [(r.grant if r.grant is not None and r.grant <= run.t1
              else run.t1) - r.due for r in run.victims_due()]
    if not waits:
        return None
    return float(np.percentile(waits, 90)) * 1e3
