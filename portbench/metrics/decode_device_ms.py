"""Device time of the operations launched inside a decode call, per call,
ms, from the trace of the window."""


def read(run):
    tr = run.trace
    if tr is None or not tr.call_count.get("decode"):
        return None
    return tr.call_device_s.get("decode", 0.0) / tr.call_count["decode"] * 1e3
