"""Device time of the operations launched inside a prefill call, per call,
ms, from the trace of the window."""


def read(run):
    tr = run.trace
    if tr is None or not tr.call_count.get("prefill"):
        return None
    return tr.call_device_s.get("prefill", 0.0) / tr.call_count["prefill"] * 1e3
