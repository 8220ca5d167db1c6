"""Host-span violations for the port's span-balance rule (fixture)."""
from repro_torch.telemetry import trace as TR


def step_left_open(tr):
    tr.host_root(TR.H_STEP)
    tr.host_begin(TR.H_CONTROL)
    tr.host_next(TR.H_ASSIGN)
    tr.host_end()


def numeric_name(tr):
    tr.host_begin(3)
    tr.host_end()


def queue_only(tr, uid):
    tr.host_request(uid, 0, TR.H_REQ_QUEUE, 0)
