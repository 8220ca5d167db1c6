"""Balanced host spans for the port's span-balance rule (fixture)."""
from repro_torch.telemetry import trace as TR


def step(tr, exe):
    tr.host_root(TR.H_STEP)
    tr.host_begin(TR.H_CONTROL)
    tr.host_next(TR.H_DECODE)
    tr.host_begin(TR.H_EXE_DECODE, 1, 4)
    exe.decode()
    tr.host_end()
    tr.host_end()
    tr.host_end()


def lifecycle(tr, uid):
    tr.host_request(uid, 0, TR.H_REQ_QUEUE, 0)
    tr.host_request_end(uid, 1, TR.D_KILL)
