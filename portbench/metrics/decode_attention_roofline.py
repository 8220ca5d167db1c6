"""The decode-attention kernel's share of its roofline over the window,
%: the least time the card could take for the work the traffic gave it
(per launch, K and V of each active row up to its fill, its q and
output; ``counts/<family>.py``), summed over the window's decode calls,
over the kernel's summed device time in the trace."""
from portbench.counts.peaks import bound_s

KERNEL = "decode_attention"


def read(run):
    c, tr = run.counts, run.trace
    if tr is None or not hasattr(c, "decode_attention_work"):
        return None
    spent = tr.op_seconds(KERNEL)
    if spent <= 0:
        return None
    least = sum(bound_s(*c.decode_attention_work(run.pub, call.lengths,
                                                 call.rows))
                for call in run.calls if call.kind == "decode")
    return 100.0 * least * c.launches_per_call(run.pub) / spent
