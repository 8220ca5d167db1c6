"""Model FLOPs the traffic needed in the window (every valid prompt token
and every decode token through every layer, attention over the
positions each attends, the LM head where a token is sampled; counted by
``counts/<family>.py``, not from what the program executes) over the
window's seconds times the card's bf16 peak, %."""
from portbench.counts.peaks import BF16_FLOPS


def read(run):
    c, pub = run.counts, run.pub
    flops = 0.0
    for call in run.calls:
        if call.kind == "prefill":
            flops += c.prefill_flops(pub, call.lengths, call.rows,
                                     call.samples)
        elif call.kind == "decode":
            flops += c.decode_flops(pub, call.lengths, call.rows)
    if flops <= 0:
        return None
    return 100.0 * flops / (run.seconds * BF16_FLOPS)
