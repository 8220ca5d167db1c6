"""The routed experts' grouped GEMMs' share of their roofline over the
window, %: the least time the card could take for the experts' work the
traffic gave it (per call, the weights of the experts its valid tokens
reach under balanced routing and the tokens' rows, summed over the MoE
layers; ``counts/<family>.py``'s ``moe_experts_work``), summed over the
window's prefill and decode calls, over the grouped GEMM kernels' summed
device time in the trace."""
from portbench.counts.peaks import bound_s

# the CUTLASS grouped GEMM ``torch._grouped_mm`` launches on sm90 (its
# template names the grouped problem shape); no other kernel of a serve
# call carries it
KERNEL = "GroupProblemShape"


def read(run):
    c, tr = run.counts, run.trace
    if tr is None or not hasattr(c, "moe_experts_work"):
        return None
    spent = tr.op_seconds(KERNEL)
    if spent <= 0:
        return None
    least = sum(bound_s(*c.moe_experts_work(run.pub, call.lengths,
                                            call.rows))
                for call in run.calls if call.kind in ("prefill", "decode"))
    return 100.0 * least / spent
