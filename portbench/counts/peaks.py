"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity) at its full 700 W power limit."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take for this work: the larger of
    operations over the peak rate and bytes over the HBM bandwidth."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
