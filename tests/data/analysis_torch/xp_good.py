"""Known-good xp-purity fixture: every allowed idiom in one file.

These patterns must produce ZERO findings under the port's ``xp-purity``
and the JAX package's ``jit-purity`` alike.
"""
import numpy as np

HIST_GROWTH = 1.5


def commit(xp, staged, totals, floor: float):
    """xp-generic collector kernel: pure, fixed-shape, branch-free."""
    if floor is None:                       # `is` test is trace-static
        floor = 0.0
    lo = np.log(HIST_GROWTH)                # host-constant math, allowed
    mask = xp.where(staged > floor, 1.0, 0.0)
    return totals + staged * mask + lo


def eager_fast_path(xp, counts):
    if xp is np:                            # sanctioned numpy guard
        return np.cumsum(counts)
    return xp.cumsum(counts)


def ring_write(xp, ring, ptr, sample):
    hot = xp.arange(ring.shape[-1]) == ptr % ring.shape[-1]
    return xp.where(hot, sample[..., None], ring), ptr + 1


def doubled(xp, x):
    if x.ndim == 2:                         # shape metadata is static
        return _twice(x)
    return x + x


def _twice(x):
    return x * np.float32(2.0)              # a dtype constant, allowed
