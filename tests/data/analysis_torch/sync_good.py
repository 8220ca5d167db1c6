"""Known-good host-sync fixture: the sync-free idioms, none a finding.

chip_smoke.py phase 29 runs every function in the rule's scope here on
the card under ``torch.cuda.set_sync_debug_mode("error")`` (no raise),
then captures it in a CUDA graph and holds the replay to the eager
result, on the inputs named there (x, s, mask, out, idx, ring, ptr).
"""
import numpy as np
import torch

HIST_GROWTH = 2.0


def scale_torch(x, s, cap=None, factor: float = 2.0):
    if cap is None:                         # `is` test: static
        cap = factor
    if factor > 1.0:                        # annotated scalar: static
        x = x * factor
    if x.dim() == 1 and x.shape[0] > 4:     # tensor metadata: static
        x = x + s
    return torch.clamp(x, max=cap * 4.0)


def bucket_torch(x):
    lo = float(np.log(HIST_GROWTH))         # host-constant math
    return torch.floor(torch.log(x.abs() + 1.0) / lo).to(torch.int32)


def select_torch(x, mask, out):
    return torch.where(mask, x, out)        # three-argument select


def ring_push_torch(ring, ptr, x):
    W = ring.shape[-1]
    hot = torch.arange(W, device=ring.device) == ptr % W
    ring.copy_(torch.where(hot[None, :], x[:ring.shape[0], None], ring))
    ptr += 1                                # in place on the device
    return ring, ptr


def scatter_torch(out, idx, x):
    out.scatter_add_(0, idx, x)             # in-place scatter
    state = {"out": out}
    state["sum"] = out.sum()                # a store into a state dict
    return state["sum"]


class Doubler:
    k = 2.0

    def apply_torch(self, x):
        if self.k > 1.0:                    # self is static
            return x * self.k
        return x


def step(x, out):
    out.copy_(_double(x) + out)


def _double(x):
    return x * 2.0


def capture(graph, x, out):
    with torch.cuda.graph(graph):           # `step` is a root
        step(x, out)
