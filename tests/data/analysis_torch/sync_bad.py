"""Known-bad host-sync fixture: one violation class per function, each a
``*_torch`` root (the rule run with this file as its sync-free scope).

tests/test_torch_analysis.py asserts the exact line of every finding,
and chip_smoke.py phase 29 runs every function the rule flags on the
card under ``torch.cuda.set_sync_debug_mode("error")``: keep line
numbers stable, and every function runnable on the inputs named there
(x, s, mask, out, idx, ring, ptr).
"""
import numpy as np
import torch


def item_torch(x):
    return x.sum().item()                   # line 15: host copy


def tolist_torch(x):
    return x.tolist()                       # line 19


def cpu_torch(x):
    return x.cpu()                          # line 23


def numpy_torch(x):
    return x.numpy()                        # line 27


def to_cpu_torch(x):
    return x.to("cpu")                      # line 31


def synchronize_torch(x):
    y = x * 2.0
    torch.cuda.synchronize()                # line 36
    return y


def float_torch(s):
    return float(s) * 2.0                   # line 41: float() of a tensor


def int_torch(s):
    return int(s) + 1                       # line 45


def bool_torch(s):
    return bool(s)                          # line 49


def branch_torch(x):
    if x.sum() > 0:                         # line 53: traced `if`
        return x
    return -x


def loop_torch(x):
    while x.abs().max() > 1.0:              # line 59: traced `while`
        x = x / 2.0
    return x


def ternary_torch(x, s):
    return x if s > 0 else -x               # line 65: traced ternary


def assert_torch(x):
    assert (x > -100.0).all()               # line 69: traced `assert`
    return x * 2.0


def nonzero_torch(x):
    return torch.nonzero(x > 0)             # line 74: data-dependent


def unique_torch(idx):
    return torch.unique(idx)                # line 78


def argwhere_torch(x):
    return torch.argwhere(x > 0)            # line 82


def masked_select_torch(x, mask):
    return torch.masked_select(x, mask)     # line 86


def where_torch(x):
    return torch.where(x > 0)               # line 90: 1-arg where


def mask_index_torch(x):
    return x[x > 0]                         # line 94: boolean mask


def bincount_torch(idx):
    return torch.bincount(idx, minlength=8)  # line 98


def numpy_call_torch(x):
    return np.exp(x)                        # line 102: numpy on a tensor


def copy_into_torch(x, out):
    out.copy_(x * 2.0)                      # in place: legal, no finding
    return out


def reaches_helper_torch(x):
    return _scaled_max(x)


def _scaled_max(x):
    return x.max().item() * 2.0             # line 115: reached by a call
