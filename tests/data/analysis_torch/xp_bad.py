"""Known-bad xp-purity fixture: one violation class per function.

tests/test_torch_analysis.py holds the port's ``xp-purity`` to the JAX
package's ``jit-purity`` here, finding for finding, and asserts every
line: keep line numbers stable when editing.
"""
import numpy as np
import torch


def inplace_at(xp, x):
    np.add.at(x, 0, 1.0)                    # line 12: in-place scatter
    return x


def subscript_store(xp, x):
    x = x + 1.0
    x[0] = 2.0                              # line 18: subscript store
    return x


def mixes_numpy(xp, x):
    y = np.cumsum(x)                        # line 23: np in traced path
    return xp.asarray(y)


def traced_branch(xp, x):
    if x.sum() > 0:                         # line 28: traced `if`
        return x
    return -x


def traced_loop(xp, x):
    while x.max() > 1.0:                    # line 34: traced `while`
        x = x / 2.0
    return x


def dynamic_shape(xp, x):
    return xp.nonzero(x)                    # line 40: dynamic shape


def one_arg_where(xp, x):
    return xp.where(x > 0)                  # line 44: 1-arg where


def reaches_helpers(xp, x):
    return _clip(x) + torch.vmap(_exp)(x)


def _clip(x):
    return x if x.min() >= 0 else -x        # line 52: reached by a call


def _exp(x):
    return np.exp(x)                        # line 56: a vmap body
