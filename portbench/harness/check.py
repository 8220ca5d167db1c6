"""Whether the timed path served the right tokens.

Once the window has closed, a sample of the requests it finished or
left in flight (with the tokens they served by its end), with each
tenant's longest and the rest drawn from the seed, is run through the plain
fp32 reference (``reference/<family>.py``, TF32 off) on the harness's
own weights: each prompt followed by the tokens the program served.  At
every served position the number compared is the gap by which the served
token's reference logit lies below the reference's best one (0 when the
program chose the reference's argmax); the run is correct when the
widest gap over the sample is within the configuration's limit.  The
program decodes greedily, so a sound program's gaps are rounding only.

The control (``gaps(..., control=True)``) reads, at the same positions, the gap of
the token that the reference computed one precision lower (fp8 weight
products) puts first.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from portbench.reference.common import Precision, no_tf32


@dataclasses.dataclass
class Sample:
    prompt: np.ndarray
    served: np.ndarray
    tenant: int = -1


def _served(r, t0: float, t1: float) -> Optional[Sample]:
    """A request's prompt and the tokens served by ``t1``: one that
    finished in [t0, t1], or one still in flight at ``t1`` that has served
    a token (the engine stops at the window's end, so what it holds then
    is what was served by ``t1``)."""
    n = len(r.req.generated)
    if r.status == "done":
        keep = r.end is not None and t0 <= r.end <= t1
    else:
        keep = r.status == "" and n > 0
    if not keep:
        return None
    return Sample(np.asarray(r.req.prompt), np.asarray(r.req.generated),
                  r.tenant)


def draw_sample(recs, seed: int, t0: float, t1: float, tokens: int,
                most: int) -> List[Sample]:
    """Requests finished in the window or in flight at its end: first, of
    each tenant, the one that served the most tokens (the longest of all
    among them), so that every tenant's lengths are in the sample; then
    others in an order drawn from ``seed`` until ``tokens`` served tokens
    or ``most`` requests."""
    cand = [s for s in (_served(r, t0, t1) for r in recs) if s is not None]
    if not cand:
        return []
    rng = np.random.default_rng(np.random.SeedSequence([seed % (1 << 63),
                                                        0xC0FFEE]))
    size = [(len(s.served), len(s.prompt)) for s in cand]
    lead = {}
    for i, s in enumerate(cand):
        j = lead.get(s.tenant)
        if j is None or size[i] > size[j]:
            lead[s.tenant] = i
    first = sorted(lead.values(), key=lambda i: size[i], reverse=True)
    order = first + [int(i) for i in rng.permutation(len(cand))
                     if int(i) not in lead.values()]
    out, n = [], 0
    for k, i in enumerate(order):
        if k >= len(first) and (n >= tokens or len(out) >= most):
            break
        out.append(cand[i])
        n += len(cand[i].served)
    return out


def _logits(ref, W, pub, s: Sample, device, mode: str) -> torch.Tensor:
    seq = np.concatenate([s.prompt, s.served[:-1]]).astype(np.int64)
    tokens = torch.as_tensor(seq, device=device)
    with no_tf32():
        return ref.logits(W, pub, tokens, len(s.prompt) - 1,
                          Precision(mode))


def gaps(ref, W, pub, sample: List[Sample], device,
         control: bool = False) -> dict:
    """Per sampled request, the served tokens' gaps (and with ``control``
    the control's), as numpy arrays."""
    out = {"served": [], "control": []}
    for s in sample:
        lr = _logits(ref, W, pub, s, device, "fp32")
        best = lr.max(dim=-1).values
        tok = torch.as_tensor(s.served.astype(np.int64), device=lr.device)
        rows = torch.arange(len(tok), device=lr.device)
        out["served"].append((best - lr[rows, tok]).cpu().numpy())
        if control:
            lc = _logits(ref, W, pub, s, device, "fp8")
            pick = lc.argmax(dim=-1)
            out["control"].append((best - lr[rows, pick]).cpu().numpy())
            del lc
        del lr
    return out


def widest(per_request: List[np.ndarray]) -> Optional[float]:
    if not per_request:
        return None
    return float(max(float(g.max()) for g in per_request))
