"""IO transfer fragmentation — paper §5.1 step 5 / §6.2 "Enhanced DMA engine".

Large DMA/egress transfers are split into fragments so small transfers are
never HoL-blocked for more than one fragment's service time.  Two modes:

  * ``software`` — fragmentation in the kernel call: each fragment pays a
    per-fragment issue overhead on the PU (control traffic), which is the
    congestor-throughput cost visible in paper Fig. 10.
  * ``hardware`` — the DMA engine keeps per-transfer state and interleaves
    bursts; per-fragment overhead is a bus-arbitration constant.

The same policy fragments serving-engine prefills (chunked prefill): a 32k
prefill becomes ceil(32k/F) chunks, each a run-to-completion step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List


@dataclasses.dataclass(frozen=True)
class FragmentationPolicy:
    mode: str = "hardware"            # "off" | "software" | "hardware"
    fragment_bytes: int = 512
    sw_overhead_cycles: int = 95      # per-fragment PU issue cost
    hw_overhead_cycles: int = 2       # per-fragment burst re-arb cost

    @property
    def per_fragment_overhead(self) -> int:
        if self.mode == "software":
            return self.sw_overhead_cycles
        if self.mode == "hardware":
            return self.hw_overhead_cycles
        return 0


@dataclasses.dataclass
class Fragment:
    tenant: int
    transfer_id: int
    seq: int
    nbytes: int
    last: bool


def fragment_transfer(policy: FragmentationPolicy, tenant: int,
                      transfer_id: int, nbytes: int) -> List[Fragment]:
    if policy.mode == "off" or nbytes <= policy.fragment_bytes:
        return [Fragment(tenant, transfer_id, 0, nbytes, True)]
    out, off, seq = [], 0, 0
    F = policy.fragment_bytes
    while off < nbytes:
        n = min(F, nbytes - off)
        out.append(Fragment(tenant, transfer_id, seq, n, off + n >= nbytes))
        off += n
        seq += 1
    return out


def fragment_tokens(total_tokens: int, chunk: int) -> Iterator[tuple]:
    """(offset, length) chunks for a prefill of `total_tokens` tokens."""
    off = 0
    while off < total_tokens:
        n = min(chunk, total_tokens - off)
        yield off, n
        off += n
