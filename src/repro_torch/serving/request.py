"""Serving requests: the 'packets' of the serving adaptation."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import numpy as np


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    KILLED = "killed"        # watchdog budget exceeded (paper §5.3)
    REJECTED = "rejected"    # admission failure (R3)


@dataclasses.dataclass
class Request:
    tenant_id: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 32
    rid: int = -1                       # assigned by the engine
    arrival_step: int = -1
    status: RequestStatus = RequestStatus.QUEUED

    # progress
    prefill_done: int = 0               # tokens of prompt already processed
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    start_step: int = -1
    finish_step: int = -1
    chunk_steps: List[int] = dataclasses.field(default_factory=list)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + len(self.generated)

    @property
    def fct(self) -> Optional[int]:
        if self.finish_step < 0:
            return None
        return self.finish_step - self.arrival_step
