"""TrainState: the model module (its parameters) + optimizer slots + step."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    params: nn.Module                    # the parameters are the module's
    opt_state: Any
    step: torch.Tensor                   # int32 scalar, on the device
    err_feedback: Optional[Any] = None   # gradient compression: not ported

    @classmethod
    def create(cls, module: nn.Module, optimizer) -> "TrainState":
        module.requires_grad_(True)
        params = dict(module.named_parameters())
        dev = next(iter(params.values())).device
        return cls(params=module, opt_state=optimizer.init(params),
                   step=torch.zeros((), dtype=torch.int32, device=dev))

    def named_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.params.named_parameters())
