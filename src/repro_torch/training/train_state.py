"""TrainState: the parameters + optimizer slots + step (+ the gradient
compression residual).

On one device ``params`` is the model module.  The sharded trainer's
state holds ``{name: DTensor}`` instead, each parameter's slice on its
rank, with optimizer slots (and the residual) placed alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    params: Union[nn.Module, Dict[str, torch.Tensor]]
    opt_state: Any
    step: torch.Tensor                   # int32 scalar, on the device
    err_feedback: Optional[Any] = None   # gradient-compression residual

    @classmethod
    def create(cls, module: nn.Module, optimizer, *,
               compression: bool = False) -> "TrainState":
        from repro_torch.distributed import compression as C
        module.requires_grad_(True)
        params = dict(module.named_parameters())
        dev = next(iter(params.values())).device
        return cls(params=module, opt_state=optimizer.init(params),
                   step=torch.zeros((), dtype=torch.int32, device=dev),
                   err_feedback=C.init_error(params) if compression
                   else None)

    def named_params(self) -> Dict[str, torch.Tensor]:
        if isinstance(self.params, nn.Module):
            return dict(self.params.named_parameters())
        return dict(self.params)
