"""Multi-tenant serving engine: OSMOSIS scheduling over continuous batching."""
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.request import Request, RequestStatus
from repro_torch.serving.sampler import sample

__all__ = ["Engine", "EngineConfig", "Request", "RequestStatus", "sample"]
