"""Serving stack of the port: the paged continuous-batching engine."""

from repro_torch.serving.config import (ChunkingConfig, DecodeEvictionConfig,
                                        ServingConfig)
from repro_torch.serving.engine import ContinuousEngine
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.scheduler import Request, RequestState, SlotScheduler

__all__ = ["ChunkingConfig", "ContinuousEngine", "DecodeEvictionConfig",
           "KVBlockPool", "Request", "RequestState", "ServingConfig",
           "SlotScheduler"]
