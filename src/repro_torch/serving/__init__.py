"""Serving stack of the port: the continuous-batching engine (paged pool or
dense slot caches) and the lockstep engine."""

from repro_torch.serving.config import (ChunkingConfig, DecodeEvictionConfig,
                                        ServingConfig)
from repro_torch.serving.engine import ContinuousEngine, ServingEngine
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.scheduler import Request, RequestState, SlotScheduler

__all__ = ["ChunkingConfig", "ContinuousEngine", "DecodeEvictionConfig",
           "KVBlockPool", "Request", "RequestState", "ServingConfig",
           "ServingEngine", "SlotScheduler"]
