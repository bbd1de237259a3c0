"""Serving stack of the port: the chunked continuous-batching engine (paged
pool or dense slot caches, with sampling and a radix-trie prefix cache),
the bucket-padded continuous engine and the lockstep engine."""

from repro_torch.core.policies import Sampling
from repro_torch.serving.config import (ChunkingConfig, DecodeEvictionConfig,
                                        ServingConfig)
from repro_torch.serving.engine import (BucketedEngine, ContinuousEngine,
                                        ServingEngine)
from repro_torch.serving.kv_pool import KVBlockPool
from repro_torch.serving.prefix_cache import PrefixCache, PrefixEntry
from repro_torch.serving.scheduler import Request, RequestState, SlotScheduler

__all__ = ["BucketedEngine", "ChunkingConfig", "ContinuousEngine",
           "DecodeEvictionConfig", "KVBlockPool", "PrefixCache",
           "PrefixEntry", "Request", "RequestState", "Sampling",
           "ServingConfig", "ServingEngine", "SlotScheduler"]
