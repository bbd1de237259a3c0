"""Serving configuration of the port: one ``ServingConfig`` object, with
the JAX package's field names and grouping.

* ``evict``        — prefill eviction (``common.config.EvictionConfig``)
* ``decode_evict`` — decoding-stage eviction (``DecodeEvictionConfig``)
* ``chunking``     — prefill chunk geometry and the token-budget step
* ``sampling``     — ``core.policies.Sampling`` (None: greedy)
* ``prefix_cache`` — ``serving.prefix_cache.PrefixCache`` (None: off)

``ServingConfig.from_legacy`` / ``legacy_kwargs`` map the old
``ContinuousEngine`` keyword arguments onto the config and back (JAX's
deprecation shim; the engine still takes them, with a warning).

Fields the port's engine does not serve yet stay in the schema and make
``ContinuousEngine`` raise ``NotImplementedError`` naming their ROADMAP
item, so a config written for the JAX engine fails loudly here instead of
being served differently.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.common.config import EvictionConfig

__all__ = ["ChunkingConfig", "DecodeEvictionConfig", "ServingConfig"]


@dataclass(frozen=True)
class DecodeEvictionConfig:
    """Decoding-stage eviction (beyond-paper), one schema for all engines.

    ``enabled=False`` keeps the decode cache at ``max_new_tokens + 1``
    append rows, so a generation can never overrun it.  Enabled:

    * dense engines: the cache keeps only ``margin`` append rows; once
      full, each new token overwrites the row of lowest cumulative
      attention mass, per kv head, in the step itself
      (``attention.decode_attention_step_evicting``);
    * paged ``ContinuousEngine``: the cache grows block by block, and
      once a slot has grown by ``interval`` rows a sweep re-evicts it down
      to ``capacity`` under the masses kernel 5 streams, compacts the kept
      rows into the head of its block run and frees the tail blocks back
      to the ``KVBlockPool`` (``engine.paged_sweep``).  Reclaim comes in
      whole blocks, so an interval below the block size frees nothing.
    """

    enabled: bool = False
    interval: int = 64  # paged: rows of decode growth between sweeps
    margin: int = 8  # dense: append rows kept beyond the eviction capacity

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError("sweep interval must be >= 1 row")
        if self.margin < 1:
            raise ValueError("decode margin must be >= 1 row")

    @classmethod
    def coerce(cls, value) -> "DecodeEvictionConfig":
        """Accept the ``decode_evict`` spellings of the engines' keyword:
        a bool, None (disabled) or a config."""
        if isinstance(value, cls):
            return value
        if value is None:
            return cls()
        if not isinstance(value, bool):
            raise TypeError(f"decode_evict must be a bool or "
                            f"DecodeEvictionConfig, got "
                            f"{type(value).__name__}")
        return cls(enabled=value)

    def margin_rows(self, max_new_tokens: int) -> int:
        """Dense-cache append rows beyond the eviction capacity."""
        return self.margin if self.enabled else max_new_tokens + 1


@dataclass(frozen=True)
class ChunkingConfig:
    """Streaming-prefill geometry of the chunked continuous engine."""

    chunk: int = 128  # prefill chunk rows
    max_context: int = 1024  # base KV-buffer rung; longer prompts climb
    token_budget: Optional[int] = None  # per-step budget (None: derived)
    decode_chunk: int = 8  # largest decode chunk

    def __post_init__(self):
        if self.chunk < 1 or self.decode_chunk < 1:
            raise ValueError("chunk and decode_chunk must be >= 1")


#: the old ``ContinuousEngine`` keyword -> its ServingConfig field path
#: (the JAX package's deprecation shim, name for name)
_LEGACY_FIELDS = {
    "policy": "policy",
    "evict": "evict",
    "num_slots": "num_slots",
    "max_new_tokens": "max_new_tokens",
    "eos_id": "eos_id",
    "decode_evict": "decode_evict",
    "chunk": "chunking.chunk",
    "max_context": "chunking.max_context",
    "token_budget": "chunking.token_budget",
    "decode_chunk": "chunking.decode_chunk",
    "sampling": "sampling",
    "kv_pool": "kv_pool",
    "prefix_cache": "prefix_cache",
    "reserve_appends": "reserve_appends",
    "capture_admission": "capture_admission",
    "mesh": "mesh",
}


@dataclass
class ServingConfig:
    """Everything that shapes a ``ContinuousEngine``, in one object."""

    policy: str = "lookaheadkv"
    evict: EvictionConfig = field(default_factory=EvictionConfig)
    decode_evict: DecodeEvictionConfig = field(
        default_factory=DecodeEvictionConfig)
    chunking: ChunkingConfig = field(default_factory=ChunkingConfig)
    num_slots: int = 4
    max_new_tokens: int = 64  # per-request cap (sizes the cache margin)
    eos_id: int = 0
    sampling: Any = None  # core.policies.Sampling | None (None = greedy)
    kv_pool: Any = None  # serving.kv_pool.KVBlockPool
    prefix_cache: Any = None  # serving.prefix_cache.PrefixCache | None
    reserve_appends: bool = True  # guarantee admitted requests' growth
    capture_admission: bool = False  # stash mask/pos on each Request
    mesh: Any = None
    # trained lookahead modules to load (``launch/train.py`` writes them);
    # the serve half of the harvest -> distill -> serve loop
    lkv_checkpoint: Optional[str] = None
    # gt_oracle capture hook (``data.harvest.HarvestWriter`` or None),
    # called with every retired request
    harvest: Any = None
    trace: Any = None
    drift: Any = None
    sync_timers: Optional[bool] = None

    def __post_init__(self):
        self.decode_evict = DecodeEvictionConfig.coerce(self.decode_evict)
        if self.evict is None:
            self.evict = EvictionConfig()

    @classmethod
    def from_legacy(cls, **kwargs) -> "ServingConfig":
        """A config from the old ``ContinuousEngine`` keyword names (the
        deprecation shim); an unknown name raises ``TypeError``, as the
        old signature did."""
        unknown = set(kwargs) - set(_LEGACY_FIELDS)
        if unknown:
            raise TypeError(
                f"unknown ContinuousEngine kwargs: {sorted(unknown)}")
        top: dict = {}
        chunking: dict = {}
        for name, value in kwargs.items():
            path = _LEGACY_FIELDS[name]
            if path.startswith("chunking."):
                chunking[path.split(".", 1)[1]] = value
            else:
                top[path] = value
        if chunking:
            top["chunking"] = ChunkingConfig(**chunking)
        return cls(**top)

    def legacy_kwargs(self) -> dict:
        """The old keyword dict equivalent to this config (the round trip
        of ``from_legacy``; ``decode_evict`` stays a config, since
        ``from_legacy`` coerces a bool and not the reverse)."""
        out = {}
        for name, path in _LEGACY_FIELDS.items():
            obj: Any = self
            for part in path.split("."):
                obj = getattr(obj, part)
            out[name] = obj
        return out

    def replace(self, **changes) -> "ServingConfig":
        return dataclasses.replace(self, **changes)
