"""Prefix-aware KV reuse for chunked prefill: a token-level radix trie over
chunk-aligned prompt prefixes.

Serving traffic shares prompt prefixes (system prompts, RAG context,
few-shot headers).  Chunked prefill makes their reuse exact: scoring is
causal and streamed per chunk, so at any chunk boundary the pair

    (KV buffer columns [0, n),  scoring.ScoreState)

is a function of the first ``n`` prompt tokens alone, bit for bit the same
for every request that shares them (per-request randomness such as
``Request.seed`` enters only at finalize).  A hit therefore skips the
prefix's attention and its score accumulation, and the resumed request
still ends with the tokens and kept sets it would have produced uncached.

Structure
---------
``PrefixCache`` is a radix trie (compressed token edges) whose nodes carry
an entry at chunk-aligned depths only: partial-chunk prefixes are never
cached and never match.  Each entry owns

* the KV span ``[parent_entry.depth, depth)``: spans are deduplicated
  along the chain, so a 3-chunk entry and a 2-chunk entry sharing two
  chunks hold those two chunks once;
* a ``ScoreState`` snapshot at its boundary;
* the last chunk's next-token logits, so a prompt that *is* a cached
  prefix admits with no prefill chunk.

Entries are refcounted: ``refs`` counts child entries (a parent's span is
part of every descendant's chain) plus in-flight pins (``acquire`` /
``release`` around a request's streaming prefill).  Eviction is LRU over
unpinned, childless entries under a byte budget (``nbytes`` counts
exactly what an entry holds); an insert that cannot fit by evicting
unpinned entries is skipped (the request still serves).

Under a mesh every rank holds the same trie over its own kv-head shard
of the snapshots (dense spans and ``ScoreState``) or of the pool's
blocks, and ``nbytes`` counts an entry's global bytes (``bind``'s
``kv_shards`` times its sharded bytes, the logits once), so that the
byte budget evicts as the JAX package's single-device cache does.

Dense mode keeps private device copies of each span.  With a
``KVBlockPool`` bound (paged serving) a span is a pinned run of pool
blocks instead: shared prefixes occupy the pool the decode caches draw
from, ``max_bytes`` caps how much of it the cache may pin, and the engine
reclaims unpinned entries when live requests need the blocks.

The port of the JAX package's ``serving/prefix_cache.py``.  PyTorch runs
eagerly, so ``materialize`` has no compiled programs to cache (the JAX
package's ``_mat_fns``): ``stats()["materialize_programs"]`` stays 0.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.obs.metrics import bind_stat_gauges

__all__ = ["PrefixCache", "PrefixEntry"]


class _Node:
    """Radix-trie node: a compressed token edge, children keyed by their
    edge's first token, and (at chunk-aligned depths) a cache entry."""

    __slots__ = ("edge", "children", "entry", "depth", "parent")

    def __init__(self, edge: np.ndarray, depth: int,
                 parent: Optional["_Node"]):
        self.edge = edge  # (len,) token segment labelling the in-edge
        self.children: dict[int, _Node] = {}
        self.entry: Optional[PrefixEntry] = None
        self.depth = depth  # tokens from the root through this edge
        self.parent = parent


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class PrefixEntry:
    """One cached chunk-boundary snapshot (module docstring)."""

    __slots__ = ("depth", "start", "parent", "k_block", "v_block", "blocks",
                 "score", "logits", "nbytes", "refs", "node", "src_capacity")

    def __init__(self, *, depth, start, parent, score, logits, node,
                 src_capacity, k_block=None, v_block=None, kv_shards=1):
        self.depth = depth  # prefix length (chunk-aligned)
        self.start = start  # the parent's depth: the span is [start, depth)
        self.parent: Optional[PrefixEntry] = parent
        # KV-buffer depth the donor streamed under: a resumed prefill is
        # bitwise the requester's own only under the same buffer shape
        # (kernel 1's key splits depend on it), so lookup filters on it and
        # a chain never mixes capacities
        self.src_capacity = src_capacity
        self.k_block = k_block  # (L, 1, depth - start, KV, hd), or None
        self.v_block = v_block  # when the span lives in the pool:
        self.blocks: Optional[np.ndarray] = None  # pinned pool block ids
        self.score = score  # ScoreState snapshot at ``depth``
        self.logits = logits  # (1, V) the boundary chunk's logits
        self.node = node
        self.refs = 0  # child entries + in-flight pins; evictable at 0
        # global bytes: the span and the score state hold one of
        # ``kv_shards`` head shards, the logits are whole on every rank
        self.nbytes = _nbytes(logits) + score.nbytes(kv_shards) + (
            0 if k_block is None
            else kv_shards * (_nbytes(k_block) + _nbytes(v_block)))


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class PrefixCache:
    """Radix-trie prompt cache with refcount pinning, LRU order and a hard
    byte budget.  One cache serves one (chunk, policy, model) binding,
    which the engine binds on construction (``ScoreState`` is shaped by
    the policy; the chunk decides which depths are cacheable)."""

    def __init__(self, *, chunk: int, max_bytes: int,
                 policy: Optional[str] = None, pool=None):
        if chunk <= 0 or max_bytes <= 0:
            raise ValueError("chunk and max_bytes must be positive")
        self.chunk = chunk
        self.max_bytes = max_bytes
        self.policy = policy  # bound by the first engine that adopts it
        # paged mode: spans are pinned runs of this KVBlockPool's blocks;
        # chunk boundaries must land on block boundaries
        self.pool = pool
        if pool is not None and chunk % pool.block_size:
            raise ValueError("chunk must be a multiple of the pool block "
                             "size")
        # the bound params dict, held so that identity stays meaningful
        self._model = None
        # kv-head shards of the bound engine's mesh (1: single device)
        self.kv_shards = 1
        self._root = _Node(np.zeros(0, np.int32), 0, None)
        self._lru: OrderedDict[PrefixEntry, None] = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.tokens_hit = 0  # prefix tokens served from the cache

    # -- binding ---------------------------------------------------------
    def bind(self, *, chunk: int, policy: str, model=None,
             kv_shards: int = 1) -> None:
        """Adopt (or verify) the serving binding: a cache never serves two
        policies, chunk sizes or models, whose snapshots could not resume
        each other.  ``model`` is the params dict itself (engines sharing
        one cache share one parameter object); ``kv_shards`` the kv-head
        shards of its mesh."""
        if chunk != self.chunk:
            raise ValueError(f"cache built for chunk {self.chunk}, engine "
                             f"uses {chunk}")
        if self.policy not in (None, policy):
            raise ValueError(f"cache bound to policy {self.policy!r}, "
                             f"engine uses {policy!r}")
        if model is not None and self._model is not None \
                and self._model is not model:
            raise ValueError("cache bound to a different model's parameters"
                             ": snapshots computed under one set of weights "
                             "cannot serve another")
        if self._lru and kv_shards != self.kv_shards:
            raise ValueError(f"cache holds snapshots of {self.kv_shards} "
                             f"kv-head shards, engine serves {kv_shards}")
        self.policy = policy
        self.kv_shards = kv_shards
        if model is not None:
            self._model = model

    # -- lookup / pinning ------------------------------------------------
    def lookup(self, prompt: np.ndarray,
               capacity: Optional[int] = None) -> Optional[PrefixEntry]:
        """Deepest cached chunk-aligned prefix of ``prompt`` (token-exact),
        or None.  With ``capacity``, only entries streamed under that
        KV-buffer depth match, the condition for a bitwise resume.
        Touches the hit chain's LRU recency; the caller pins the entry
        with ``acquire`` while it resumes."""
        prompt = np.asarray(prompt)
        node, pos = self._root, 0
        best: Optional[PrefixEntry] = None
        while pos < len(prompt):
            child = node.children.get(int(prompt[pos]))
            if child is None:
                break
            m = _common_len(child.edge, prompt[pos:])
            if m < len(child.edge):
                break  # a partial edge: no entry sits mid-edge
            pos += m
            node = child
            if node.entry is not None and (
                    capacity is None or node.entry.src_capacity == capacity):
                best = node.entry
        if best is None:
            self.misses += 1
            return None
        self.hits += 1
        self.tokens_hit += best.depth
        e = best
        while e is not None:  # the whole chain was used
            self._lru.move_to_end(e)
            e = e.parent
        return best

    def acquire(self, entry: PrefixEntry) -> None:
        """Pin ``entry`` (and, through child refs, its chain)."""
        entry.refs += 1

    def release(self, entry: PrefixEntry) -> None:
        assert entry.refs > 0, "refcount underflow"
        entry.refs -= 1

    # -- insert ----------------------------------------------------------
    def insert(
        self,
        prefix: np.ndarray,  # the first ``depth`` prompt tokens
        *,
        state: tf.ChunkState,  # streaming state with pos >= len(prefix)
        logits: torch.Tensor,  # (1, V) the boundary chunk's logits
        parent: Optional[PrefixEntry] = None,  # the request's current tip
    ) -> Optional[PrefixEntry]:
        """Cache the chunk boundary at ``len(prefix)``.  Returns the entry
        (existing or new, unpinned: the caller pins it), or None when the
        byte budget (or, pool-backed, the pool) cannot take it or the
        boundary is cached for another KV-buffer depth than ``state``'s.
        The span and the score state are copied out of ``state``, whose
        buffers the donor goes on writing in place."""
        prefix = np.asarray(prefix)
        depth = len(prefix)
        src_capacity = state.k.shape[2]
        assert depth > 0 and depth % self.chunk == 0, \
            "only whole-chunk prefixes are cacheable"
        assert parent is None or parent.src_capacity == src_capacity, \
            "chain would mix KV-buffer depths"
        node = self._insert_node(prefix)
        if node.entry is not None:
            if node.entry.src_capacity != src_capacity:
                return None  # boundary owned by another depth's snapshot
            self._lru.move_to_end(node.entry)
            return node.entry
        start = parent.depth if parent is not None else 0
        score = state.score.snapshot(depth)
        if self.pool is not None:
            nblk = (depth - start) // self.pool.block_size
            entry = PrefixEntry(depth=depth, start=start, parent=parent,
                                score=score, logits=logits, node=node,
                                src_capacity=src_capacity,
                                kv_shards=self.kv_shards)
            entry.nbytes += nblk * self.pool.block_bytes
            if not self._make_room(entry.nbytes):
                self._prune_node(node)
                return None
            ids = self.pool.alloc(nblk)
            if ids is None:
                # within budget, but live decode caches hold the pool:
                # running traffic outranks cached prefixes
                self._prune_node(node)
                return None
            self.pool.write_span(state.k[:, :, start:depth],
                                 state.v[:, :, start:depth], ids)
            self.pool.note_pinned(nblk)
            entry.blocks = ids
        else:
            entry = PrefixEntry(
                depth=depth, start=start, parent=parent, score=score,
                logits=logits, node=node, src_capacity=src_capacity,
                k_block=state.k[:, :, start:depth].clone(),
                v_block=state.v[:, :, start:depth].clone(),
                kv_shards=self.kv_shards)
            if not self._make_room(entry.nbytes):
                self._prune_node(node)  # drop the entry-less leaf made
                return None
        node.entry = entry
        if parent is not None:
            parent.refs += 1
        self._lru[entry] = None
        self.bytes += entry.nbytes
        self.inserts += 1
        return entry

    def _insert_node(self, tokens: np.ndarray) -> _Node:
        """Walk or extend the trie to the node ending exactly at
        ``tokens``, splitting edges as needed."""
        node, pos = self._root, 0
        while pos < len(tokens):
            first = int(tokens[pos])
            child = node.children.get(first)
            if child is None:
                new = _Node(tokens[pos:].copy(), len(tokens), node)
                node.children[first] = new
                return new
            m = _common_len(child.edge, tokens[pos:])
            if m == len(child.edge):
                pos += m
                node = child
                continue
            # split the edge where the tokens diverge (or end)
            split = _Node(child.edge[:m].copy(), node.depth + m, node)
            child.edge = child.edge[m:]
            child.parent = split
            split.children[int(child.edge[0])] = child
            node.children[first] = split
            pos += m
            node = split
        return node

    # -- eviction --------------------------------------------------------
    def _protected_bytes(self) -> int:
        """Bytes eviction cannot reclaim right now: entries with an
        in-flight pin and their ancestor chains (child refs alone cascade
        away once the leaves go; pins do not)."""
        children: dict[int, int] = {}
        for e in self._lru:
            if e.parent is not None:
                children[id(e.parent)] = children.get(id(e.parent), 0) + 1
        protected: set[int] = set()
        for e in self._lru:
            if e.refs > children.get(id(e), 0):  # at least one pin
                a: Optional[PrefixEntry] = e
                while a is not None and id(a) not in protected:
                    protected.add(id(a))
                    a = a.parent
        return sum(e.nbytes for e in self._lru if id(e) in protected)

    def _make_room(self, need: int) -> bool:
        if self.bytes + need <= self.max_bytes:
            return True
        # refuse before evicting anything, so that a doomed insert cannot
        # churn cached prefixes it gains nothing from
        if self._protected_bytes() + need > self.max_bytes:
            return False
        while self.bytes + need > self.max_bytes:
            if not self._evict_one():
                return False
        return True

    def _evict_one(self) -> bool:
        for entry in self._lru:  # least recently used first
            if entry.refs == 0:
                self._remove(entry)
                return True
        return False

    def _remove(self, entry: PrefixEntry) -> None:
        assert entry.refs == 0, "evicting a pinned or parented entry"
        del self._lru[entry]
        self.bytes -= entry.nbytes
        self.evictions += 1
        entry.node.entry = None
        if entry.blocks is not None:  # the pinned run back to the pool
            self.pool.free(entry.blocks)
            self.pool.note_pinned(-len(entry.blocks))
            entry.blocks = None
        if entry.parent is not None:
            self.release(entry.parent)
        self._prune_node(entry.node)

    # -- pool reclaim (paged serving) -------------------------------------
    def evictable_pool_blocks(self) -> int:
        """Pool blocks reclaimable right now (unpinned childless entries);
        an underestimate, since evicting a leaf can free its parent, which
        only makes the admission gate conservative."""
        if self.pool is None:
            return 0
        return sum(len(e.blocks) for e in self._lru
                   if e.refs == 0 and e.blocks is not None)

    def evict_pool_blocks(self, need: int) -> bool:
        """Evict LRU unpinned entries until at least ``need`` pool blocks
        went back to the free list (cascading up freed chains).  True iff
        the need was met: live traffic calls this when the pool runs dry,
        so cached prefixes yield to admissions."""
        if self.pool is None:
            return False
        freed = 0
        while freed < need:
            victim = next((e for e in self._lru
                           if e.refs == 0 and e.blocks is not None), None)
            if victim is None:
                return False
            freed += len(victim.blocks)
            self._remove(victim)
        return True

    @staticmethod
    def _prune_node(node: _Node) -> None:
        """Drop trie nodes left with no entry and no children, after an
        eviction and after a refused insert alike."""
        while (node.parent is not None and node.entry is None
               and not node.children):
            del node.parent.children[int(node.edge[0])]
            node = node.parent

    # -- materialization -------------------------------------------------
    @staticmethod
    def _chain(entry: PrefixEntry) -> list:
        chain = []
        e: Optional[PrefixEntry] = entry
        while e is not None:
            chain.append(e)
            e = e.parent
        chain.reverse()
        return chain

    def materialize(self, entry: PrefixEntry, capacity: int
                    ) -> tuple[tf.ChunkState, torch.Tensor]:
        """A resumable ``ChunkState`` (new ``capacity``-deep buffers,
        ``pos = entry.depth``) rebuilt from the entry's chain, and the
        boundary logits (the next-token distribution when the prompt is
        exactly the cached prefix).  Pool-backed, the prefix is one gather
        of the chain's block ids in depth order; dense, one concatenation
        of its spans.  Both are exact copies, so the state is bitwise the
        streamed one."""
        chain = self._chain(entry)
        if self.pool is not None:
            ids = np.concatenate([c.blocks for c in chain])
            idx = torch.as_tensor(ids, dtype=torch.long,
                                  device=self.pool.device)

            def flat(x):  # (L, n, bs, KV, hd) -> (L, 1, n * bs, KV, hd)
                return x.reshape((x.shape[0], 1, -1) + tuple(x.shape[3:]))

            k, v = flat(self.pool.k[:, idx]), flat(self.pool.v[:, idx])
        else:
            k = torch.cat([c.k_block for c in chain], dim=2)
            v = torch.cat([c.v_block for c in chain], dim=2)
        snap = tf.ChunkState(k=k, v=v, score=entry.score, pos=entry.depth)
        return tf.resume_chunk_state(snap, capacity), entry.logits

    # -- observability ---------------------------------------------------
    def stats(self) -> dict:
        total = self.hits + self.misses
        pool_blocks = (sum(len(e.blocks) for e in self._lru
                           if e.blocks is not None)
                       if self.pool is not None else 0)
        return {
            "entries": len(self._lru),
            "pool_blocks_pinned": pool_blocks,
            "materialize_programs": 0,  # eager: nothing compiled
            "bytes": self.bytes,
            "max_bytes": self.max_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "tokens_hit": self.tokens_hit,
        }

    def bind_metrics(self, registry) -> None:
        """Mirror ``stats()`` as ``prefix_cache_*`` callback gauges on the
        engine's registry (collection-time reads, no hot-path writes)."""
        bind_stat_gauges(registry, "prefix_cache", self.stats)
