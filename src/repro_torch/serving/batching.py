"""Prompt-length buckets of the bucket-padded engine (``BucketedEngine``).

The JAX package's ``serving/batching.py`` holds two things: the bucket
helpers below, which decide how prompts are grouped and padded, and the
compile caches (``ChunkCompileCache``, ``PrefillCompileCache``), which
cache jitted XLA programs per shape.  The port runs eagerly and compiles
nothing per shape, so it has no compile cache; the helpers are its own
copies, deprecated as in the JAX package (the chunked
``ContinuousEngine`` replaced the bucket ladder), with the public forms
warning and the private ones, which ``BucketedEngine`` uses, silent.
"""

from __future__ import annotations

import warnings

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024)


def _warn_bucketed(what: str) -> None:
    warnings.warn(
        f"{what} is deprecated: chunked prefill (the chunked "
        "ContinuousEngine) replaced the bucket ladder; the bucketed "
        "utilities remain only so BucketedEngine can serve as a benchmark "
        "baseline", DeprecationWarning, stacklevel=3)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return next_pow2(n)


def _batch_bucket(n: int, cap: int) -> int:
    if n <= 0 or cap <= 0:
        raise ValueError(f"batch_bucket needs n > 0 and cap > 0, got {n} "
                         f"and {cap}")
    return min(next_pow2(n), cap)


def _pad_to_bucket(prompts: list, bucket: int, batch: int, *,
                   pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    if len(prompts) > batch:
        raise ValueError(f"{len(prompts)} prompts exceed the batch {batch}")
    tokens = np.full((batch, bucket), pad_id, np.int32)
    lens = np.full((batch,), bucket, np.int32)
    for i, p in enumerate(prompts):
        n = len(p)
        if n > bucket:
            raise ValueError(f"prompt len {n} exceeds bucket {bucket}")
        tokens[i, :n] = p
        lens[i] = n
    return tokens, lens


def bucket_for(n: int, buckets=DEFAULT_BUCKETS) -> int:
    """Deprecated.  Smallest configured bucket >= n; beyond the largest,
    the next power of two."""
    _warn_bucketed("bucket_for")
    return _bucket_for(n, buckets)


def batch_bucket(n: int, cap: int) -> int:
    """Deprecated.  Batch size for an n-request group: the next power of
    two, capped."""
    _warn_bucketed("batch_bucket")
    return _batch_bucket(n, cap)


def pad_to_bucket(prompts: list, bucket: int, batch: int, *,
                  pad_id: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deprecated.  Right-pad prompts to ``bucket`` and the group to
    ``batch`` rows.  Returns (tokens (batch, bucket) int32, lens (batch,)
    int32); dummy rows carry lens == bucket, and their outputs are
    discarded by the caller."""
    _warn_bucketed("pad_to_bucket")
    return _pad_to_bucket(prompts, bucket, batch, pad_id=pad_id)
