"""Synthetic (X, Y) training/eval pipeline.

No external datasets exist offline, so we mirror the *structure* of the
paper's mixture (instruction pairs + pretraining completions + few-shot
completions, §4.1) with procedurally generated token tasks whose ground-truth
dependency structure is known:

* ``needle``  — a (key, value) pair is planted at a random depth in filler
  text; the prompt ends with the key; the correct continuation is the value.
  End-task accuracy after eviction is measurable exactly (RULER-style).
* ``copy``    — the prompt contains a delimited span to be echoed.
* ``completion`` — plain random-walk "text"; Y is generated *by the target
  model itself* (greedy, or sampled at a temperature above 0 on the JAX
  package's random stream), as the paper generates its training
  responses.

All batches are fixed-shape (n_in, n_out).  Vocabulary layout: ids
[0, reserved) are structural markers; the rest is filler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig

RESERVED = 16
MARK_KEY = 1  # precedes the needle key
MARK_QUERY = 2  # precedes the final query
MARK_COPY_L = 3
MARK_COPY_R = 4


@dataclass(frozen=True)
class Batch:
    x: np.ndarray  # (B, n_in) int32 prompts
    y: np.ndarray  # (B, n_out) int32 responses (model-generated or synthetic)
    answer_pos: Optional[np.ndarray] = None  # (B, span) prompt positions that
    # a correct continuation must attend to (needle/copy tasks); None for
    # completion data.


def _filler(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    return rng.integers(RESERVED, vocab, size=shape, dtype=np.int64)


def make_needle_batch(
    rng: np.random.Generator, batch: int, n_in: int, vocab: int,
    *, key_len: int = 4, val_len: int = 8,
) -> Batch:
    """[filler... MARK_KEY k v ...filler... MARK_QUERY k] -> answer = v."""
    x = _filler(rng, (batch, n_in), vocab)
    span = key_len + val_len + 1
    tail = key_len + 1
    ans_pos = np.zeros((batch, val_len), np.int64)
    y = np.zeros((batch, val_len), np.int64)
    for b in range(batch):
        key = _filler(rng, key_len, vocab)
        val = _filler(rng, val_len, vocab)
        depth = rng.integers(0, max(n_in - span - tail - 1, 1))
        x[b, depth] = MARK_KEY
        x[b, depth + 1 : depth + 1 + key_len] = key
        x[b, depth + 1 + key_len : depth + span] = val
        x[b, n_in - tail] = MARK_QUERY
        x[b, n_in - key_len :] = key
        ans_pos[b] = np.arange(depth + 1 + key_len, depth + span)
        y[b] = val
    return Batch(x=x.astype(np.int32), y=y.astype(np.int32),
                 answer_pos=ans_pos.astype(np.int32))


def make_copy_batch(
    rng: np.random.Generator, batch: int, n_in: int, vocab: int,
    *, span_len: int = 16,
) -> Batch:
    """[filler [L span R] filler QUERY] -> answer = span."""
    x = _filler(rng, (batch, n_in), vocab)
    ans_pos = np.zeros((batch, span_len), np.int64)
    y = np.zeros((batch, span_len), np.int64)
    for b in range(batch):
        span = _filler(rng, span_len, vocab)
        depth = rng.integers(0, max(n_in - span_len - 4, 1))
        x[b, depth] = MARK_COPY_L
        x[b, depth + 1 : depth + 1 + span_len] = span
        x[b, depth + 1 + span_len] = MARK_COPY_R
        x[b, n_in - 1] = MARK_QUERY
        ans_pos[b] = np.arange(depth + 1, depth + 1 + span_len)
        y[b] = span
    return Batch(x=x.astype(np.int32), y=y.astype(np.int32),
                 answer_pos=ans_pos.astype(np.int32))


def make_completion_prompts(
    rng: np.random.Generator, batch: int, n_in: int, vocab: int,
) -> np.ndarray:
    """Structured pseudo-text: short Markov bursts (locally repeated motifs)
    so attention has non-trivial structure to learn."""
    x = np.empty((batch, n_in), np.int64)
    for b in range(batch):
        pos = 0
        while pos < n_in:
            motif_len = int(rng.integers(3, 12))
            reps = int(rng.integers(1, 4))
            motif = _filler(rng, motif_len, vocab)
            for _ in range(reps):
                take = min(motif_len, n_in - pos)
                x[b, pos : pos + take] = motif[:take]
                pos += take
                if pos >= n_in:
                    break
    return x.astype(np.int32)


class MixtureIterator:
    """Deterministic mixture stream matching the paper's recipe shape:
    instruction-style (needle/copy) + completion data, fixed (n_in, n_out).

    When ``gen_params`` are given, Y is generated by the target model
    (``policies.sample_decode`` at ``temperature``, keyed by
    ``PRNGKey`` of one draw of the stream, as the JAX package's) as in
    the paper; otherwise
    the synthetic answers (padded/truncated to n_out) are used — the
    paper's §D "source response" ablation setting.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        n_in: int,
        n_out: int,
        *,
        seed: int = 0,
        weights=(0.35, 0.25, 0.40),  # needle, copy, completion
        gen_params: Optional[dict] = None,
        temperature: float = 0.0,
    ):
        self.cfg, self.batch, self.n_in, self.n_out = cfg, batch, n_in, n_out
        self.rng = np.random.default_rng(seed)
        self.weights = weights
        self.gen_params = gen_params
        self.temperature = temperature
        self._gen = None
        if gen_params is not None:
            self._gen = _make_generator(cfg, n_out, temperature)

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        kind = self.rng.choice(3, p=self.weights)
        v = self.cfg.vocab_size
        if kind == 0:
            b = make_needle_batch(self.rng, self.batch, self.n_in, v)
        elif kind == 1:
            b = make_copy_batch(self.rng, self.batch, self.n_in, v)
        else:
            x = make_completion_prompts(self.rng, self.batch, self.n_in, v)
            b = Batch(x=x, y=np.zeros((self.batch, self.n_out), np.int32))
        if self._gen is not None:
            y = self._gen(self.gen_params, b.x,
                          int(self.rng.integers(1 << 31)))
            b = Batch(x=b.x, y=y.astype(np.int32), answer_pos=b.answer_pos)
        else:
            reps = -(-self.n_out // max(b.y.shape[1], 1))
            y = np.tile(b.y, (1, reps))[:, : self.n_out]
            b = Batch(x=b.x, y=y, answer_pos=b.answer_pos)
        return b


def _make_generator(cfg: ModelConfig, n_out: int, temperature: float):
    """Full-cache prefill, then ``n_out`` tokens from the target model (on
    the device of its parameters) through ``policies.sample_decode`` at
    ``temperature`` with the key ``PRNGKey(seed)``; host arrays in and
    out."""
    from repro_torch.core import policies
    from repro_torch.core.eviction import PRNGKey
    from repro_torch.models import transformer as tf

    def gen(params, x: np.ndarray, seed: int) -> np.ndarray:
        dev = params["embed"].device
        with torch.no_grad():
            res = tf.prefill(params, cfg, torch.as_tensor(x, device=dev),
                             policy="full", extra_slots=n_out + 1)
            toks, _ = policies.sample_decode(
                params, cfg, res.logits, res.cache, n_out,
                temperature=temperature, key=PRNGKey(seed))
        return toks.cpu().numpy()

    return gen


# ---------------------------------------------------------------------------
# Serving traces (prefix-shared traffic)
# ---------------------------------------------------------------------------


def make_prefix_trace(
    seed: int,
    n_requests: int,
    vocab: int,
    *,
    chunk: int = 128,
    n_prefixes: int = 3,
    prefix_chunks=(1, 2),
    suffix_lens=(0, 1, 77),
    zipf_a: float = 1.2,
    rate_hz: float = 200.0,
) -> list:
    """Seeded randomized serving trace with Zipf-shared prompt prefixes —
    the traffic shape prefix-aware KV reuse targets (shared system prompts
    / RAG headers with per-request suffixes).

    A pool of ``n_prefixes`` chunk-aligned prefixes (each a whole number of
    ``chunk`` tokens drawn from ``prefix_chunks``) is sampled once; each
    request picks a prefix with Zipf(``zipf_a``) popularity and appends a
    fresh suffix whose length is drawn from ``suffix_lens`` — 0 produces
    exact-duplicate prompts (full-hit candidates), lengths like 77 exercise
    partial final chunks.  Arrivals are Poisson at ``rate_hz`` (staggered,
    never simultaneous).

    Returns ``[(prompt int32 array, arrival_s float), ...]`` — serving-
    agnostic so benchmarks and the differential test harness share one
    generator.
    """
    rng = np.random.default_rng(seed)
    prefixes = [
        _filler(rng, int(rng.choice(prefix_chunks)) * chunk, vocab)
        .astype(np.int32)
        for _ in range(n_prefixes)
    ]
    ranks = np.arange(1, n_prefixes + 1, dtype=np.float64)
    p = ranks ** -zipf_a
    p /= p.sum()
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, n_requests))
    trace = []
    for i in range(n_requests):
        pre = prefixes[int(rng.choice(n_prefixes, p=p))]
        sl = int(rng.choice(suffix_lens))
        if sl:
            suf = _filler(rng, sl, vocab).astype(np.int32)
            prompt = np.concatenate([pre, suf])
        else:
            prompt = pre.copy()
        trace.append((prompt, float(arrivals[i])))
    return trace
