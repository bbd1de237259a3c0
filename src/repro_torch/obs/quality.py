"""Streaming lookahead drift monitor and the shared kept-set machinery:
the JAX package's ``obs/quality.py`` on the port's objective.

The serving predictor (trained lookahead modules) is distilled offline;
its quality on *live* traffic can drift as the workload shifts.
``DriftMonitor`` turns the engine's retirement hook into a streaming
quality signal:

1. retired requests are sampled into a small held-out ring; each
   carries its prompt ``x`` and the *generated continuation* ``y``, the
   very future the gt_oracle needs (as ``data/harvest.py`` uses it);
2. every ``eval_every`` sampled retirements the ring is re-scored: the
   frozen model's oracle pass over ``[x; y]`` (``objective.gt_scores``)
   against the serving predictor's scores of ``x``
   (``objective.predictor_scores``);
3. the mean per-(layer, head) top-``budget`` kept-set overlap lands in
   the ``lookahead_drift_overlap`` gauge.

Both passes run under ``torch.no_grad()`` through the device dispatch,
so on the card each is one monolithic prefill on kernels 7 and 3.  The
port runs eagerly, so the JAX monitor's per-length jit caches have no
counterpart.  ``head_kept_sets`` / ``kept_overlaps`` work on host numpy
arrays with the JAX package's ``np.argsort`` call, so identical score
arrays give identical sets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import objective

__all__ = ["head_kept_sets", "kept_overlaps", "DriftMonitor"]


def head_kept_sets(scores, budget: int) -> dict:
    """Per-(layer, head) top-``budget`` kept set of a raw score tensor
    (L, H, n): the predictor's selection before GQA pooling, the
    quantity the distillation objective trains."""
    return {(l, h): set(np.argsort(-scores[l, h])[:budget].tolist())
            for l in range(scores.shape[0])
            for h in range(scores.shape[1])}


def kept_overlaps(pred_scores, gt_scores, budget: int) -> list[float]:
    """Per-(layer, head) kept-set overlap fractions between a predictor's
    raw scores and the oracle's, both (L, H, n)."""
    gt_sets = head_kept_sets(gt_scores, budget)
    sets = head_kept_sets(pred_scores, budget)
    return [len(sets[key] & g) / budget for key, g in gt_sets.items()]


class DriftMonitor:
    """Streaming predictor-quality monitor riding the retirement hook.

    Construct with the frozen model and the *serving* predictor (dicts of
    tensors on one device), hand it to ``ServingConfig.drift``; the
    engine calls ``on_retire`` per retired request and ``bind`` at init
    to attach its metrics registry / tracer.  ``evaluate()`` can also be
    called directly and returns the overlap, or None with an empty ring.

    Scoring runs on the engine thread, so size ``ring_size`` /
    ``eval_every`` to the overhead budget.  Requests whose prompt is
    within ``budget`` tokens are skipped: their kept set is the whole
    prompt and the overlap would be vacuously 1.
    """

    def __init__(self, params: dict, cfg, lkv_params: dict, *,
                 budget: int, ring_size: int = 16, sample_every: int = 1,
                 eval_every: int = 8, max_obs: int = 16, min_obs: int = 1):
        assert ring_size >= 1 and sample_every >= 1 and eval_every >= 1
        self.params, self.cfg, self.lkv_params = params, cfg, lkv_params
        self.budget = budget
        self.ring_size = ring_size
        self.sample_every = sample_every
        self.eval_every = eval_every
        self.max_obs = max_obs
        self.min_obs = min_obs
        self._ring: list[tuple[np.ndarray, np.ndarray]] = []
        self._ring_pos = 0
        self._retired = 0
        self._sampled_since_eval = 0
        self.last_overlap: Optional[float] = None
        self.evals = 0
        self.samples = 0
        # the registry's two counters, not the registry: its gauges call
        # back into the monitor, and a reference back to the registry
        # would hold the monitor (and the model) in a reference cycle
        self._samples_counter = self._evals_counter = None
        self._trace = None

    # -- engine wiring -------------------------------------------------------
    def bind(self, metrics=None, trace=None) -> None:
        """Attach the engine's registry (gauge + counters) and tracer
        (a ``drift_eval`` span per evaluation on the engine track)."""
        self._trace = trace
        if metrics is not None:
            g = metrics.gauge(
                "lookahead_drift_overlap",
                "Mean per-(layer, head) oracle kept-set overlap of the "
                "serving predictor over the held-out ring of sampled "
                "retired requests (1.0 = predictor keeps exactly the "
                "oracle set; falling values signal drift).")
            g.set_fn(lambda: (self.last_overlap
                              if self.last_overlap is not None else -1.0))
            metrics.gauge(
                "lookahead_drift_ring",
                "Retired requests currently held in the drift ring."
            ).set_fn(lambda: len(self._ring))
            self._samples_counter = metrics.counter(
                "lookahead_drift_samples",
                "Retired requests sampled into the drift ring.")
            self._evals_counter = metrics.counter(
                "lookahead_drift_evals",
                "Drift evaluations performed (ring re-scorings).")

    def on_retire(self, req) -> None:
        """Engine retirement hook: sample, then periodically evaluate."""
        self._retired += 1
        if (self._retired - 1) % self.sample_every:
            return
        y = np.asarray(req.out_tokens[: self.max_obs], np.int32)
        x = np.asarray(req.prompt, np.int32)
        if y.size < self.min_obs or len(x) <= self.budget:
            return
        self.observe(x, y)
        if self._sampled_since_eval >= self.eval_every:
            self.evaluate()

    def observe(self, x: np.ndarray, y: np.ndarray) -> None:
        """Insert one (prompt, generated-future) record into the ring."""
        rec = (np.asarray(x, np.int32), np.asarray(y, np.int32))
        if len(self._ring) < self.ring_size:
            self._ring.append(rec)
        else:
            self._ring[self._ring_pos] = rec
            self._ring_pos = (self._ring_pos + 1) % self.ring_size
        self.samples += 1
        self._sampled_since_eval += 1
        if self._samples_counter is not None:
            self._samples_counter.inc()

    # -- scoring ---------------------------------------------------------------
    def _tokens(self, seq: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(seq, device=self.params["embed"].device)[None]

    def gt_head_scores(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """(L, H, n_in) f32 oracle scores of ``x``'s keys under ``y``'s
        real queries (``HarvestWriter.gt_record``'s pass)."""
        s = objective.gt_scores(self.params, self.cfg,
                                self._tokens(np.concatenate([x, y])), len(x))
        return s[:, 0].float().cpu().numpy()  # (L, 1, H, n_in) -> (L, H, n)

    def pred_head_scores(self, x: np.ndarray) -> np.ndarray:
        """(L, H, n_in) f32 serving-predictor scores of ``x``'s keys."""
        s = objective.predictor_scores(self.params, self.cfg,
                                       self.lkv_params, self._tokens(x))
        return s[:, 0].float().cpu().numpy()

    # -- evaluation ----------------------------------------------------------
    def evaluate(self) -> Optional[float]:
        """Re-score the ring; returns (and gauges) the mean overlap."""
        self._sampled_since_eval = 0
        if not self._ring:
            return None
        tr = self._trace
        if tr is not None:
            tr.begin("drift_eval", tr.ENGINE, records=len(self._ring))
        ovs: list[float] = []
        for x, y in self._ring:
            gt = self.gt_head_scores(x, y)
            pred = self.pred_head_scores(x)
            ovs.extend(kept_overlaps(pred, gt, self.budget))
        self.last_overlap = float(np.mean(ovs))
        self.evals += 1
        if self._evals_counter is not None:
            self._evals_counter.inc()
        if tr is not None:
            tr.end("drift_eval", tr.ENGINE,
                   overlap=self.last_overlap)
        return self.last_overlap
