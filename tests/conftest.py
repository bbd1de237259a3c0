"""Shared test utilities.

No ``hypothesis`` offline — ``sweep_cases`` provides seeded random shape
sweeps with the same spirit: each property test runs across a randomized
family of shapes/dtypes and any failure prints the exact case for replay.
"""

import numpy as np
import pytest


def sweep_cases(seed: int, n: int, gen):
    """Deterministic pseudo-random case list: gen(rng) -> case dict."""
    rng = np.random.default_rng(seed)
    return [gen(rng) for _ in range(n)]


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips where CUDA is absent)")
