"""Analysis windows (host-side numpy constants), copied from
``tdoa_tpu.dsp.windows``: Blackman-Harris for the proper SNR estimator,
Hann in the fast analyzer and the FIR designs (``dsp/filters.py``)."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def hann(n: int) -> np.ndarray:
    if n <= 1:
        return np.ones(max(n, 1), np.float32)
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris."""
    if n <= 1:
        return np.ones(max(n, 1), np.float32)
    k = np.arange(n)
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    w = (
        a0
        - a1 * np.cos(2 * np.pi * k / (n - 1))
        + a2 * np.cos(4 * np.pi * k / (n - 1))
        - a3 * np.cos(6 * np.pi * k / (n - 1))
    )
    return w.astype(np.float32)
