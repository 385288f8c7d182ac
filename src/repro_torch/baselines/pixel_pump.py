"""Pixel pump (a copy of ``repro.baselines.pixel_pump``, NumPy only): the
queue-based single-pass streaming erosion/dilation of
Dokládal & Dokladalova (2011) [10] — the paper's principal streaming
competitor, reimplemented from the published pseudo-code.

A monotone deque per 1-D scan keeps (value, position) pairs with strictly
increasing values (erosion); each pixel is pushed/popped at most once ⇒
O(1) amortized comparisons per pixel, independent of window size, with
(w+1)-deep queues — the properties the paper cites (Table 3).

This is deliberately *scalar* Python/numpy: the paper notes the pixel
pump's throughput "remained consistent, due to the scalar processing"
(§4.3) — its algorithmic profile (ops/pixel, memory) is what the
benchmarks compare; wall-clock comparisons against it are reported
separately from the same-substrate jnp baselines (EXPERIMENTS.md).
"""
from __future__ import annotations

from collections import deque

import numpy as np


def _pump_1d(row: np.ndarray, w: int, op: str) -> np.ndarray:
    """Sliding min/max of window ``w`` anchored so output is centered,
    with border-clipped semantics (windows truncated at the edges)."""
    n = row.shape[0]
    s = w // 2
    out = np.empty_like(row)
    better = (lambda a, b: a <= b) if op == "erode" else (lambda a, b: a >= b)
    q: deque[tuple[int, np.generic]] = deque()  # (position, value), monotone
    for i in range(n + s):
        if i < n:
            v = row[i]
            while q and better(v, q[-1][1]):
                q.pop()
            q.append((i, v))
        if i >= s:
            # output position i - s; window = [i-2s, i] clipped
            while q and q[0][0] < i - 2 * s:
                q.popleft()
            out[i - s] = q[0][1]
    return out


def minmax_filter(f: np.ndarray, s: int, op: str = "erode") -> np.ndarray:
    """(2s+1)×(2s+1) erosion/dilation, separable pixel pump."""
    if s == 0:
        return f.copy()
    w = 2 * s + 1
    tmp = np.empty_like(f)
    for y in range(f.shape[0]):
        tmp[y] = _pump_1d(f[y], w, op)
    out = np.empty_like(f)
    for x in range(f.shape[1]):
        out[:, x] = _pump_1d(tmp[:, x], w, op)
    return out


def erode(f: np.ndarray, s: int) -> np.ndarray:
    return minmax_filter(f, s, "erode")


def dilate(f: np.ndarray, s: int) -> np.ndarray:
    return minmax_filter(f, s, "dilate")


def chain(f: np.ndarray, n: int, op: str = "erode") -> np.ndarray:
    """A chain of n elementary 3×3 filters, each a full pixel-pump pass —
    how a filter-size-insensitive method executes the paper's workload."""
    for _ in range(n):
        f = minmax_filter(f, 1, op)
    return f
