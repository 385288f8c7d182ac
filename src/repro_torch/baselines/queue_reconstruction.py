"""Hierarchical-queue grayscale reconstruction (Vincent 1993 [28]; a copy
of ``repro.baselines.queue_reconstruction``, NumPy only) —
SMIL's single-threaded reconstruction algorithm, used by the paper as
the near-parameter-insensitive baseline (§4.5, Table 5 footnote).

Hybrid algorithm: raster + anti-raster sweep, then FIFO-queue
propagation.  Serves as an independent correctness oracle for
``kernels.ops.reconstruct`` (it shares no code with the jnp/Pallas
paths) and as the baseline timing for the operator benchmarks.
"""
from __future__ import annotations

from collections import deque

import numpy as np

_N_MINUS = ((-1, -1), (-1, 0), (-1, 1), (0, -1))   # raster predecessors
_N_PLUS = ((1, 1), (1, 0), (1, -1), (0, 1))        # anti-raster predecessors
_N_ALL = _N_MINUS + _N_PLUS


def dilate_reconstruct(marker: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """δ_rec: grayscale reconstruction by dilation, marker ≤ mask."""
    f = marker.copy()
    h, w = f.shape

    # raster scan
    for y in range(h):
        for x in range(w):
            v = f[y, x]
            for dy, dx in _N_MINUS:
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w and f[ny, nx] > v:
                    v = f[ny, nx]
            f[y, x] = min(v, mask[y, x])

    # anti-raster scan + queue seeding
    fifo: deque[tuple[int, int]] = deque()
    for y in range(h - 1, -1, -1):
        for x in range(w - 1, -1, -1):
            v = f[y, x]
            for dy, dx in _N_PLUS:
                ny, nx = y + dy, x + dx
                if 0 <= ny < h and 0 <= nx < w and f[ny, nx] > v:
                    v = f[ny, nx]
            f[y, x] = min(v, mask[y, x])
            for dy, dx in _N_PLUS:
                ny, nx = y + dy, x + dx
                if (
                    0 <= ny < h
                    and 0 <= nx < w
                    and f[ny, nx] < f[y, x]
                    and f[ny, nx] < mask[ny, nx]
                ):
                    fifo.append((y, x))
                    break

    # propagation
    while fifo:
        y, x = fifo.popleft()
        for dy, dx in _N_ALL:
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w:
                if f[ny, nx] < f[y, x] and mask[ny, nx] != f[ny, nx]:
                    f[ny, nx] = min(f[y, x], mask[ny, nx])
                    fifo.append((ny, nx))
    return f


def erode_reconstruct(marker: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """ε_rec via duality: ε_rec(f, m) = -δ_rec(-f, -m) on the inverted
    lattice (complement within the dtype range for unsigned ints)."""
    if np.issubdtype(marker.dtype, np.unsignedinteger):
        top = np.iinfo(marker.dtype).max
        return top - dilate_reconstruct(top - marker, top - mask)
    return -dilate_reconstruct(-marker, -mask)
