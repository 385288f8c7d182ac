"""Synthetic test images for the morphology benchmarks (a copy of
``repro.data.images``, NumPy only).

The paper uses USC-SIPI Male/Airport/Airplane (offline here); these
generators produce images with the same *morphological* statistics that
drive the operators' run time: smooth background + blobs (regional
maxima for HMAX/DOME), basins (HFILL), border-touching structures
(RAOBJ), and multi-scale granularity (granulometry/ASF).
"""
from __future__ import annotations

import numpy as np


def _to_dtype(img01: np.ndarray, dtype) -> np.ndarray:
    dtype = np.dtype(dtype)
    if np.issubdtype(dtype, np.integer):
        hi = np.iinfo(dtype).max
        return np.clip(img01 * hi, 0, hi).astype(dtype)
    return img01.astype(dtype)


def blobs(h: int, w: int, dtype=np.uint8, n: int = 60, seed: int = 0):
    """Smooth background + Gaussian bumps of mixed scales ("Male"-like)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 0.3 + 0.2 * np.sin(2 * np.pi * xx / w) * np.cos(2 * np.pi * yy / h)
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        sig = rng.uniform(1.5, min(h, w) / 12)
        amp = rng.uniform(0.1, 0.6)
        img += amp * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2)
                              / (2 * sig**2)))
    img = (img - img.min()) / (img.max() - img.min() + 1e-12)
    return _to_dtype(img, dtype)


def basins(h: int, w: int, dtype=np.uint8, n: int = 40, seed: int = 1):
    """Inverted blobs: regional minima, for hole filling."""
    img = blobs(h, w, np.float64, n, seed)
    img = img.max() - img
    img = (img - img.min()) / (img.max() - img.min() + 1e-12)
    return _to_dtype(img, dtype)


def border_objects(h: int, w: int, dtype=np.uint8, seed: int = 2):
    """Structures touching the border, for RAOBJ ("Airplane"-like)."""
    rng = np.random.default_rng(seed)
    img = blobs(h, w, np.float64, 30, seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for side in range(4):
        c = rng.uniform(0.2, 0.8)
        sig = rng.uniform(h / 16, h / 6)
        if side == 0:
            img += 0.7 * np.exp(-((yy - 0) ** 2 + (xx - c * w) ** 2)
                                / (2 * sig**2))
        elif side == 1:
            img += 0.7 * np.exp(-((yy - h) ** 2 + (xx - c * w) ** 2)
                                / (2 * sig**2))
        elif side == 2:
            img += 0.7 * np.exp(-((yy - c * h) ** 2 + xx**2) / (2 * sig**2))
        else:
            img += 0.7 * np.exp(-((yy - c * h) ** 2 + (xx - w) ** 2)
                                / (2 * sig**2))
    img = (img - img.min()) / (img.max() - img.min() + 1e-12)
    return _to_dtype(img, dtype)
