"""Pure-NumPy reference for the generalised geodesic distance transform
(the port's own copy of ``repro.gdt.reference``, which ``repro_torch``
may not import).

Semantics (shared contract with ``repro_torch.kernels.ops.gdt`` — the
acceptance oracle of the subsystem, and the float64 oracle of the
port's tests, since the JAX package computes float64 as float32): over
the 8-connected neighbourhood with the additive DTOCS-style cost

    w(p, q) = 1 + lamb * |I(p) - I(q)|

the distance plane is the least fixpoint of the relaxation

    D'(p) = min(D(p), min_q D(q) + w(p, q))

from the soft-seed initialisation ``D0 = nu * (1 - clip(S, 0, 1))``.

Bit-exactness across schedules is not an accident: every value the
relaxation ever assigns is the *left-fold* float sum of one seed value
plus the edge weights along some path, float ``min`` is exact, and
float ``+`` is monotone in each argument — so any schedule that runs to
fixpoint (Jacobi here, the wavefront requeue scheduler, the raster
sweeps) lands on the same bits: the minimum fold-cost over all paths.
That is why the tests can require bit-equality rather than tolerances.

``lamb = 0`` makes every edge weight exactly 1, so the fixpoint is the
Chebyshev (L∞) distance to the seed set, capped at ``nu`` — the bridge
to the L1 QDT on binary images (see ``tests/test_torch_gdt.py``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["gdt_reference"]

#: Neighbour offsets of the 8-connected (Chebyshev) neighbourhood.
_OFFSETS = tuple(
    (dy, dx)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if (dy, dx) != (0, 0)
)


def _shift(x: np.ndarray, dy: int, dx: int, fill) -> np.ndarray:
    """x translated by (dy, dx) with out-of-image cells set to ``fill``."""
    out = np.full_like(x, fill)
    h, w = x.shape
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = x[ys, xs]
    return out


def gdt_reference(image, seeds, lamb: float = 1.0,
                  nu: float = 1e6) -> np.ndarray:
    """Jacobi-iterated fixpoint of the generalised geodesic relaxation.

    ``image``: (H, W) float array (the grey-weight field).  ``seeds``:
    (H, W) float array, clipped to [0, 1] (1 = seed, 0 = unseeded; soft
    values interpolate the initial plateau).  Returns the distance
    plane in ``image``'s dtype.
    """
    img = np.asarray(image)
    if img.dtype.kind != "f":
        raise TypeError(
            f"gdt_reference: image must be floating, got {img.dtype}"
        )
    dtype = img.dtype
    s = np.clip(np.asarray(seeds).astype(dtype), 0.0, 1.0)
    if img.shape != s.shape or img.ndim != 2:
        raise ValueError(
            f"gdt_reference: image {img.shape} and seeds {s.shape} must "
            "be matching 2-D arrays"
        )
    lamb = float(lamb)
    d = (nu * (1.0 - s)).astype(dtype)

    inf = dtype.type(np.inf)
    # Pre-shift the constant planes once; the image pads with 0 so the
    # weight term stays finite at the border (the +inf distance pad is
    # what actually kills border candidates).
    d_fills = [inf] * len(_OFFSETS)
    if lamb == 0.0:
        # static branch: the weight is the constant 1 (and 0 * |ΔI|
        # never meets a padded operand)
        weights = [dtype.type(1.0)] * len(_OFFSETS)
    else:
        weights = [
            1.0 + lamb * np.abs(img - _shift(img, dy, dx, 0.0))
            for dy, dx in _OFFSETS
        ]

    while True:
        cand = d
        for (dy, dx), w, fill in zip(_OFFSETS, weights, d_fills):
            cand = np.minimum(cand, _shift(d, dy, dx, fill) + w)
        cand = cand.astype(dtype)
        if np.array_equal(cand, d):
            return d
        d = cand
