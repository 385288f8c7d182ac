"""Elementary morphological operations (plain PyTorch) — the oracle layer.

Port of ``repro.core.morphology``.  Semantics follow the paper (Žlaus &
Mongus 2019, §2): the structuring element is clipped at the image
border, which equals padding with the dtype's lattice identity (+max
for erosion, -max for dilation) before the windowed reduction.

All functions take 2-D images ``(H, W)`` or stacks ``(..., H, W)`` and
are dtype-polymorphic (uint8/uint16/float32/float64 — the paper's
char/short/float/double).  min/max propagate NaN, as ``jnp.minimum``
does.  PyTorch implements neither min/max nor ordering comparisons for
``uint16`` on the CPU, so those widen to int32 and narrow back, which
is exact; equality tests compare the int16 bit view.
"""
from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# dtype lattice identities and uint16-safe elementwise primitives
# ---------------------------------------------------------------------------


def top_value(dtype: torch.dtype):
    """Identity for min as a Python number (the largest value)."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def bottom_value(dtype: torch.dtype):
    """Identity for max as a Python number (the smallest value)."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def lattice_top(dtype: torch.dtype) -> torch.Tensor:
    """Identity for min (the largest representable value)."""
    return torch.tensor(top_value(dtype), dtype=dtype)


def lattice_bottom(dtype: torch.dtype) -> torch.Tensor:
    """Identity for max (the smallest representable value)."""
    return torch.tensor(bottom_value(dtype), dtype=dtype)


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in a dtype PyTorch does arithmetic in: uint16 → int32 (through
    the int16 bit view, which every device converts)."""
    if x.dtype == torch.uint16:
        return x.view(torch.int16).to(torch.int32) & 0xFFFF
    return x


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`wide` for values that fit ``dtype``."""
    if dtype == torch.uint16:
        return x.to(torch.int16).view(torch.uint16)
    return x


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NaN-propagating elementwise min, uint16 included."""
    return narrow(torch.minimum(wide(a), wide(b)), a.dtype)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NaN-propagating elementwise max, uint16 included."""
    return narrow(torch.maximum(wide(a), wide(b)), a.dtype)


def select(cond: torch.Tensor, a: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """``where(cond, a, b)`` for same-dtype tensors, uint16 included."""
    if a.dtype == torch.uint16:
        out = torch.where(cond, a.view(torch.int16), b.view(torch.int16))
        return out.view(torch.uint16)
    return torch.where(cond, a, b)


def not_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a != b`` (True at NaN, as in jnp), uint16 included."""
    if a.dtype == torch.uint16:
        return a.view(torch.int16) != b.view(torch.int16)
    return a != b


# ---------------------------------------------------------------------------
# 1-D decomposed passes (paper Eq. 21-23): w1 = w1x ∘ w1y
# ---------------------------------------------------------------------------


def _shift(f: torch.Tensor, offset: int, axis: int, fill) -> torch.Tensor:
    """Shift ``f`` by ``offset`` along ``axis`` filling vacated entries."""
    n = f.shape[axis]
    k = min(abs(offset), n)
    slab_shape = list(f.shape)
    slab_shape[axis] = k
    slab = torch.full(slab_shape, fill, dtype=f.dtype, device=f.device)
    if offset > 0:
        return torch.cat([slab, f.narrow(axis, 0, n - k)], dim=axis)
    return torch.cat([f.narrow(axis, k, n - k), slab], dim=axis)


def erode1d(f: torch.Tensor, axis: int) -> torch.Tensor:
    """ε along one axis with the 3-element SE (clipped at borders)."""
    top, w = top_value(f.dtype), wide(f)
    return narrow(torch.minimum(
        w, torch.minimum(_shift(w, 1, axis, top), _shift(w, -1, axis, top))
    ), f.dtype)


def dilate1d(f: torch.Tensor, axis: int) -> torch.Tensor:
    """δ along one axis with the 3-element SE (clipped at borders)."""
    bot, w = bottom_value(f.dtype), wide(f)
    return narrow(torch.maximum(
        w, torch.maximum(_shift(w, 1, axis, bot), _shift(w, -1, axis, bot))
    ), f.dtype)


# ---------------------------------------------------------------------------
# elementary 3x3 filters (Eq. 1-2 with s=1, decomposed)
# ---------------------------------------------------------------------------


def erode3(f: torch.Tensor) -> torch.Tensor:
    """ε₁: 3×3 erosion = ε₁ˣ ∘ ε₁ʸ (4 comparisons/pixel, Eq. 23)."""
    return erode1d(erode1d(f, axis=-1), axis=-2)


def dilate3(f: torch.Tensor) -> torch.Tensor:
    """δ₁: 3×3 dilation = δ₁ˣ ∘ δ₁ʸ."""
    return dilate1d(dilate1d(f, axis=-1), axis=-2)


def _direct(f: torch.Tensor, fill, pick) -> torch.Tensor:
    w = wide(f)
    out = w
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            out = pick(out, _shift(_shift(w, dy, -2, fill), dx, -1, fill))
    return narrow(out, f.dtype)


def erode3_direct(f: torch.Tensor) -> torch.Tensor:
    """Non-decomposed 3×3 erosion (8 comparisons/px) — used only in tests
    to verify the decomposition identity Eq. 23."""
    return _direct(f, top_value(f.dtype), torch.minimum)


def dilate3_direct(f: torch.Tensor) -> torch.Tensor:
    return _direct(f, bottom_value(f.dtype), torch.maximum)


# ---------------------------------------------------------------------------
# size-s erosion/dilation as chains of ε₁/δ₁ (the paper's central object)
# ---------------------------------------------------------------------------


def erode(f: torch.Tensor, s: int) -> torch.Tensor:
    """ε_s(f) as a chain of s elementary erosions (paper Eq. 4 analogue).

    For the square SE, chaining s 3×3 erosions equals one (2s+1)² erosion.
    """
    for _ in range(s):
        f = erode3(f)
    return f


def dilate(f: torch.Tensor, s: int) -> torch.Tensor:
    for _ in range(s):
        f = dilate3(f)
    return f


# ---------------------------------------------------------------------------
# elementary geodesic filters (Eq. 3) and bounded-size geodesic (Eq. 4)
# ---------------------------------------------------------------------------


def geodesic_erode1(f: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """ε₁ᵐ(f) = max(ε₁(f), m).  Requires f ≥ m for the usual semantics."""
    return maximum(erode3(f), m)


def geodesic_dilate1(f: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """δ₁ᵐ(f) = min(δ₁(f), m).  Requires f ≤ m."""
    return minimum(dilate3(f), m)


def geodesic_erode(f: torch.Tensor, m: torch.Tensor, s: int) -> torch.Tensor:
    """ε_sᵐ(f): s-fold composition of ε₁ᵐ (Eq. 4)."""
    for _ in range(s):
        f = geodesic_erode1(f, m)
    return f


def geodesic_dilate(f: torch.Tensor, m: torch.Tensor,
                    s: int) -> torch.Tensor:
    for _ in range(s):
        f = geodesic_dilate1(f, m)
    return f


# ---------------------------------------------------------------------------
# reconstruction (Eq. 5): iterate to convergence
# ---------------------------------------------------------------------------


def _reconstruct(f, m, step, max_iters):
    """Host loop of ``repro.core.morphology._reconstruct``: the same
    iterate/compare sequence, one device→host read of the changed bit
    per elementary step."""
    x = step(f, m)
    it = 1
    changed = bool(not_equal(x, f).any())
    while changed and it < max_iters:
        nxt = step(x, m)
        changed = bool(not_equal(nxt, x).any())
        x = nxt
        it += 1
    return x, torch.tensor(it, dtype=torch.int32)


def _default_iters(f: torch.Tensor, max_iters):
    return f.shape[-1] * f.shape[-2] if max_iters is None else max_iters


def erode_reconstruct(
    f: torch.Tensor, m: torch.Tensor, max_iters: int | None = None
) -> torch.Tensor:
    """ε_recᵐ(f): erosion by reconstruction (Eq. 5); marker f, mask m,
    f ≥ m."""
    out, _ = _reconstruct(f, m, geodesic_erode1, _default_iters(f, max_iters))
    return out


def dilate_reconstruct(
    f: torch.Tensor, m: torch.Tensor, max_iters: int | None = None
) -> torch.Tensor:
    """δ_recᵐ(f): dilation by reconstruction. Marker f, mask m, f ≤ m."""
    out, _ = _reconstruct(f, m, geodesic_dilate1,
                          _default_iters(f, max_iters))
    return out


def erode_reconstruct_with_iters(f, m, max_iters=None):
    """Like erode_reconstruct but also returns the chain length used
    (the paper reports average chain lengths in Table 5)."""
    return _reconstruct(f, m, geodesic_erode1, _default_iters(f, max_iters))


def dilate_reconstruct_with_iters(f, m, max_iters=None):
    return _reconstruct(f, m, geodesic_dilate1, _default_iters(f, max_iters))


# ---------------------------------------------------------------------------
# opening / closing (Eq. 16, 19)
# ---------------------------------------------------------------------------


def opening(f: torch.Tensor, s: int) -> torch.Tensor:
    """γ_s(f) = δ_s(ε_s(f))."""
    return dilate(erode(f, s), s)


def closing(f: torch.Tensor, s: int) -> torch.Tensor:
    """φ_s(f) = ε_s(δ_s(f))."""
    return erode(dilate(f, s), s)
