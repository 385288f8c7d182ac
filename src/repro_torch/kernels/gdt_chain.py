"""Fused K-step generalised-geodesic-distance chunk (port of
``repro.kernels.gdt_chain``).

Each of the K fused steps relaxes the distance plane over the
8-connected neighbourhood with the grey-weighted additive cost

    w(p, q) = 1 + λ·|I(p) − I(q)|
    D'(p)   = min(D(p), min_q D(q) + w(p, q))

and then re-pins ``d = +inf`` wherever the seed/pad plane ``s < 0``
(the driver's ``gdt_stage`` marks every pad cell with ``s = −1``).
Three planes ride each scheduling cell: ``d`` (the only one written),
``i`` (the grey-weight image) and ``s``.  All three carry the K-pixel
halo, pinned at image edges and outside the array to their absorbing
identities ``D_IDENT``, ``I_IDENT`` and ``S_IDENT``.

The weight rounds twice, as the reference's does: ``λ·|ΔI|`` rounds,
then ``1 + ·`` rounds, then ``D(q) + w`` rounds — each operation here is
a separate tensor op (no ``alpha=``, no ``addcmul``), and the CUDA
kernel writes them with ``__fmul_rn``/``__fadd_rn``, which no compiler
contracts into a fused multiply-add.  ``λ == 0`` takes the
constant-weight branch (weight exactly 1, no multiply), which also keeps
the reference's guard against ``0·inf`` next to pinned halos.

The same three grid shapes as ``qdt_chain``: ``gdt_chain_step``
(full-width row bands), ``gdt_tile_step`` (band × column tile) and
``gdt_compact_step`` (driver-gathered, pre-pinned patches of all three
planes; ``valid`` masks the workspace's sentinel slots).  An inactive
cell passes ``d`` through with a zero flag; an active one returns 1 iff
a centre pixel moved (NaN counts as moved).  Each wrapper launches its
Hopper kernel (``csrc/gdt_chain.cu``) on CUDA tensors and runs its
``*_plain`` twin on CPU tensors; both return ``(d', changed)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.common import (cell_view, cells_to_plane,
                                        check_grid, flags_arg,
                                        gather_windows, select_cells)

#: Absorbing halo/pad identities per plane.
D_IDENT = math.inf   # distance: +inf never wins a min
I_IDENT = 0.0        # image: any finite value (the weight stays finite)
S_IDENT = -1.0       # seeds: the pad marker the kernels clamp on

#: The 8-connected neighbourhood, in the reference's order.
OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                if (dy, dx) != (0, 0))

#: The dtypes the kernels take.
DTYPES = (torch.float32, torch.float64)


def shift2(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``x`` translated by (dy, dx) over its last two axes, vacated
    cells set to ``fill``: ``out[..., y, x] = x[..., y - dy, x - dx]``."""
    h, w = x.shape[-2:]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 - dy:1 - dy + h, 1 - dx:1 - dx + w]


def gdt_weights(i: torch.Tensor, lamb: float):
    """The eight edge weights ``1 + |λ·|I(p) − I(q)||`` of every pixel,
    one plane per offset of :data:`OFFSETS` (``None`` for λ = 0, where
    each weight is exactly 1).  Each operation rounds on its own; the
    outer ``abs`` mirrors the reference, where it blocks contraction."""
    if lamb == 0.0:
        return None
    return [1.0 + torch.abs(lamb * torch.abs(i - shift2(i, dy, dx, I_IDENT)))
            for dy, dx in OFFSETS]


def relax(d, weights):
    """``min(d(p), min_q d(q) + w(p, q))`` over the last two axes, with
    +inf beyond the edges and ``weights`` from :func:`gdt_weights`
    (``None``: every weight is 1)."""
    best = d
    for n, (dy, dx) in enumerate(OFFSETS):
        dq = shift2(d, dy, dx, D_IDENT)
        best = torch.minimum(best, dq + (1.0 if weights is None
                                         else weights[n]))
    return best


def elementary_gdt(d, i, s, lamb: float, weights=None):
    """One grey-weighted relaxation over the last two axes of ``d``.

    Shift fills are absorbing (``d`` pulls +inf candidates, ``i`` a
    finite 0), so the outer ring degrades by one valid pixel per step;
    the final ``where`` re-pins every pad cell (``s < 0``) to +inf.
    ``weights`` (from :func:`gdt_weights`) may be passed in: they do not
    change across steps."""
    if weights is None:
        weights = gdt_weights(i, lamb)
    return torch.where(s < 0, D_IDENT, relax(d, weights))


def _gdt_update(d, i, s, window, *, fuse_k: int, lamb: float):
    """The K-step relaxation loop shared by every grid shape: K steps on
    (..., H, W) windows, then the centre ``window = ((lo, hi), (cl,
    cr))``."""
    (lo, hi), (cl, cr) = window
    weights = gdt_weights(i, lamb)
    for _ in range(fuse_k):
        d = elementary_gdt(d, i, s, lamb, weights)
    return d[..., lo:hi, cl:cr]


def _grid_plain(d, i, s, lamb, fuse_k, band_h, tile_w, active,
                bands_per_image):
    h, w = d.shape
    n_tiles = w // tile_w
    n_cells = (h // band_h) * n_tiles
    idx = torch.arange(n_cells, device=d.device)
    geo = dict(band_h=band_h, tile_w=tile_w, fuse_k=fuse_k, n_tiles=n_tiles,
               bands_per_image=bands_per_image)
    dw, iw, sw = (gather_windows(x, idx, ident=ident, **geo)
                  for x, ident in ((d, D_IDENT), (i, I_IDENT), (s, S_IDENT)))
    k = fuse_k
    new = _gdt_update(dw, iw, sw, ((k, k + band_h), (k, k + tile_w)),
                      fuse_k=fuse_k, lamb=lamb)
    out, changed = select_cells(active, new, cell_view(d, band_h, tile_w))
    return cells_to_plane(out, n_tiles), changed.reshape(-1, n_tiles)


def gdt_chain_step_plain(d, i, s, *, lamb, fuse_k, band_h, active,
                         bands_per_image):
    """Plain PyTorch version of :func:`gdt_chain_step` (``active`` an
    (n_bands, 1) int32 grid)."""
    return _grid_plain(d, i, s, lamb, fuse_k, band_h, d.shape[1], active,
                       bands_per_image)


def gdt_tile_step_plain(d, i, s, *, lamb, fuse_k, band_h, tile_w, active,
                        bands_per_image):
    """Plain PyTorch version of :func:`gdt_tile_step` (``active`` an
    (n_bands, n_tiles) int32 grid)."""
    return _grid_plain(d, i, s, lamb, fuse_k, band_h, tile_w, active,
                       bands_per_image)


def gdt_compact_step_plain(d_patch, i_patch, s_patch, valid, *, lamb,
                           fuse_k, band_h, tile_w):
    """Plain PyTorch version of :func:`gdt_compact_step` (``valid`` a
    (C, 1) int32 grid)."""
    k = fuse_k
    ph, pw = band_h + 2 * k, tile_w + 2 * k
    cap = d_patch.shape[0] // ph
    dw, iw, sw = (x.reshape(cap, ph, pw) for x in (d_patch, i_patch, s_patch))
    centre = ((k, k + band_h), (k, k + tile_w))
    new = _gdt_update(dw, iw, sw, centre, fuse_k=k, lamb=lamb)
    out, changed = select_cells(valid, new,
                                dw[:, k:k + band_h, k:k + tile_w])
    return out.reshape(cap * band_h, tile_w), changed.reshape(cap, 1)


def _check_planes(d, i, s, shape):
    """d, i and s are ``shape`` planes of one float dtype the kernels
    take."""
    if d.dtype not in DTYPES:
        raise TypeError(f"the gdt kernels take float32 or float64 planes "
                        f"(the distance is a float lattice), got {d.dtype}")
    for name, x in (("d", d), ("i", i), ("s", s)):
        if tuple(x.shape) != shape or x.dtype != d.dtype:
            raise ValueError(f"{name}: expected a {d.dtype} {shape} plane, "
                             f"got {x.dtype} {tuple(x.shape)}")


def _launch(name: str, d, i, s, flags, out_shape, *dims, lamb: float):
    """Launch ``name`` on CUDA tensors; returns (d', changed)."""
    _build.require_cuda(name, d, i, s, flags)
    out = torch.empty(out_shape, dtype=d.dtype, device=d.device)
    changed = torch.zeros(tuple(flags.shape), dtype=torch.int32,
                          device=d.device)
    _build.launch(name, d.device, _build.dtype_code(d.dtype), d, i, s,
                  flags, out, changed, *dims, float(lamb))
    return out, changed


def gdt_chain_step(d, i, s, *, lamb, fuse_k, band_h, active=None,
                   bands_per_image=None):
    """One K-step gdt chunk on pre-padded (H, W) planes (a stack of
    images when ``bands_per_image`` is given); ``active`` an optional
    (n_bands, 1) int32 activity vector.  Returns (d', changed), changed
    an (n_bands, 1) int32."""
    h, w = d.shape
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    grid = (h // band_h, 1)
    _check_planes(d, i, s, (h, w))
    active = flags_arg("active", active, grid, d.device)
    if d.device.type == "cpu":
        return gdt_chain_step_plain(d, i, s, lamb=lamb, fuse_k=fuse_k,
                                    band_h=band_h, active=active,
                                    bands_per_image=bpi)
    out = _launch("gdt_chain_step_launch", d, i, s, active, (h, w), h, w,
                  band_h, fuse_k, bpi, lamb=lamb)
    gdt_chain_step.launches += 1
    return out


def gdt_tile_step(d, i, s, *, lamb, fuse_k, band_h, tile_w, active=None,
                  bands_per_image=None):
    """One K-step gdt chunk on the 2-D (band × column-tile) grid:
    ``active``/``changed`` are (n_bands, n_tiles) int32 grids.  Requires
    ``tile_w % fuse_k == 0`` and ``W % tile_w == 0``."""
    h, w = d.shape
    if w % tile_w or tile_w % fuse_k:
        raise ValueError(f"width {w} must be a multiple of tile_w={tile_w}, "
                         f"itself a multiple of fuse_k={fuse_k}")
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    grid = (h // band_h, w // tile_w)
    _check_planes(d, i, s, (h, w))
    active = flags_arg("active", active, grid, d.device)
    if d.device.type == "cpu":
        return gdt_tile_step_plain(d, i, s, lamb=lamb, fuse_k=fuse_k,
                                   band_h=band_h, tile_w=tile_w,
                                   active=active, bands_per_image=bpi)
    out = _launch("gdt_tile_step_launch", d, i, s, active, (h, w), h, w,
                  band_h, tile_w, fuse_k, bpi, lamb=lamb)
    gdt_tile_step.launches += 1
    return out


def gdt_compact_step(d_patch, i_patch, s_patch, valid, *, lamb, fuse_k,
                     band_h, tile_w):
    """Compacted-grid gdt chunk on driver-gathered, pre-pinned
    (band_h + 2K, tile_w + 2K) patches of all three planes, stacked
    vertically; ``valid`` is (C, 1) int32.  Returns (d', changed) with
    d' centre-only (C·band_h, tile_w)."""
    ph, pw = band_h + 2 * fuse_k, tile_w + 2 * fuse_k
    if d_patch.shape[1] != pw or d_patch.shape[0] % ph:
        raise ValueError(f"patches {tuple(d_patch.shape)} are not a stack "
                         f"of ({ph}, {pw}) windows")
    cap = d_patch.shape[0] // ph
    _check_planes(d_patch, i_patch, s_patch, tuple(d_patch.shape))
    valid = flags_arg("valid", valid, (cap, 1), d_patch.device)
    if d_patch.device.type == "cpu":
        return gdt_compact_step_plain(d_patch, i_patch, s_patch, valid,
                                      lamb=lamb, fuse_k=fuse_k,
                                      band_h=band_h, tile_w=tile_w)
    out = _launch("gdt_compact_step_launch", d_patch, i_patch, s_patch,
                  valid, (cap * band_h, tile_w), cap, band_h, tile_w, fuse_k,
                  lamb=lamb)
    gdt_compact_step.launches += 1
    return out


#: Kernel launches since each count was last set to 0.
gdt_chain_step.launches = 0
gdt_tile_step.launches = 0
gdt_compact_step.launches = 0
