"""Fused K-step quasi-distance-transform chunk — Algorithm 5 of the paper
(port of ``repro.kernels.qdt_chain``).

Each of the K fused steps computes ε₁, the residual ``f − ε₁(f)`` in
``qdt_acc_dtype`` (int32, float32 for floating images), and the masked
store of the residual plane r(f) and the distance plane d(f): where the
residual exceeds r, r takes it and d takes ``base + step``.  r/d belong
to the centre only; only the eroding image carries the K-pixel halo.
``base`` holds, per cell, the erosions already applied to the cell's
image, so every image of a ragged-converged stack keeps its own distance
index (a (1, 1) ``base`` is broadcast).

The same three grid shapes as ``geodesic_chain``: ``qdt_chain_step``
(full-width row bands), ``qdt_tile_step`` (band × column tile) and
``qdt_compact_step`` (driver-gathered, pre-pinned patches; ``valid``
masks the workspace's sentinel slots and ``base`` is per slot).  An
inactive cell passes f, r and d through with a zero flag; an active one
returns 1 iff a centre f pixel moved.  Each wrapper launches its Hopper
kernel (``csrc/qdt_chain.cu``) on CUDA tensors and runs its ``*_plain``
twin on CPU tensors; both return ``(f', r', d', changed)``.
"""
from __future__ import annotations

import torch

from repro_torch.core import morphology as M
from repro_torch.kernels import _build
from repro_torch.kernels.common import (cell_view, cells_to_plane,
                                        check_grid, elementary_3x3,
                                        flags_arg, gather_windows, ident_for,
                                        qdt_acc_dtype, select_cells)


def _residual(a: torch.Tensor, b: torch.Tensor, acc: torch.dtype):
    """``a − b`` in the accumulator dtype, each operand cast first, as
    the reference computes it (int32 subtraction wraps)."""
    return M.wide(a).to(acc) - M.wide(b).to(acc)


def _qdt_windows(fw, r, d, base, fuse_k: int, band_h: int, tile_w: int):
    """K QDT steps on (C, band_h+2K, tile_w+2K) windows with (C, band_h,
    tile_w) r/d and a (C,) base; returns the centres, r and d."""
    lo, hi, cl, cr = fuse_k, fuse_k + band_h, fuse_k, fuse_k + tile_w
    base = base.reshape(-1, 1, 1)
    for k in range(fuse_k):
        nxt = elementary_3x3(fw, "erode")
        res = _residual(fw[:, lo:hi, cl:cr], nxt[:, lo:hi, cl:cr], r.dtype)
        upd = res > r
        r = torch.where(upd, res, r)
        d = torch.where(upd, base + (k + 1), d)
        fw = nxt
    return fw[:, lo:hi, cl:cr], r, d


def _select(flags, new, old):
    """Active cells take the new f, r and d, the rest keep the old."""
    f, changed = select_cells(flags, new[0], old[0])
    keep = (flags.reshape(-1) > 0)[:, None, None]
    return (f, torch.where(keep, new[1], old[1]),
            torch.where(keep, new[2], old[2]), changed)


def _grid_plain(f, r, d, base, fuse_k, band_h, tile_w, active,
                bands_per_image):
    h, w = f.shape
    n_tiles = w // tile_w
    n_cells = (h // band_h) * n_tiles
    idx = torch.arange(n_cells, device=f.device)
    win = gather_windows(f, idx, band_h=band_h, tile_w=tile_w,
                         fuse_k=fuse_k, n_tiles=n_tiles,
                         bands_per_image=bands_per_image,
                         ident=ident_for("erode", f.dtype))
    old = tuple(cell_view(x, band_h, tile_w) for x in (f, r, d))
    new = _qdt_windows(win, old[1], old[2], base, fuse_k, band_h, tile_w)
    *planes, changed = _select(active, new, old)
    return (*(cells_to_plane(x, n_tiles) for x in planes),
            changed.reshape(-1, n_tiles))


def qdt_chain_step_plain(f, r, d, base, *, fuse_k, band_h, active,
                         bands_per_image):
    """Plain PyTorch version of :func:`qdt_chain_step` (``base`` and
    ``active`` as (n_bands, 1) int32 grids)."""
    return _grid_plain(f, r, d, base, fuse_k, band_h, f.shape[1], active,
                       bands_per_image)


def qdt_tile_step_plain(f, r, d, base, *, fuse_k, band_h, tile_w, active,
                        bands_per_image):
    """Plain PyTorch version of :func:`qdt_tile_step` (``base`` and
    ``active`` as (n_bands, n_tiles) int32 grids)."""
    return _grid_plain(f, r, d, base, fuse_k, band_h, tile_w, active,
                       bands_per_image)


def qdt_compact_step_plain(f_patch, r_mid, d_mid, valid, base, *, fuse_k,
                           band_h, tile_w):
    """Plain PyTorch version of :func:`qdt_compact_step` (``valid`` and
    ``base`` as (C, 1) int32 grids)."""
    ph, pw = band_h + 2 * fuse_k, tile_w + 2 * fuse_k
    cap = f_patch.shape[0] // ph
    fw = f_patch.reshape(cap, ph, pw)
    old = (fw[:, fuse_k:fuse_k + band_h, fuse_k:fuse_k + tile_w],
           r_mid.reshape(cap, band_h, tile_w),
           d_mid.reshape(cap, band_h, tile_w))
    new = _qdt_windows(fw, old[1], old[2], base, fuse_k, band_h, tile_w)
    *planes, changed = _select(valid, new, old)
    return (*(x.reshape(cap * band_h, tile_w) for x in planes),
            changed.reshape(cap, 1))


def _check_planes(f, r, d, shape):
    """r/d are ``shape`` planes of the accumulator dtype and int32."""
    acc = qdt_acc_dtype(f.dtype)
    for name, x, dtype in (("r", r, acc), ("d", d, torch.int32)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name}: expected a {dtype} {shape} plane for "
                             f"a {f.dtype} image, got {x.dtype} "
                             f"{tuple(x.shape)}")


def _base_arg(base: torch.Tensor, shape) -> torch.Tensor:
    """The per-cell base as an int32 ``shape`` grid; (1, 1) broadcasts."""
    if tuple(base.shape) == (1, 1) and shape != (1, 1):
        base = base.expand(shape).contiguous()
    return flags_arg("base", base, shape, base.device)


def _launch(name: str, f, r, d, base, flags, out_shape, *dims):
    """Launch ``name`` on CUDA tensors; returns (f', r', d', changed)."""
    _build.require_cuda(name, f, r, d, base, flags)
    f2 = torch.empty(out_shape, dtype=f.dtype, device=f.device)
    r2 = torch.empty(out_shape, dtype=r.dtype, device=f.device)
    d2 = torch.empty(out_shape, dtype=torch.int32, device=f.device)
    changed = torch.zeros(tuple(flags.shape), dtype=torch.int32,
                          device=f.device)
    _build.launch(name, f.device, _build.dtype_code(f.dtype), f, r, d, base,
                  flags, f2, r2, d2, changed, *dims)
    return f2, r2, d2, changed


def qdt_chain_step(f, r, d, base, *, fuse_k, band_h, active=None,
                   bands_per_image=None):
    """One K-step QDT chunk on pre-padded (H, W) planes (a stack of
    images when ``bands_per_image`` is given).

    ``base`` is an (n_bands, 1) int32 with the erosions already applied
    to each band's image; ``active`` an optional (n_bands, 1) int32
    activity vector.  Returns (f', r', d', changed), changed an
    (n_bands, 1) int32.
    """
    h, w = f.shape
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    grid = (h // band_h, 1)
    _check_planes(f, r, d, (h, w))
    base = _base_arg(base, grid)
    active = flags_arg("active", active, grid, f.device)
    if f.device.type == "cpu":
        return qdt_chain_step_plain(f, r, d, base, fuse_k=fuse_k,
                                    band_h=band_h, active=active,
                                    bands_per_image=bpi)
    out = _launch("qdt_chain_step_launch", f, r, d, base, active, (h, w), h,
                  w, band_h, fuse_k, bpi)
    qdt_chain_step.launches += 1
    return out


def qdt_tile_step(f, r, d, base, *, fuse_k, band_h, tile_w, active=None,
                  bands_per_image=None):
    """One K-step QDT chunk on the 2-D (band × column-tile) grid:
    ``base``/``active``/``changed`` are (n_bands, n_tiles) int32 grids.
    Requires ``tile_w % fuse_k == 0`` and ``W % tile_w == 0``."""
    h, w = f.shape
    if w % tile_w or tile_w % fuse_k:
        raise ValueError(f"width {w} must be a multiple of tile_w={tile_w}, "
                         f"itself a multiple of fuse_k={fuse_k}")
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    grid = (h // band_h, w // tile_w)
    _check_planes(f, r, d, (h, w))
    base = _base_arg(base, grid)
    active = flags_arg("active", active, grid, f.device)
    if f.device.type == "cpu":
        return qdt_tile_step_plain(f, r, d, base, fuse_k=fuse_k,
                                   band_h=band_h, tile_w=tile_w,
                                   active=active, bands_per_image=bpi)
    out = _launch("qdt_tile_step_launch", f, r, d, base, active, (h, w), h,
                  w, band_h, tile_w, fuse_k, bpi)
    qdt_tile_step.launches += 1
    return out


def qdt_compact_step(f_patch, r_mid, d_mid, valid, base, *, fuse_k, band_h,
                     tile_w):
    """Compacted-grid QDT chunk on driver-gathered, pre-pinned
    (band_h + 2K, tile_w + 2K) patches stacked vertically, with
    centre-only (C·band_h, tile_w) r/d; ``valid`` and ``base`` are (C, 1)
    int32 (each slot carries its image's erosion count).  Returns
    (f', r', d', changed)."""
    ph, pw = band_h + 2 * fuse_k, tile_w + 2 * fuse_k
    if f_patch.shape[1] != pw or f_patch.shape[0] % ph:
        raise ValueError(f"patches {tuple(f_patch.shape)} are not a stack "
                         f"of ({ph}, {pw}) windows")
    cap = f_patch.shape[0] // ph
    _check_planes(f_patch, r_mid, d_mid, (cap * band_h, tile_w))
    valid = flags_arg("valid", valid, (cap, 1), f_patch.device)
    base = _base_arg(base, (cap, 1))
    if f_patch.device.type == "cpu":
        return qdt_compact_step_plain(f_patch, r_mid, d_mid, valid, base,
                                      fuse_k=fuse_k, band_h=band_h,
                                      tile_w=tile_w)
    out = _launch("qdt_compact_step_launch", f_patch, r_mid, d_mid, base,
                  valid, (cap * band_h, tile_w), cap, band_h, tile_w,
                  fuse_k)
    qdt_compact_step.launches += 1
    return out


#: Kernel launches since each count was last set to 0.
qdt_chain_step.launches = 0
qdt_tile_step.launches = 0
qdt_compact_step.launches = 0
