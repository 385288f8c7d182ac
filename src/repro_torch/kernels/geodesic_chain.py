"""Fused K-step elementary geodesic erosion/dilation with convergence
flags — Algorithm 4 of the paper (port of ``repro.kernels.geodesic_chain``).

Each fused step applies ε₁/δ₁ then clamps by the mask (max for
erosion, min for dilation).  Each scheduling cell carries an
``active`` scalar; an inactive cell copies its input through with a
zero flag, an active one returns an int32 ``changed`` flag that is 1
iff any centre pixel changed during the chunk.  Three grid shapes:

* ``geodesic_chain_step`` — cells are full-width row bands;
* ``geodesic_tile_step`` — cells are row band × column tile;
* ``geodesic_compact_step`` — cells are driver-gathered, pre-pinned
  patches; ``valid`` masks the workspace's sentinel slots.

Each wrapper launches its Hopper kernel (``csrc/morph_chain.cu``) on
CUDA tensors and runs its ``*_plain`` twin on CPU tensors.  Padding
contract (enforced by ``kernels.ops``): the mask's pad region holds the
marker's lattice identity, so nothing propagates through padding; the
halo is pinned at image edges (``bands_per_image``) so nothing leaks
between stacked images.
"""
from __future__ import annotations

import torch

from repro_torch.core import morphology as M
from repro_torch.kernels import _build
from repro_torch.kernels.common import (cell_view, cells_to_plane,
                                        check_grid, check_op,
                                        elementary_3x3, flags_arg,
                                        gather_windows, ident_for,
                                        select_cells)


def _geodesic_windows(fw, mw, op: str, fuse_k: int, band_h: int,
                      tile_w: int):
    """K clamped elementary steps on (C, band_h+2K, tile_w+2K) windows;
    returns the (C, band_h, tile_w) centres."""
    clamp = M.maximum if op == "erode" else M.minimum
    for _ in range(fuse_k):
        fw = clamp(elementary_3x3(fw, op), mw)
    return fw[:, fuse_k:fuse_k + band_h, fuse_k:fuse_k + tile_w]


def _grid_plain(f, m, op, fuse_k, band_h, tile_w, active, bands_per_image):
    h, w = f.shape
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    n_tiles = w // tile_w
    n_cells = (h // band_h) * n_tiles
    if active is None:
        active = torch.ones((n_cells,), dtype=torch.int32, device=f.device)
    idx = torch.arange(n_cells, device=f.device)
    geo = dict(band_h=band_h, tile_w=tile_w, fuse_k=fuse_k, n_tiles=n_tiles,
               bands_per_image=bpi, ident=ident_for(check_op(op), f.dtype))
    new = _geodesic_windows(gather_windows(f, idx, **geo),
                            gather_windows(m, idx, **geo), op, fuse_k,
                            band_h, tile_w)
    out, changed = select_cells(active, new, cell_view(f, band_h, tile_w))
    return cells_to_plane(out, n_tiles), changed.reshape(-1, n_tiles)


def geodesic_chain_step_plain(f, m, *, op, fuse_k, band_h, active=None,
                              bands_per_image=None):
    """Plain PyTorch version of :func:`geodesic_chain_step`."""
    return _grid_plain(f, m, op, fuse_k, band_h, f.shape[1], active,
                       bands_per_image)


def geodesic_tile_step_plain(f, m, *, op, fuse_k, band_h, tile_w,
                             active=None, bands_per_image=None):
    """Plain PyTorch version of :func:`geodesic_tile_step`."""
    return _grid_plain(f, m, op, fuse_k, band_h, tile_w, active,
                       bands_per_image)


def geodesic_compact_step_plain(f_patch, m_patch, valid, *, op, fuse_k,
                                band_h, tile_w):
    """Plain PyTorch version of :func:`geodesic_compact_step`."""
    ph, pw = band_h + 2 * fuse_k, tile_w + 2 * fuse_k
    cap = f_patch.shape[0] // ph
    fw = f_patch.reshape(cap, ph, pw)
    new = _geodesic_windows(fw, m_patch.reshape(cap, ph, pw), check_op(op),
                            fuse_k, band_h, tile_w)
    old = fw[:, fuse_k:fuse_k + band_h, fuse_k:fuse_k + tile_w]
    out, changed = select_cells(valid, new, old)
    return out.reshape(cap * band_h, tile_w), changed.reshape(cap, 1)


def _check_pair(f, m):
    if f.shape != m.shape or f.dtype != m.dtype:
        raise ValueError(f"marker {f.dtype} {tuple(f.shape)} and mask "
                         f"{m.dtype} {tuple(m.shape)} must agree")


def geodesic_chain_step(f, m, *, op, fuse_k, band_h, active=None,
                        bands_per_image=None):
    """K fused geodesic steps on a pre-padded marker/mask (stack).

    ``f``/``m`` are (H, W) with H a multiple of ``band_h``.  ``active``
    is an optional (n_bands, 1) int32 activity vector; bands with 0 are
    skipped (input copied through, flag 0).  Returns (new_marker,
    changed) with changed an (n_bands, 1) int32.
    """
    _check_pair(f, m)
    h, w = f.shape
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    n_bands = h // band_h
    active = flags_arg("active", active, (n_bands, 1), f.device)
    if f.device.type == "cpu":
        return geodesic_chain_step_plain(
            f, m, op=op, fuse_k=fuse_k, band_h=band_h, active=active,
            bands_per_image=bpi)
    _build.require_cuda("geodesic_chain_step", f, m, active)
    out = torch.empty_like(f)
    changed = torch.zeros((n_bands, 1), dtype=torch.int32, device=f.device)
    _build.launch("geodesic_chain_step_launch", f.device,
                  _build.dtype_code(f.dtype), int(check_op(op) == "erode"),
                  f, m, active, out, changed, h, w, band_h, fuse_k, bpi)
    geodesic_chain_step.launches += 1
    return out, changed


def geodesic_tile_step(f, m, *, op, fuse_k, band_h, tile_w, active=None,
                       bands_per_image=None):
    """K fused geodesic steps on the 2-D (band × column-tile) grid:
    ``active``/``changed`` are (n_bands, n_tiles) int32 grids.  Requires
    ``tile_w % fuse_k == 0`` and ``W % tile_w == 0``."""
    _check_pair(f, m)
    h, w = f.shape
    if w % tile_w or tile_w % fuse_k:
        raise ValueError(f"width {w} must be a multiple of tile_w={tile_w}, "
                         f"itself a multiple of fuse_k={fuse_k}")
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    grid = (h // band_h, w // tile_w)
    active = flags_arg("active", active, grid, f.device)
    if f.device.type == "cpu":
        return geodesic_tile_step_plain(
            f, m, op=op, fuse_k=fuse_k, band_h=band_h, tile_w=tile_w,
            active=active, bands_per_image=bpi)
    _build.require_cuda("geodesic_tile_step", f, m, active)
    out = torch.empty_like(f)
    changed = torch.zeros(grid, dtype=torch.int32, device=f.device)
    _build.launch("geodesic_tile_step_launch", f.device,
                  _build.dtype_code(f.dtype), int(check_op(op) == "erode"),
                  f, m, active, out, changed, h, w, band_h, tile_w, fuse_k,
                  bpi)
    geodesic_tile_step.launches += 1
    return out, changed


def geodesic_compact_step(f_patch, m_patch, valid, *, op, fuse_k, band_h,
                          tile_w):
    """Compacted-grid variant on driver-gathered, pre-pinned
    (band_h + 2K, tile_w + 2K) patches stacked vertically.  ``valid``
    (C, 1) int32 masks workspace slots past the true active count.
    Returns (new_mid (C·band_h, tile_w), changed (C, 1))."""
    _check_pair(f_patch, m_patch)
    ph, pw = band_h + 2 * fuse_k, tile_w + 2 * fuse_k
    if f_patch.shape[1] != pw or f_patch.shape[0] % ph:
        raise ValueError(f"patches {tuple(f_patch.shape)} are not a stack "
                         f"of ({ph}, {pw}) windows")
    cap = f_patch.shape[0] // ph
    valid = flags_arg("valid", valid, (cap, 1), f_patch.device)
    if f_patch.device.type == "cpu":
        return geodesic_compact_step_plain(
            f_patch, m_patch, valid, op=op, fuse_k=fuse_k, band_h=band_h,
            tile_w=tile_w)
    _build.require_cuda("geodesic_compact_step", f_patch, m_patch, valid)
    out = torch.empty((cap * band_h, tile_w), dtype=f_patch.dtype,
                      device=f_patch.device)
    changed = torch.zeros((cap, 1), dtype=torch.int32, device=f_patch.device)
    _build.launch("geodesic_compact_step_launch", f_patch.device,
                  _build.dtype_code(f_patch.dtype),
                  int(check_op(op) == "erode"), f_patch, m_patch, valid, out,
                  changed, cap, band_h, tile_w, fuse_k)
    geodesic_compact_step.launches += 1
    return out, changed


#: Kernel launches since each count was last set to 0.
geodesic_chain_step.launches = 0
geodesic_tile_step.launches = 0
geodesic_compact_step.launches = 0
