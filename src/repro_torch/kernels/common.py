"""Shared helpers for the fused morphology kernels' plain versions and
drivers (port of ``repro.kernels.common``).

The reference assembles each grid step's halo-extended tile from
clamped ``BlockSpec`` blocks (``row_specs``/``tile_specs``) and pins
the out-of-image parts to the lattice identity (``assemble_tile``).
Here the same windows are gathered for a whole batch of cells at once
(:func:`gather_windows`): clamped reads, then :func:`assemble_tile`
pins by the per-cell edge flags of :func:`image_edges` and
:func:`tile_edges`.  The CUDA kernels compute the same offsets from
their block index (``csrc/morph_common.cuh``).

PyTorch's CUDA indexing and ``where`` take no ``uint16``; the glue
moves such data as its int16 bit view (:func:`as_bits`), which keeps
every bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import morphology as M


def qdt_acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Residual-accumulator dtype of the quasi-distance transform:
    float32 for floating images, int32 otherwise."""
    return torch.float32 if dtype.is_floating_point else torch.int32


def ident_for(op: str, dtype: torch.dtype):
    """Lattice identity as a Python number: +max for erosion (min-op),
    -max for dilation."""
    return M.top_value(dtype) if op == "erode" else M.bottom_value(dtype)


def as_bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor every indexing/select op takes (uint16 → its
    int16 bit view; everything else unchanged)."""
    return x.view(torch.int16) if x.dtype == torch.uint16 else x


def from_bits(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`as_bits`."""
    return y.view(dtype) if dtype == torch.uint16 else y


def bits_value(value, dtype: torch.dtype):
    """A fill value of ``dtype`` expressed in :func:`as_bits`' dtype."""
    if dtype == torch.uint16:
        return int(np.array(value, np.uint16).view(np.int16))
    return value


def fill_where(cond: torch.Tensor, x: torch.Tensor, value) -> torch.Tensor:
    """``where(cond, value, x)`` for every dtype."""
    out = torch.where(cond, bits_value(value, x.dtype), as_bits(x))
    return from_bits(out, x.dtype)


def shift_minmax_1d(x: torch.Tensor, axis: int, op: str) -> torch.Tensor:
    """min/max(x, x<<1, x>>1) along ``axis`` with identity fill — the
    paper's Algorithm-1 inner step."""
    return M.erode1d(x, axis) if op == "erode" else M.dilate1d(x, axis)


def elementary_3x3(x: torch.Tensor, op: str) -> torch.Tensor:
    """ε₁ / δ₁ on a tile (or a batch of tiles): horizontal then vertical
    decomposed pass."""
    return shift_minmax_1d(shift_minmax_1d(x, -1, op), -2, op)


def image_edges(i: torch.Tensor, bands_per_image: int):
    """(at_top, at_bot) for band indices ``i`` of a vertically stacked
    batch: halo pinning happens at *image* edges, never stack edges, so
    values never propagate between images."""
    j = i % bands_per_image
    return j == 0, j == bands_per_image - 1


def tile_edges(j: torch.Tensor, n_tiles: int):
    """(at_left, at_right) for column-tile indices ``j``; images stack
    only vertically, so horizontal image edges are the array edges."""
    return j == 0, j == n_tiles - 1


def assemble_tile(raw: torch.Tensor, edges, ident, fuse_k: int):
    """Pin the out-of-image halos of a batch of (C, band_h + 2K,
    tile_w + 2K) windows read with clamped addresses.  ``edges`` are the
    per-cell (at_top, at_bot, at_left, at_right) flags; a corner pins
    when either of its axes is at an edge, exactly like the reference's
    nine-block assembly."""
    at_top, at_bot, at_lf, at_rt = edges
    _, ph, pw = raw.shape
    r = torch.arange(ph, device=raw.device)[None, :]
    c = torch.arange(pw, device=raw.device)[None, :]
    row_pin = (((r < fuse_k) & at_top[:, None])
               | ((r >= ph - fuse_k) & at_bot[:, None]))
    col_pin = (((c < fuse_k) & at_lf[:, None])
               | ((c >= pw - fuse_k) & at_rt[:, None]))
    return fill_where(row_pin[:, :, None] | col_pin[:, None, :], raw, ident)


def gather_windows(x2: torch.Tensor, idx: torch.Tensor, *, band_h: int,
                   tile_w: int, fuse_k: int, n_tiles: int,
                   bands_per_image: int, ident) -> torch.Tensor:
    """Halo windows of the cells ``idx`` of a stacked (TOTAL_H, W)
    array → (C, band_h + 2K, tile_w + 2K), pinned at image and array
    edges.  A cell index is ``band * n_tiles + tile``; sentinel indices
    (≥ the cell count) come back all-``ident``."""
    h, w = x2.shape
    total = (h // band_h) * n_tiles
    k = fuse_k
    bi = idx // n_tiles
    tj = idx % n_tiles
    dev = x2.device
    rows = bi[:, None] * band_h - k + torch.arange(band_h + 2 * k,
                                                   device=dev)[None, :]
    cols = tj[:, None] * tile_w - k + torch.arange(tile_w + 2 * k,
                                                   device=dev)[None, :]
    raw = as_bits(x2)[rows.clamp(0, h - 1)[:, :, None],
                      cols.clamp(0, w - 1)[:, None, :]]
    raw = from_bits(raw, x2.dtype)
    at_top, at_bot = image_edges(bi, bands_per_image)
    at_lf, at_rt = tile_edges(tj, n_tiles)
    win = assemble_tile(raw, (at_top, at_bot, at_lf, at_rt), ident, k)
    return fill_where((idx >= total)[:, None, None], win, ident)


def cell_view(x2: torch.Tensor, band_h: int, tile_w: int) -> torch.Tensor:
    """(TOTAL_H, W) → (cells, band_h, tile_w), cell-major (a copy)."""
    h, w = x2.shape
    nb, nt = h // band_h, w // tile_w
    cells = (as_bits(x2).reshape(nb, band_h, nt, tile_w)
             .permute(0, 2, 1, 3).reshape(-1, band_h, tile_w))
    return from_bits(cells, x2.dtype)


def cells_to_plane(cells: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """Inverse of :func:`cell_view`: (cells, band_h, tile_w) →
    (TOTAL_H, W)."""
    c, bh, tw = cells.shape
    nb = c // n_tiles
    plane = (as_bits(cells).reshape(nb, n_tiles, bh, tw)
             .permute(0, 2, 1, 3).reshape(nb * bh, n_tiles * tw))
    return from_bits(plane, cells.dtype)


def select_cells(flags: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Active cells take ``new``, the rest keep ``old``; the changed
    flag of a cell is 1 iff it is active and a centre pixel moved."""
    act = flags.reshape(-1) > 0
    out = from_bits(torch.where(act[:, None, None], as_bits(new),
                                as_bits(old)), old.dtype)
    moved = M.not_equal(out, old).flatten(1).any(1)
    return out, (moved & act).to(torch.int32)


def flags_arg(name: str, flags, shape, device) -> torch.Tensor:
    """A kernel's int32 per-cell grid of ``shape`` (all ones if None)."""
    if flags is None:
        return torch.ones(shape, dtype=torch.int32, device=device)
    if tuple(flags.shape) != shape or flags.dtype != torch.int32:
        raise ValueError(f"{name}: expected an int32 {shape} grid, got "
                         f"{flags.dtype} {tuple(flags.shape)}")
    return flags


def check_op(op: str) -> str:
    if op not in ("erode", "dilate"):
        raise ValueError(f"op must be 'erode' or 'dilate', got {op!r}")
    return op


def check_grid(h: int, band_h: int, fuse_k: int,
               bands_per_image: int | None) -> int:
    """Validate a row-band grid; returns ``bands_per_image`` (every band
    of one image when None)."""
    if h % band_h or band_h % fuse_k:
        raise ValueError(f"rows {h} must be a multiple of band_h={band_h}, "
                         f"itself a multiple of fuse_k={fuse_k}")
    n_bands = h // band_h
    bpi = n_bands if bands_per_image is None else bands_per_image
    if n_bands % bpi:
        raise ValueError(f"{n_bands} bands do not split into images of "
                         f"{bpi} bands")
    return bpi
