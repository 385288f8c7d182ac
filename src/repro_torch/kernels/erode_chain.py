"""Fused K-step 3×3 erosion/dilation chain — the paper's core (port of
``repro.kernels.erode_chain``).

``chain_step`` applies K fused elementary filters to every row band of
a pre-padded (N·H_pad, W_pad) stack, with row halos pinned to the
lattice identity at *image* edges and columns at the array edges.  On
a CUDA tensor it launches ``chain_step_launch`` (``csrc/morph_chain.cu``,
the Hopper kernel that replaces the Pallas ``chain_step``); on a CPU
tensor it runs :func:`chain_step_plain`, the same function in plain
PyTorch.

Border semantics: the driver pads each image with the lattice identity;
for a rectangular domain, iterated erosion with identity padding
restricted to the original domain equals the paper's border-clipped
erosion.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (cells_to_plane, check_grid, check_op,
                                        elementary_3x3, gather_windows,
                                        ident_for)


def chain_step_plain(x: torch.Tensor, *, op: str, fuse_k: int, band_h: int,
                     bands_per_image: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`chain_step`: every band's
    (band_h + 2K, W + 2K) halo window, pinned like the kernel's, K
    elementary filters, centre out."""
    h, w = x.shape
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    idx = torch.arange(h // band_h, device=x.device)
    win = gather_windows(x, idx, band_h=band_h, tile_w=w, fuse_k=fuse_k,
                         n_tiles=1, bands_per_image=bpi,
                         ident=ident_for(check_op(op), x.dtype))
    for _ in range(fuse_k):
        win = elementary_3x3(win, op)
    return cells_to_plane(win[:, fuse_k:fuse_k + band_h, fuse_k:fuse_k + w],
                          1)


def chain_step(x: torch.Tensor, *, op: str, fuse_k: int, band_h: int,
               bands_per_image: int | None = None) -> torch.Tensor:
    """Apply K fused elementary filters to a pre-padded image (stack).

    ``x``: (H_pad, W_pad) with H_pad % band_h == 0, band_h % fuse_k == 0,
    padding filled with the lattice identity for ``op``.  For a vertical
    stack of N images pass ``bands_per_image`` so the halo is pinned at
    each image's edges.  Returns a new tensor; the input is not touched.
    """
    if x.device.type == "cpu":
        return chain_step_plain(x, op=op, fuse_k=fuse_k, band_h=band_h,
                                bands_per_image=bands_per_image)
    _build.require_cuda("chain_step", x)
    h, w = x.shape
    bpi = check_grid(h, band_h, fuse_k, bands_per_image)
    out = torch.empty_like(x)
    _build.launch("chain_step_launch", x.device, _build.dtype_code(x.dtype),
                  int(check_op(op) == "erode"), x, out, h, w, band_h, fuse_k,
                  bpi)
    chain_step.launches += 1
    return out


#: Kernel launches since the count was last set to 0.
chain_step.launches = 0
