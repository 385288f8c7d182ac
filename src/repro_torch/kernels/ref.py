"""Oracles for the ported kernels (port of ``repro.kernels.ref``).

The reference implementations live in ``repro_torch.core.morphology`` and
``repro_torch.core.operators``; this module re-exports them under
kernel-aligned names so each kernel test reads ``kernel_out ==
ref.<name>(...)`` — bit-exact.
"""
from __future__ import annotations

import torch

from repro_torch.core.morphology import (  # noqa: F401
    dilate,
    dilate3,
    dilate_reconstruct,
    erode,
    erode3,
    erode_reconstruct,
    geodesic_dilate,
    geodesic_erode,
    wide,
)
from repro_torch.core.operators import qdt_raw  # noqa: F401


def chain(f: torch.Tensor, n: int, op: str) -> torch.Tensor:
    """n elementary 3×3 filters — oracle for erode_chain.chain_step."""
    return erode(f, n) if op == "erode" else dilate(f, n)


def geodesic_chain(f: torch.Tensor, m: torch.Tensor, n: int,
                   op: str) -> torch.Tensor:
    """n elementary geodesic steps — oracle for geodesic_chain_step."""
    if op == "erode":
        return geodesic_erode(f, m, n)
    return geodesic_dilate(f, m, n)


def qdt_chunk(f: torch.Tensor, r: torch.Tensor, d: torch.Tensor, base: int,
              n: int):
    """n QDT erosion steps with residual/distance update — oracle for
    qdt_chain_step."""
    acc = r.dtype
    cur = f
    for k in range(n):
        nxt = erode3(cur)
        res = wide(cur).to(acc) - wide(nxt).to(acc)
        upd = res > r
        r = torch.where(upd, res, r)
        d = torch.where(upd, base + k + 1, d)
        cur = nxt
    return cur, r, d
