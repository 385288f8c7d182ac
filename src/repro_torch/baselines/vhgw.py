"""van Herk / Gil-Werman O(1)-per-pixel separable min/max filter (port
of ``repro.baselines.vhgw``).

The paper's "insensitive to window size" competitor family (§1, [23],
[8], [9]).  Used for the crossover experiment: the paper shows chained
3×3 filters beat O(1)/px methods up to window 183×183 (char) / 27×27
(double); ``chip_smoke.py`` times this implementation beside the
``"cuda"`` engine's chains on the card.

Vectorized PyTorch: prefix/suffix min within w-aligned blocks, then
``out[i] = min(S[i], P[i+w-1])`` — one ``torch.cummin`` + one reversed
``torch.cummin`` + one elementwise min per axis, independent of w.
uint16 is widened to int32 (``core/morphology.py:wide``), where PyTorch
has the cumulative min/max, and narrowed back.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import morphology as M


def _minmax_1d(x: torch.Tensor, s: int, op: str, axis: int) -> torch.Tensor:
    if s == 0:
        return x
    w = 2 * s + 1
    n = x.shape[axis]
    ident = M.top_value(x.dtype) if op == "erode" else M.bottom_value(x.dtype)
    reduce_fn = M.minimum if op == "erode" else M.maximum
    cum_op = torch.cummin if op == "erode" else torch.cummax

    dtype = x.dtype
    x = M.wide(x).movedim(axis, -1)
    lead = x.shape[:-1]
    # pad so every window [p, p+w-1] of the s-left-shifted array is in range
    padded_len = n + 2 * s
    aligned = math.ceil(padded_len / w) * w
    y = torch.full(lead + (aligned,), ident, dtype=x.dtype, device=x.device)
    y[..., s:s + n] = x

    # each w-block a column, blocks side by side: the scans run down the
    # columns, neighbouring blocks on neighbouring addresses.  Scanned
    # along the last dimension, one short block a row, an 8 x 1024^2
    # uint8 erosion took 102 ms at w = 3 against 0.6 ms at w = 183 on an
    # H100 (chip_smoke.py, phase 9)
    blocks = y.reshape(lead + (aligned // w, w)).transpose(-1, -2)

    def rows(c):
        return c.transpose(-1, -2).reshape(lead + (aligned,))

    prefix = rows(cum_op(blocks, dim=-2).values)
    suffix = rows(cum_op(blocks.flip(-2), dim=-2).values.flip(-2))

    out = reduce_fn(suffix[..., :n], prefix[..., w - 1:w - 1 + n])
    return M.narrow(out.movedim(-1, axis), dtype)


def minmax_filter(f: torch.Tensor, s: int, op: str = "erode") -> torch.Tensor:
    """(2s+1)×(2s+1) erosion/dilation in O(1) comparisons per pixel, on
    ``f``'s device."""
    return _minmax_1d(_minmax_1d(f, s, op, -1), s, op, -2)


def erode(f: torch.Tensor, s: int) -> torch.Tensor:
    return minmax_filter(f, s, "erode")


def dilate(f: torch.Tensor, s: int) -> torch.Tensor:
    return minmax_filter(f, s, "dilate")
