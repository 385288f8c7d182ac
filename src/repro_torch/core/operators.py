"""Geodesic operators of the paper (§2, Eq. 6-12, 19-20) over
``repro_torch.api`` (port of ``repro.core.operators``, main-path part).

Two kinds of things, as in the reference:

* the **pointwise primitives** the expression evaluator uses
  (``sat_sub``/``sat_add``/``sub``/``ge``, the HFILL/RAOBJ marker
  derivations), in plain torch with the reference's dtype semantics;
* the **operator sugar** (``hmax``, ``dome``, ``hfill``, ``raobj``,
  ``opening_by_reconstruction``, ``asf``, ``qdt``): each builds its
  graph with the builders in ``repro_torch.api.expr`` and runs it
  through ``repro_torch.api.compile`` on ``device`` (``None`` is the
  GPU; the input is moved there, and the CPU must be asked for).

The quasi-distance transform's oracle (``qdt_raw``, Eq. 13) and its
η-regularization (``qdt_regularize``, Eq. 14-15) are plain torch loops
on their tensor's device — ``qdt_raw`` is the ``"torch"`` engine's QDT,
``qdt_regularize`` the finalize step of ``qdt_l1_expr``.  The
granulometry (``granulometric_function``, ``pattern_spectrum``, Eq.
16-18) runs the oracle chains on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import morphology as M
from repro_torch.core.backend import numpy_dtype, resolve_device
from repro_torch.kernels.common import qdt_acc_dtype


def _api():
    from repro_torch import api  # lazy: the lowering imports this module

    return api


def _run(expr_builder, f: torch.Tensor, backend, device, *builder_args):
    expr = expr_builder(*builder_args)
    return _api().compile(expr, f.shape, f.dtype, backend,
                          device=device)(f)


def _scalar(h, dtype: torch.dtype):
    """``h`` cast to ``dtype`` the way ``jnp.asarray(h, dtype)`` does."""
    return np.asarray(h, numpy_dtype(dtype)).item()


def _from_wide(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Back to ``dtype`` from a widened int32/bool tensor, wrapping."""
    if dtype == torch.uint16:
        return x.to(torch.int32).to(torch.int16).view(torch.uint16)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# pointwise primitives (the paper evaluates on unsigned char images)
# ---------------------------------------------------------------------------


def sat_sub(f: torch.Tensor, h) -> torch.Tensor:
    """f - h clamped to the dtype's range (needed for unsigned images)."""
    hv = _scalar(h, f.dtype)
    if f.dtype in (torch.uint8, torch.uint16):
        w = M.wide(f)
        return M.narrow(torch.where(w > hv, w - hv, 0), f.dtype)
    return f - torch.tensor(hv, dtype=f.dtype, device=f.device)


def sat_add(f: torch.Tensor, h) -> torch.Tensor:
    """f + h clamped to the dtype's range."""
    if f.dtype.is_floating_point:
        return f + torch.tensor(_scalar(h, f.dtype), dtype=f.dtype,
                                device=f.device)
    info = torch.iinfo(f.dtype)
    wide = M.wide(f).to(torch.int64) + int(np.asarray(h, np.int64))
    return _from_wide(wide.clamp(info.min, info.max), f.dtype)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b in the dtype's own (wrapping) arithmetic."""
    return _from_wide(M.wide(a) - M.wide(b), a.dtype)


def ge(x: torch.Tensor, t) -> torch.Tensor:
    """(x >= t) as 0/1 in x's dtype (compared as floats, as jnp does)."""
    return _from_wide(M.wide(x) >= t, x.dtype)


def _border_mask(shape, device) -> torch.Tensor:
    h, w = shape[-2], shape[-1]
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy == 0) | (yy == h - 1) | (xx == 0) | (xx == w - 1)


def _border_marker(f: torch.Tensor, reduce) -> torch.Tensor:
    inner = M.narrow(reduce(M.wide(f), dim=(-2, -1), keepdim=True), f.dtype)
    return M.select(_border_mask(f.shape, f.device), f,
                    inner.expand_as(f))


def hfill_marker(f: torch.Tensor) -> torch.Tensor:
    """m_HFILL (Eq. 9): border pixels keep f, interior = per-image max."""
    return _border_marker(f, torch.amax)


def raobj_marker(f: torch.Tensor) -> torch.Tensor:
    """m_RAOBJ (Eq. 11): border pixels keep f, interior = per-image min."""
    return _border_marker(f, torch.amin)


# ---------------------------------------------------------------------------
# operator sugar
# ---------------------------------------------------------------------------


def hmax(f: torch.Tensor, h, backend: str | None = None,
         device=None) -> torch.Tensor:
    """HMAX_h(f) = δ_rec^f(f - h): suppress maxima of contrast < h."""
    return _run(_api().hmax_expr, f, backend, device, h)


def dome(f: torch.Tensor, h, backend: str | None = None,
         device=None) -> torch.Tensor:
    """DOME_h(f) = f - HMAX_h(f): extract the suppressed maxima."""
    return _run(_api().dome_expr, f, backend, device, h)


def hfill(f: torch.Tensor, backend: str | None = None,
          device=None) -> torch.Tensor:
    """HFILL(f) = ε_rec^f(m_HFILL(f)) (Eq. 8)."""
    return _run(_api().hfill_expr, f, backend, device)


def raobj(f: torch.Tensor, backend: str | None = None,
          device=None) -> torch.Tensor:
    """RAOBJ(f) = f - δ_rec^f(m_RAOBJ(f)) (Eq. 10)."""
    return _run(_api().raobj_expr, f, backend, device)


def opening_by_reconstruction(f: torch.Tensor, s: int,
                              backend: str | None = None,
                              device=None) -> torch.Tensor:
    """γ_rec^s(f) = δ_rec^f(ε_s(f)): remove components smaller than s.
    The erosion chain and the reconstruction share one padded program."""
    return _run(_api().opening_by_reconstruction_expr, f, backend, device,
                s)


# ---------------------------------------------------------------------------
# quasi-distance transform (Eq. 13-15, Alg. 5)
# ---------------------------------------------------------------------------


def qdt_raw(f: torch.Tensor, max_s: int | None = None):
    """d(f), r(f): distance of the largest residual per pixel (Eq. 13).

    Returns (d, r) where d is int32 distance and r the residual in the
    ``qdt_acc_dtype`` accumulator (residuals of unsigned images fit).
    Erodes until nothing changes (over the whole stack) or ``max_s``
    steps, one read-back per step, as the reference's while loop.
    """
    if max_s is None:
        max_s = max(f.shape[-1], f.shape[-2])
    acc = qdt_acc_dtype(f.dtype)
    d = torch.zeros(f.shape, dtype=torch.int32, device=f.device)
    r = torch.zeros(f.shape, dtype=acc, device=f.device)
    cur, j, changed = f, 1, True
    while changed and j <= max_s:
        nxt = M.erode3(cur)
        res = M.wide(cur).to(acc) - M.wide(nxt).to(acc)
        upd = res > r
        r = torch.where(upd, res, r)
        d = torch.where(upd, j, d)
        changed = bool(M.not_equal(nxt, cur).any())
        cur, j = nxt, j + 1
    return d, r


def _eta(x: torch.Tensor) -> torch.Tensor:
    e = M.erode3(x)
    return torch.where(x - e > 1, e + 1, x)


def qdt_regularize(d: torch.Tensor,
                   max_iters: int | None = None) -> torch.Tensor:
    """η-iteration (Eq. 14) until d is 1-Lipschitz (Eq. 15)."""
    if max_iters is None:
        max_iters = d.shape[-1] * d.shape[-2]
    x = _eta(d)
    it, changed = 1, bool((x != d).any())
    while changed and it < max_iters:
        nxt = _eta(x)
        changed = bool((nxt != x).any())
        x, it = nxt, it + 1
    return x


def qdt(f: torch.Tensor, max_s: int | None = None,
        backend: str | None = None, device=None) -> torch.Tensor:
    """L1-regularized quasi-distance transform d_L1(f) on ``device``
    (``None`` is the GPU).  With ``max_s`` the oracle runs at most
    ``max_s`` erosions, as in the reference."""
    if max_s is not None:
        d, _ = qdt_raw(torch.as_tensor(f, device=resolve_device(device)),
                       max_s)
        return qdt_regularize(d)
    return _run(_api().qdt_l1_expr, f, backend, device)


# ---------------------------------------------------------------------------
# granulometry / pattern spectrum (Eq. 16-18)
# ---------------------------------------------------------------------------


def granulometric_function(f: torch.Tensor, smax: int,
                           device=None) -> torch.Tensor:
    """G_s(f) = Σ_p γ_s(f) for s = 0..smax (Eq. 17) on ``device``
    (``None`` is the GPU), the erosion chain extended one step per
    scale and re-dilated (Eq. 16)."""
    f = torch.as_tensor(f, device=resolve_device(device))
    acc = torch.float64 if f.dtype == torch.float64 else torch.float32
    sums = [M.wide(f).to(acc).sum()]
    eroded = f
    for s in range(1, smax + 1):
        eroded = M.erode3(eroded)
        sums.append(M.wide(M.dilate(eroded, s)).to(acc).sum())
    return torch.stack(sums)


def pattern_spectrum(f: torch.Tensor, smax: int,
                     device=None) -> torch.Tensor:
    """PS_s(f) = G_s(f) - G_{s+1}(f) for s = 0..smax-1 (Eq. 18)."""
    g = granulometric_function(f, smax, device)
    return g[:-1] - g[1:]


def asf(f: torch.Tensor, s: int, backend: str | None = None,
        device=None) -> torch.Tensor:
    """ASF_s(f) = φ_s(γ_s(...φ_1(γ_1(f))...)) — chain length 2·s·(s+1),
    fused into 2s+1 launches around a single pad/crop."""
    return _run(_api().asf_expr, f, backend, device, s)


def asf_chain_length(s: int) -> int:
    """Number of elementary 3×3 filters in ASF_s (for Table 5 analogue)."""
    return sum(4 * k for k in range(1, s + 1))
