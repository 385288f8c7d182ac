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


#: Parameter types the expression builders embed as graph literals (the
#: reference's ``_SCALAR``); a 0-d tensor is read as one too.  Anything
#: else (a per-image array of thresholds) broadcasts against the image.
_SCALAR = (int, float, bool, np.integer, np.floating)


def _is_scalar(h) -> bool:
    return isinstance(h, _SCALAR) or (isinstance(h, torch.Tensor)
                                      and h.dim() == 0)


def _as(h, dtype: torch.dtype, device) -> torch.Tensor:
    """A scalar, tensor or array ``h`` cast to ``dtype`` on ``device``, as
    ``jnp.asarray(h, dtype)`` casts it."""
    if not isinstance(h, torch.Tensor):
        h = torch.as_tensor(np.asarray(h).astype(numpy_dtype(dtype)))
    return h.to(device=device, dtype=dtype)


def _from_wide(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Back to ``dtype`` from a widened int32/bool tensor, wrapping."""
    if dtype == torch.uint16:
        return x.to(torch.int32).to(torch.int16).view(torch.uint16)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# pointwise primitives (the paper evaluates on unsigned char images)
# ---------------------------------------------------------------------------


def sat_sub(f: torch.Tensor, h) -> torch.Tensor:
    """f - h clamped to the dtype's range (needed for unsigned images).
    ``h`` is a scalar or a tensor/array that broadcasts against ``f``."""
    hv = _as(h, f.dtype, f.device)
    if f.dtype in (torch.uint8, torch.uint16):
        w, hv = M.wide(f), M.wide(hv)
        return M.narrow(torch.where(w > hv, w - hv, 0), f.dtype)
    return f - hv


def sat_add(f: torch.Tensor, h) -> torch.Tensor:
    """f + h clamped to the dtype's range; ``h`` as in :func:`sat_sub`."""
    if f.dtype.is_floating_point:
        return f + _as(h, f.dtype, f.device)
    info = torch.iinfo(f.dtype)
    wide = M.wide(f).to(torch.int64) + _as(h, torch.int64, f.device)
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


def _rec_with_marker(marker: torch.Tensor, mask: torch.Tensor, op: str,
                     backend, device) -> torch.Tensor:
    """Reconstruction on a precomputed marker, through compile; leading
    dimensions beyond one stack fold into it and back."""
    api = _api()
    expr = api.E.reconstruct(api.E.input("marker"), api.E.input("mask"),
                             op=op)
    shape = marker.shape
    if marker.dim() > 3:
        n = int(np.prod(shape[:-2]))
        marker = marker.reshape(n, *shape[-2:])
        mask = mask.reshape(n, *shape[-2:])
    exe = api.compile(expr, marker.shape, marker.dtype, backend,
                      device=device)
    return exe(marker=marker, mask=mask).reshape(shape)


def _hmax_marker(f, h, device):
    """f on the run's device and the HMAX marker f - h of a non-scalar h."""
    f = torch.as_tensor(f, device=resolve_device(device))
    return f, sat_sub(f, h)


def hmax(f: torch.Tensor, h, backend: str | None = None,
         device=None) -> torch.Tensor:
    """HMAX_h(f) = δ_rec^f(f - h): suppress maxima of contrast < h.  A
    non-scalar ``h`` (per image, broadcast against ``f``) cannot embed
    in the graph: its marker is made first and reconstructed on the
    requested engine."""
    if not _is_scalar(h):
        f, marker = _hmax_marker(f, h, device)
        return _rec_with_marker(marker, f, "dilate", backend, device)
    return _run(_api().hmax_expr, f, backend, device, h)


def dome(f: torch.Tensor, h, backend: str | None = None,
         device=None) -> torch.Tensor:
    """DOME_h(f) = f - HMAX_h(f): extract the suppressed maxima (``h``
    as in :func:`hmax`)."""
    if not _is_scalar(h):
        f, marker = _hmax_marker(f, h, device)
        return sub(f, _rec_with_marker(marker, f, "dilate", backend,
                                       device))
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


# ---------------------------------------------------------------------------
# serving registry hooks
# ---------------------------------------------------------------------------

#: Registry hooks for ``repro_torch.serve`` (the reference's
#: ``SERVE_OPS``, name for name): each public geodesic operator declared
#: as data (name + param schema + expression builder) next to its
#: implementation.  The serve registry lowers the expression and derives
#: the prepare (unpadded marker derivation) / run (batched, compiled per
#: bucket) / finalize (post-crop residuals, the QDT η-regularization)
#: stages — see ``repro_torch.serve.registry``.
SERVE_OPS = (
    dict(name="hmax",
         expr=lambda p: _api().hmax_expr(p["h"]),
         params={"h": dict(type="float", required=True)}),
    dict(name="dome",
         expr=lambda p: _api().dome_expr(p["h"]),
         params={"h": dict(type="float", required=True)}),
    dict(name="hfill",
         expr=lambda p: _api().hfill_expr(), params={}),
    dict(name="raobj",
         expr=lambda p: _api().raobj_expr(), params={}),
    dict(name="open_rec",
         expr=lambda p: _api().opening_by_reconstruction_expr(p["s"]),
         params={"s": dict(type="int", required=True, min=1)}),
    dict(name="asf",
         expr=lambda p: _api().asf_expr(p["s"]),
         params={"s": dict(type="int", required=True, min=1)}),
    dict(name="qdt_l1",
         expr=lambda p: _api().qdt_l1_expr(), params={}),
)
