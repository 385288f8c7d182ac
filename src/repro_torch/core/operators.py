"""Geodesic operators of the paper (§2, Eq. 6-12, 19-20) over
``repro_torch.api`` (port of ``repro.core.operators``, main-path part).

Two kinds of things, as in the reference:

* the **pointwise primitives** the expression evaluator uses
  (``sat_sub``/``sat_add``/``sub``/``ge``, the HFILL/RAOBJ marker
  derivations), in plain torch with the reference's dtype semantics;
* the **operator sugar** (``hmax``, ``dome``, ``hfill``, ``raobj``,
  ``opening_by_reconstruction``, ``asf``): each builds its graph with
  the builders in ``repro_torch.api.expr`` and runs it through
  ``repro_torch.api.compile`` on ``device`` (``None`` is the GPU;
  the input is moved there, and the CPU must be asked for).

The QDT (``qdt_raw``/``qdt_regularize``/``qdt``) and the granulometry
wait for later slices of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import morphology as M
from repro_torch.core.backend import numpy_dtype


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


def asf(f: torch.Tensor, s: int, backend: str | None = None,
        device=None) -> torch.Tensor:
    """ASF_s(f) = φ_s(γ_s(...φ_1(γ_1(f))...)) — chain length 2·s·(s+1),
    fused into 2s+1 launches around a single pad/crop."""
    return _run(_api().asf_expr, f, backend, device, s)


def asf_chain_length(s: int) -> int:
    """Number of elementary 3×3 filters in ASF_s (for Table 5 analogue)."""
    return sum(4 * k for k in range(1, s + 1))
