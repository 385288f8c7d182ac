"""Dtype-safety checks (check class b; port of ``repro.analysis.dtypes``):
absorbing fills + QDT overflow.

Two families of facts are proved per supported dtype (the paper's
char→double crossover set, §4):

* the serve bucketer's pad fill (``serve/bucketer.py:pad_fill``) must
  equal the lattice identity the kernels pin halos with
  (``kernels/common.py:ident_for``) and round-trip through the image
  dtype exactly — a fill one ULP off the lattice top is no longer
  absorbing for erosion and corrupts borders silently;
* the quasi-distance transform accumulates residuals
  ``f − ε₁(f)`` into ``kernels/common.py:qdt_acc_dtype``; the residual
  telescoping bound is the lattice range (one erosion can drop a pixel
  from top to bottom), so the accumulator must represent
  ``top − bottom``.  When the image dtype's own range cannot overflow
  the accumulator the fact is a proof (uint8…int16); when overflow
  needs pathological-but-representable inputs it is a WARN
  (int32 images in an int32 accumulator, float64 in float32).

Dtypes may be given as torch dtypes, NumPy dtypes or their names; the
facts are stated on NumPy dtypes (``core/backend.py:numpy_dtype``), so
the findings read as the reference's.  Every check takes the *claimed*
value as an argument with the production default, so the mutation
self-tests can seed a wrong fill or an undersized accumulator and assert
detection.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import ERROR, WARN, Finding
from repro_torch.core.backend import as_dtype, numpy_dtype

#: Supported image dtypes, uint8 through float64 (the reference's set).
SUPPORTED_DTYPES = ("uint8", "uint16", "int16", "int32",
                    "float32", "float64")

#: pad-fill name → the op whose lattice identity it must be.
FILL_OP = {"hi": "erode", "lo": "dilate"}


def _np(dtype) -> np.dtype:
    return numpy_dtype(as_dtype(dtype))


def _lattice(dtype):
    """(top, bottom) of the dtype's complete lattice as numpy scalars."""
    dtype = _np(dtype)
    if np.issubdtype(dtype, np.floating):
        return np.array(np.inf, dtype), np.array(-np.inf, dtype)
    info = np.iinfo(dtype)
    return np.array(info.max, dtype), np.array(info.min, dtype)


def check_fill_value(dtype, which: str, value) -> list:
    """Is ``value`` the absorbing identity ``which`` for ``dtype``?"""
    out = []
    dtype = _np(dtype)
    subject = f"pad_fill({dtype.name}, {which!r})"
    top, bot = _lattice(dtype)
    expect = top if which == "hi" else bot
    got = np.asarray(value)
    if got.dtype != dtype:
        # a float fill for an int image (or vice versa) silently casts
        # at pad time; require the exact dtype round-trip
        cast = got.astype(dtype)
        if not np.array_equal(cast.astype(got.dtype), got, equal_nan=True):
            out.append(Finding(
                "dtype", ERROR, subject,
                f"fill {got!r} is not representable in {dtype}"))
            return out
        got = cast
    if not np.array_equal(got, expect, equal_nan=True):
        out.append(Finding(
            "dtype", ERROR, subject,
            f"fill is {got!r}, but the absorbing identity for "
            f"{FILL_OP[which]} is {expect!r} — pad values would "
            "participate in the min/max and corrupt borders"))
    return out


def check_bucketer_fills(dtypes=SUPPORTED_DTYPES) -> list:
    """Audit ``serve.bucketer.pad_fill`` against the kernel identities."""
    from repro_torch.kernels.common import ident_for
    from repro_torch.serve.bucketer import pad_fill

    out = []
    for dt in dtypes:
        for which, op in FILL_OP.items():
            out += check_fill_value(dt, which, pad_fill(dt, which))
            # the serve fill and the in-kernel pin must agree too
            kern = np.asarray(ident_for(op, as_dtype(dt)))
            serve = np.asarray(pad_fill(dt, which))
            if not np.array_equal(kern, serve, equal_nan=True):
                out.append(Finding(
                    "dtype", ERROR, f"pad_fill({dt}, {which!r})",
                    f"serve fill {serve!r} != kernel halo identity "
                    f"{kern!r} (ident_for)"))
    return out


def check_qdt_accumulator(image_dtype, acc_dtype=None) -> list:
    """Can ``acc_dtype`` hold QDT residuals of ``image_dtype`` images?

    The residual is ``f − ε₁(f)`` with both operands cast to the
    accumulator first; its tight bound is ``top − bottom`` of the image
    lattice.
    """
    if acc_dtype is None:
        from repro_torch.kernels.common import qdt_acc_dtype
        acc_dtype = qdt_acc_dtype(as_dtype(image_dtype))
    img, acc = _np(image_dtype), _np(acc_dtype)
    subject = f"qdt acc ({img.name} image → {acc.name} accumulator)"
    out = []

    if np.issubdtype(img, np.floating):
        if not np.issubdtype(acc, np.floating):
            out.append(Finding(
                "dtype", ERROR, subject,
                "floating image accumulated in an integer dtype — "
                "fractional residuals truncate"))
            return out
        if np.finfo(img).max > np.finfo(acc).max:
            out.append(Finding(
                "dtype", WARN, subject,
                f"residual bound 2·{np.finfo(img).max:.3g} exceeds "
                f"{acc.name} max {np.finfo(acc).max:.3g}: residuals of "
                "full-range images saturate to inf (distance planes "
                "stay ordered, values lose precision)"))
        return out

    if np.issubdtype(acc, np.floating):
        # integer residuals are exact in an integer accumulator; a
        # float accumulator breaks bit-exactness above 2^mantissa
        mant = np.finfo(acc).nmant
        if int(np.iinfo(img).max) - int(np.iinfo(img).min) > 2 ** mant:
            out.append(Finding(
                "dtype", ERROR, subject,
                f"integer residual bound exceeds the {acc.name} "
                f"mantissa (2^{mant}) — accumulation is no longer "
                "bit-exact"))
        return out

    bound = int(np.iinfo(img).max) - int(np.iinfo(img).min)
    acc_max = int(np.iinfo(acc).max)
    if bound > acc_max:
        # provable within the dtype's normal domain for narrow images,
        # domain-conditional for >= 32-bit images
        severity = ERROR if np.iinfo(img).bits < 32 else WARN
        out.append(Finding(
            "dtype", severity, subject,
            f"residual bound top−bottom = {bound} exceeds {acc.name} "
            f"max {acc_max} — a single erosion step can overflow the "
            "masked-store accumulator"
            + ("" if severity == ERROR else
               " (requires images spanning more than the accumulator "
               "range; unreachable for uint8/uint16 sources)")))
    return out


def check_distance_plane(max_chunks: int, fuse_k: int) -> list:
    """The d-plane stores ``base + k`` elementary-step indices in int32."""
    out = []
    max_d = int(max_chunks) * int(fuse_k)
    if max_d > np.iinfo(np.int32).max:
        out.append(Finding(
            "dtype", ERROR, "qdt distance plane",
            f"max distance index {max_d} (max_chunks={max_chunks} × "
            f"fuse_k={fuse_k}) overflows the int32 d-plane"))
    return out


def check_executable_dtypes(exe) -> list:
    """Dtype facts bound to one executable: QDT accumulation for its
    image dtype and d-plane headroom for its chunk budget
    (``Executable._budget_qdt``, the chunks the scheduler allows)."""
    out = []
    dt = _np(exe.dtype)
    if dt.name not in SUPPORTED_DTYPES:
        out.append(Finding(
            "dtype", WARN, f"dtype {dt.name}",
            f"outside the audited set {SUPPORTED_DTYPES}"))
    if any(s.kind == "qdt" for s in exe.program.segments):
        out += check_qdt_accumulator(dt)
        if exe.plan is not None:
            out += check_distance_plane(exe._budget_qdt(exe.plan),
                                        exe.plan.fuse_k)
    if (dt.kind != "f"
            and any(s.kind == "gdt" for s in exe.program.segments)):
        out.append(Finding(
            "dtype", ERROR, f"gdt on {dt.name}",
            "the generalised geodesic distance plane is a float lattice "
            "(+inf pad identity, fractional grey weights) — integer "
            "images must be cast to a float dtype before compilation"))
    return out
