"""``repro_torch.gdt`` — the generalised geodesic distance subsystem
(port of ``repro.gdt``).

Grey-weighted geodesic distance (DTOCS-style additive cost
``w(p, q) = 1 + λ·|I(p) − I(q)|`` over the 8-neighbourhood) from soft
seeds ``D0 = ν·(1 − clip(S, 0, 1))``, plus the segmentation composites
built on it:

``gdt`` / ``gdt_expr``
    the transform itself — eager entry point (on ``device``, ``None``
    being the GPU) and expression builder (``E.gdt`` sugar).  ``λ = 0``
    reduces it to the Chebyshev distance to the seed set, the bridge to
    the L1 QDT on binary images.
``seg_scribble_expr``
    two-seed scribble segmentation: foreground where the distance to
    the background scribbles is at least the distance to the foreground
    scribbles (two gdt segments over one image, compared in the
    finalize phase).
``seg_hmin_expr``
    h-minima-seeded propagation: the seed plane is derived *between
    kernels* (reconstruction by erosion → pointwise ``point`` segments
    → gdt).

``gdt_reference`` is the pure-NumPy Jacobi oracle every schedule (the
wavefront requeue scheduler, the raster sweeps, the ``"torch"``
engine's fixpoint) is bit-exact against.  The reference's
``SERVE_OPS`` waits for the port of serving.
"""
from __future__ import annotations

from repro_torch.api import E
from repro_torch.gdt.reference import gdt_reference

__all__ = ["gdt", "gdt_expr", "gdt_reference", "seg_hmin_expr",
           "seg_scribble_expr"]


def gdt(image, seeds, lamb: float = 1.0, nu: float = 1e6, **kw):
    """Eager generalised geodesic distance (see ``kernels.ops.gdt``;
    ``device=None`` is the GPU)."""
    from repro_torch.kernels.ops import gdt as _gdt

    return _gdt(image, seeds, lamb=lamb, nu=nu, **kw)


def gdt_expr(image, seeds, lamb: float = 1.0, nu: float = 1e6):
    """Expression builder: ``E.gdt`` with the package's defaults."""
    return E.gdt(image, seeds, lamb=lamb, nu=nu)


def seg_scribble_expr(lamb: float = 1.0, nu: float = 1e6):
    """Scribble segmentation over inputs ``image`` and ``scribbles``.

    ``scribbles`` encodes both seed sets in one plane: 0 = unmarked,
    1 = foreground, 2 = background.  The result is the foreground
    indicator: 1.0 where the geodesic distance to the background
    scribbles is at least the distance to the foreground scribbles.
    Lowers to two gdt kernel segments over one shared image with the
    comparison in the finalize phase.
    """
    f = E.input("image")
    s = E.input("scribbles")
    fg = E.sub(E.ge(s, 1.0), E.ge(s, 2.0))   # exactly the 1-labelled cells
    bg = E.ge(s, 2.0)
    d_fg = E.gdt(f, fg, lamb=lamb, nu=nu)
    d_bg = E.gdt(f, bg, lamb=lamb, nu=nu)
    return E.ge(E.sub(d_bg, d_fg), 0.0)


def seg_hmin_expr(h: float, lamb: float = 1.0, nu: float = 1e6):
    """h-minima-seeded geodesic propagation over input ``image``.

    Seeds are the h-minima indicator of the image — cells whose
    reconstruction by erosion of ``image + h`` over ``image`` still sits
    ``h`` above the image — fed straight into the gdt.  The seed
    derivation sits *between* two kernel segments, so it lowers to
    ``point`` segments bridging the reconstruction to the gdt.
    """
    if h <= 0:
        raise ValueError(f"h={h} must be > 0")
    f = E.input("image")
    hmin = E.reconstruct(E.sat_add(f, h), f, op="erode")
    seeds = E.ge(E.sub(hmin, f), float(h))
    return E.gdt(f, seeds, lamb=lamb, nu=nu)
