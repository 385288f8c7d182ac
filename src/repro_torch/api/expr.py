"""Morphology expression graphs: every operator as a composable node.

A copy of ``repro.api.expr`` (pure Python, no framework), so that the
port shares the reference's graph vocabulary without importing it.

An :class:`Expr` is an immutable, hashable DAG node.  Leaves are named
inputs (``E.input("f")``); interior nodes are either *kernel* nodes —
erode/dilate chains, geodesic chains, reconstruction, the QDT — or
*pointwise* nodes (saturating arithmetic, residuals, marker
derivations, the QDT η-regularization).  The paper's composite
operators are then plain graph constructions::

    f = E.input("f")
    hmax   = E.reconstruct(E.sat_sub(f, 40), f, op="dilate")
    dome   = E.sub(f, hmax)
    obr    = E.reconstruct(f >> E.erode(4), f, op="dilate")
    asf2   = f >> E.erode(1) >> E.dilate(1) >> E.dilate(1) >> E.erode(1) \
               >> E.erode(2) >> E.dilate(2) >> E.dilate(2) >> E.erode(2)

``>>`` pipes a value through a unary constructor; unary constructors
called without their operand return a :class:`Pipe` so they compose
point-free (``E.erode(2) >> E.dilate(2)``).  Expressions carry no
shapes, dtypes or backends — those bind at
:func:`repro_torch.api.compile` time, which lowers the graph
(``repro_torch.api.lower``) into one padded program per compiled
:class:`~repro_torch.api.executable.Executable`.

Because an ``Expr`` is a frozen dataclass of hashables, it *is* the
cache key of the compile layer.
"""
from __future__ import annotations

import dataclasses

#: Node kinds executed inside the padded kernel program.
KERNEL_KINDS = ("erode", "dilate", "geodesic", "reconstruct", "qdt", "gdt")

#: Pointwise / per-image nodes, evaluated unpadded (prepare or finalize).
POINTWISE_KINDS = ("input", "sat_sub", "sat_add", "sub", "ge", "hfill_marker",
                   "raobj_marker", "qdt_regularize", "pick")

#: Outputs per node kind (1 unless listed).
OUT_ARITY = {"qdt": 2}


@dataclasses.dataclass(frozen=True)
class Expr:
    """One node of a morphology expression DAG.

    ``kind`` names the operation, ``args`` the child expressions and
    ``params`` the scalar parameters as sorted ``(name, value)`` pairs.
    Hashable by construction — equality is structural, which is exactly
    what the compile cache and the serve bucketer key on.
    """

    kind: str
    args: tuple = ()
    params: tuple = ()

    def __post_init__(self):
        if self.kind not in KERNEL_KINDS + POINTWISE_KINDS:
            raise ValueError(f"unknown expression kind {self.kind!r}")
        for a in self.args:
            if not isinstance(a, Expr):
                raise TypeError(
                    f"{self.kind}: expression arguments must be Expr, "
                    f"got {type(a).__name__}"
                )

    # -- sugar -------------------------------------------------------------

    def __rshift__(self, other):
        """``expr >> E.erode(2)``: pipe this value into a unary stage."""
        if isinstance(other, Pipe):
            return other(self)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Expr):
            return E.sub(self, other)
        return NotImplemented

    @property
    def n_outputs(self) -> int:
        return OUT_ARITY.get(self.kind, 1)

    def param(self, name):
        return dict(self.params)[name]

    def label(self) -> str:
        """Compact human-readable form (metrics / repr)."""
        p = ",".join(f"{k}={v}" for k, v in self.params)
        if self.kind == "input":
            return f"%{self.param('name')}"
        inner = ",".join(a.label() for a in self.args)
        sep = ";" if inner and p else ""
        return f"{self.kind}({inner}{sep}{p})"


@dataclasses.dataclass(frozen=True)
class Pipe:
    """A unary stage awaiting its operand (point-free composition)."""

    stages: tuple  # of callables Expr -> Expr, applied left to right

    def __call__(self, x: Expr) -> Expr:
        for stage in self.stages:
            x = stage(x)
        return x

    def __rshift__(self, other):
        if isinstance(other, Pipe):
            return Pipe(self.stages + other.stages)
        return NotImplemented


def _params(**kw) -> tuple:
    return tuple(sorted(kw.items()))


def _check_op(op: str) -> str:
    if op not in ("erode", "dilate"):
        raise ValueError(f"op must be 'erode' or 'dilate', got {op!r}")
    return op


class E:
    """Expression constructors — the public vocabulary of the API."""

    # -- leaves ------------------------------------------------------------

    @staticmethod
    def input(name: str = "f") -> Expr:
        return Expr("input", params=_params(name=str(name)))

    # -- kernel nodes ------------------------------------------------------

    @staticmethod
    def erode(s: int, x: Expr | None = None):
        """ε_s as a chain of s elementary 3×3 erosions (paper Eq. 4)."""
        if s < 0:
            raise ValueError(f"chain length must be >= 0, got {s}")
        if x is None:
            return Pipe((lambda v, s=s: E.erode(s, v),))
        return Expr("erode", (x,), _params(s=int(s))) if s else x

    @staticmethod
    def dilate(s: int, x: Expr | None = None):
        if s < 0:
            raise ValueError(f"chain length must be >= 0, got {s}")
        if x is None:
            return Pipe((lambda v, s=s: E.dilate(s, v),))
        return Expr("dilate", (x,), _params(s=int(s))) if s else x

    @staticmethod
    def opening(s: int, x: Expr | None = None):
        """γ_s = δ_s ∘ ε_s (a two-segment sub-graph, not a new kind)."""
        if x is None:
            return Pipe((lambda v, s=s: E.opening(s, v),))
        return E.dilate(s, E.erode(s, x))

    @staticmethod
    def closing(s: int, x: Expr | None = None):
        if x is None:
            return Pipe((lambda v, s=s: E.closing(s, v),))
        return E.erode(s, E.dilate(s, x))

    @staticmethod
    def geodesic(marker: Expr, mask: Expr, n: int, op: str = "erode") -> Expr:
        """n elementary geodesic steps (fixed length, Eq. 4)."""
        if n < 1:
            raise ValueError(f"geodesic chain length must be >= 1, got {n}")
        return Expr("geodesic", (marker, mask),
                    _params(n=int(n), op=_check_op(op)))

    @staticmethod
    def reconstruct(marker: Expr | None = None, mask: Expr | None = None,
                    op: str = "dilate"):
        """ε_rec / δ_rec to convergence (Eq. 5, Alg. 4).

        Fully applied with (marker, mask); with ``marker`` omitted it
        returns a pipe taking the marker: ``expr >> E.reconstruct(
        mask=f, op="dilate")``.
        """
        _check_op(op)
        if marker is None:
            if mask is None:
                raise ValueError("reconstruct needs at least a mask")
            return Pipe((lambda v, m=mask, o=op: E.reconstruct(v, m, o),))
        if mask is None:
            raise ValueError("reconstruct needs an explicit mask")
        return Expr("reconstruct", (marker, mask), _params(op=op))

    @staticmethod
    def qdt(x: Expr | None = None):
        """Raw quasi-distance planes d(f), r(f) (Eq. 13) — two outputs."""
        if x is None:
            return Pipe((lambda v: E.qdt(v),))
        return Expr("qdt", (x,))

    @staticmethod
    def gdt(image: Expr, seeds: Expr, lamb=1.0, nu=1e6) -> Expr:
        """Generalised geodesic distance transform (FastGeodis-style).

        The fixpoint of the grey-weighted relaxation over the 8-connected
        neighbourhood with additive DTOCS cost ``w(p, q) = 1 +
        lamb·|I(p) − I(q)|``, initialised from soft seeds ``S ∈ [0, 1]``
        as ``D₀ = nu·(1 − S)``.  ``lamb = 0`` degrades to the Chebyshev
        distance to the seed set; ``nu`` bounds the unseeded plateau.
        Float dtypes only (the distance plane is a float lattice).
        """
        if lamb < 0:
            raise ValueError(f"lamb must be >= 0, got {lamb}")
        if nu <= 0:
            raise ValueError(f"nu must be > 0, got {nu}")
        return Expr("gdt", (image, seeds),
                    _params(lamb=float(lamb), nu=float(nu)))

    # -- pointwise nodes ---------------------------------------------------

    @staticmethod
    def sat_sub(x: Expr, h) -> Expr:
        """x - h clamped to the dtype's range."""
        return Expr("sat_sub", (x,), _params(h=float(h)))

    @staticmethod
    def sat_add(x: Expr, h) -> Expr:
        return Expr("sat_add", (x,), _params(h=float(h)))

    @staticmethod
    def sub(a: Expr, b: Expr) -> Expr:
        """a - b (plain dtype arithmetic, e.g. DOME's residual)."""
        return Expr("sub", (a, b))

    @staticmethod
    def ge(x: Expr, t) -> Expr:
        """(x >= t) as 0/1 in x's dtype (thresholding / mask derivation)."""
        return Expr("ge", (x,), _params(t=float(t)))

    @staticmethod
    def hfill_marker(x: Expr) -> Expr:
        """m_HFILL (Eq. 9) — per-image reduction, unpadded by contract."""
        return Expr("hfill_marker", (x,))

    @staticmethod
    def raobj_marker(x: Expr) -> Expr:
        """m_RAOBJ (Eq. 11) — per-image reduction, unpadded by contract."""
        return Expr("raobj_marker", (x,))

    @staticmethod
    def qdt_regularize(d: Expr) -> Expr:
        """η-iteration (Eq. 14) until 1-Lipschitz (Eq. 15)."""
        return Expr("qdt_regularize", (d,))

    @staticmethod
    def pick(x: Expr, i: int) -> Expr:
        """Select output ``i`` of a multi-output node (the QDT planes).

        Normalizing: picking the only output of a single-output node is
        the node itself, so ``pick(pick(qdt(f), 0), 0)`` collapses and
        every consumer sees one canonical graph.
        """
        if not 0 <= i < x.n_outputs:
            raise ValueError(
                f"pick({i}) out of range for {x.kind} ({x.n_outputs} outputs)"
            )
        if x.n_outputs == 1:
            return x
        return Expr("pick", (x,), _params(i=int(i)))


# ---------------------------------------------------------------------------
# composite builders (operator sugar used by core.operators / repro.serve)
# ---------------------------------------------------------------------------


def hmax_expr(h, f: Expr | None = None) -> Expr:
    f = E.input("f") if f is None else f
    return E.reconstruct(E.sat_sub(f, h), f, op="dilate")


def dome_expr(h, f: Expr | None = None) -> Expr:
    f = E.input("f") if f is None else f
    return E.sub(f, hmax_expr(h, f))


def hfill_expr(f: Expr | None = None) -> Expr:
    f = E.input("f") if f is None else f
    return E.reconstruct(E.hfill_marker(f), f, op="erode")


def raobj_expr(f: Expr | None = None) -> Expr:
    f = E.input("f") if f is None else f
    return E.sub(f, E.reconstruct(E.raobj_marker(f), f, op="dilate"))


def opening_by_reconstruction_expr(s: int, f: Expr | None = None) -> Expr:
    """γ_rec^s: the erosion chain and the reconstruction share one
    padded program when compiled (the tentpole fusion case)."""
    f = E.input("f") if f is None else f
    return E.reconstruct(E.erode(s, f), f, op="dilate")


def asf_expr(s: int, f: Expr | None = None) -> Expr:
    """ASF_s (Eq. 20): alternating γ_k/φ_k — a 4s-stage chain whose
    adjacent same-op runs fuse into 2s+1 launches when lowered."""
    if s < 1:
        raise ValueError(f"ASF scale must be >= 1, got {s}")
    out = E.input("f") if f is None else f
    for k in range(1, s + 1):
        out = E.closing(k, E.opening(k, out))
    return out


def qdt_l1_expr(f: Expr | None = None) -> Expr:
    """L1-regularized quasi-distance transform d_L1(f)."""
    f = E.input("f") if f is None else f
    return E.qdt_regularize(E.pick(E.qdt(f), 0))
