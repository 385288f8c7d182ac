"""Lowering: expression DAG → three-phase :class:`Program` (port of
``repro.api.lower``; the lowering is the reference's, line for line,
and ``eval_pointwise`` evaluates with torch).

``prepare``
    pointwise / per-image sub-expressions whose transitive dependencies
    are input leaves only — marker derivation.  Evaluated *unpadded*
    (per-image reductions like ``hfill_marker`` must never see
    padding), producing the program's canonical run inputs.
``run``
    the padded kernel program: a linear list of :class:`RunSeg`
    register-machine segments over padded, vertically stacked slots.
    Adjacent same-op erode/dilate runs are fused into one ``chain``
    segment; intermediates stay padded across segments — when a
    consumer needs a different absorbing identity in the pad region
    than the producer left there, a cheap masked ``refill`` segment is
    inserted instead of a crop/re-pad round-trip.  One
    :class:`~repro_torch.core.chain.ChainPlan` schedules every segment.
``finalize``
    the pointwise remainder of the graph, evaluated on the *cropped*
    run outputs plus the original inputs (residuals like DOME's
    ``f - hmax``, the QDT η-regularization).

``Program.run_sig`` is the hashable identity of the run phase alone —
two operators whose run phases lower identically (e.g. HMAX and DOME,
whose difference is pure prepare/finalize) share it.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.api.expr import E, Expr, KERNEL_KINDS
from repro_torch.core import operators as OPS

#: Absorbing pad identity each kernel consumer requires of an operand.
_IDENT = {"erode": "hi", "dilate": "lo"}

#: Same-shaped operand planes each segment kind keeps resident (drives
#: the shared ChainPlan's ``n_images_resident``, as in the reference).
_RESIDENT = {"chain": 1, "geodesic": 2, "reconstruct": 2, "qdt": 3,
             "gdt": 3, "point": 1}

#: Pointwise kinds a ``point`` run segment may contain: strictly
#: elementwise maps, safe to evaluate on padded slots (the pad region
#: comes out dirty and the dst's ``None`` pad state forces a refill
#: before any kernel consumer).  Per-image reductions
#: (``hfill_marker``/``raobj_marker``) and crop-contract nodes
#: (``qdt_regularize``) stay un-lowerable between kernels.
_POINT_KINDS = ("sat_sub", "sat_add", "sub", "ge")


@dataclasses.dataclass(frozen=True)
class RunSeg:
    """One run-phase segment: reads ``srcs`` slots, writes ``dsts``."""

    kind: str       # "chain" | "geodesic" | "reconstruct" | "qdt" | "gdt"
                    # | "point" | "refill"
    srcs: tuple
    dsts: tuple
    params: tuple   # sorted (name, value) pairs

    def param(self, name):
        return dict(self.params)[name]

    def short(self) -> str:
        p = dict(self.params)
        if self.kind == "chain":
            return f"{p['op'][:2]}{p['n']}"
        if self.kind == "refill":
            return f"rf:{p['fill']}"
        if self.kind == "point":
            return "pt"
        tag = ":".join(str(v) for _, v in self.params)
        return f"{self.kind[:3]}{':' + tag if tag else ''}"


@dataclasses.dataclass(frozen=True)
class Program:
    """A lowered expression: prepare exprs, run segments, finalize root."""

    expr: Expr                       # the root expression (finalize walks it)
    input_names: tuple               # user-facing leaves, DFS-preorder
    prepare: tuple                   # pre-Expr per canonical run input
    run_fills: tuple                 # "hi"/"lo" per canonical run input
    run_input_slots: tuple           # slot id per canonical run input
    segments: tuple                  # RunSeg, in execution order
    run_outputs: tuple               # slot ids cropped and handed to finalize
    kernel_outputs: tuple            # ((kernel Expr, out_idx, slot), ...)
    n_outputs: int

    @property
    def run_sig(self) -> tuple:
        """Hashable identity of the run phase (bucket/cache keying)."""
        return (
            ("in", self.run_input_slots, self.run_fills),
            *((s.kind, s.params, s.srcs, s.dsts) for s in self.segments),
            ("out", self.run_outputs),
        )

    @property
    def kernel_segments(self) -> tuple:
        """True padded-kernel segments: refills are plumbing and
        ``point`` segments are exact on the real region by construction
        (strictly elementwise), so neither counts against pad safety."""
        return tuple(s for s in self.segments
                     if s.kind not in ("refill", "point"))

    @property
    def pad_safe(self) -> bool:
        """Whether enlarging the image with each canonical input's fill
        is exact end-to-end: true exactly for single-phase programs (one
        kernel segment); multi-phase programs mix identities, so no
        single bucket fill is absorbing across them."""
        return len(self.kernel_segments) == 1

    @property
    def convergent(self) -> bool:
        return any(s.kind in ("reconstruct", "qdt", "gdt")
                   for s in self.segments)

    @property
    def n_resident(self) -> int:
        return max((_RESIDENT.get(s.kind, 1) for s in self.segments),
                   default=1)

    @property
    def max_chain_len(self) -> int | None:
        lens = [s.param("n") for s in self.segments if s.kind == "chain"]
        return max(lens) if lens else None

    @property
    def fused_chain_len(self) -> int:
        """Total elementary fixed-chain filters across chain segments."""
        return sum(s.param("n") for s in self.segments if s.kind == "chain")

    def sig_label(self) -> str:
        """Compact human-readable run signature (metrics bucket labels)."""
        segs = [s.short() for s in self.segments if s.kind != "refill"]
        if not segs:
            return "pointwise"
        if len(segs) > 4:
            segs = segs[:3] + [f"+{len(segs) - 3}"]
        return "-".join(segs)

    def result_exprs(self) -> tuple:
        """The root split into single-output expressions."""
        if self.expr.kind in KERNEL_KINDS and self.expr.n_outputs > 1:
            return tuple(E.pick(self.expr, i)
                         for i in range(self.expr.n_outputs))
        return (self.expr,)


class LoweringError(ValueError):
    """The expression cannot be split into prepare → run → finalize."""


def _consumer_counts(root: Expr) -> dict:
    counts: dict[Expr, int] = {}
    seen = set()
    stack = [root]
    while stack:
        node = stack.pop()
        for a in node.args:
            counts[a] = counts.get(a, 0) + 1
            if a not in seen:
                seen.add(a)
                stack.append(a)
    return counts


def _input_names(root: Expr) -> tuple:
    names, seen = [], set()

    def walk(node):
        if node in seen:
            return
        seen.add(node)
        if node.kind == "input":
            name = node.param("name")
            if name not in names:
                names.append(name)
        for a in node.args:
            walk(a)

    walk(root)
    return tuple(names)


@functools.lru_cache(maxsize=1024)
def _is_pre(node: Expr) -> bool:
    """True when the node is pointwise over input leaves only."""
    if node.kind in KERNEL_KINDS:
        return False
    return all(_is_pre(a) for a in node.args)


class _Lowerer:
    def __init__(self, root: Expr):
        self.root = root
        self.counts = _consumer_counts(root)
        self.segments: list[RunSeg] = []
        self.prepare: list[Expr] = []
        self.fills: list[str] = []
        self.input_slots: list[int] = []
        self.pre_slot: dict[Expr, int] = {}
        self.kernel_slots: dict[Expr, tuple] = {}
        self.point_slots: dict[Expr, int] = {}
        self.pad_state: dict[int, str | None] = {}
        self.refilled: dict[tuple, int] = {}
        self.next_slot = 0

    def _alloc(self, state):
        slot = self.next_slot
        self.next_slot += 1
        self.pad_state[slot] = state
        return slot

    def _operand(self, node: Expr, fill: str) -> int:
        """Slot holding ``node``'s value with pad region == ``fill``."""
        if _is_pre(node):
            slot = self.pre_slot.get(node)
            if slot is None:
                # NB: prepare slots are *not* guaranteed to be 0..n-1 —
                # a fresh prepare leaf first requested after a kernel
                # allocation (e.g. the mask of geodesic(erode(a), b))
                # lands on a later slot id, which is why the executable
                # binds canonical inputs through ``run_input_slots``.
                slot = self._alloc(fill)
                self.pre_slot[node] = slot
                self.prepare.append(node)
                self.fills.append(fill)
                self.input_slots.append(slot)
        elif node.kind in KERNEL_KINDS:
            slot = self._kernel(node)[0]
        elif node.kind == "pick" and node.args[0].kind in KERNEL_KINDS:
            slot = self._kernel(node.args[0])[node.param("i")]
        else:
            slot = self._point(node)
        if self.pad_state[slot] == fill:
            return slot
        refill = self.refilled.get((slot, fill))
        if refill is None:
            refill = self._alloc(fill)
            self.refilled[(slot, fill)] = refill
            self.segments.append(
                RunSeg("refill", (slot,), (refill,), (("fill", fill),))
            )
        return refill

    def _kernel(self, node: Expr) -> tuple:
        """Lower a kernel node (memoized); returns its output slots."""
        slots = self.kernel_slots.get(node)
        if slots is not None:
            return slots
        kind = node.kind
        if kind in ("erode", "dilate"):
            # fuse the run of same-op ancestors this node tops, as long
            # as each intermediate has no other consumer
            total, child = node.param("s"), node.args[0]
            while (child.kind == kind and self.counts.get(child, 0) == 1):
                total += child.param("s")
                child = child.args[0]
            src = self._operand(child, _IDENT[kind])
            dst = self._alloc(None)
            seg = RunSeg("chain", (src,), (dst,),
                         (("n", total), ("op", kind)))
            slots = (dst,)
        elif kind in ("reconstruct", "geodesic"):
            fill = _IDENT[node.param("op")]
            msrc = self._operand(node.args[0], fill)
            ksrc = self._operand(node.args[1], fill)
            dst = self._alloc(None)
            seg = RunSeg(kind, (msrc, ksrc), (dst,), node.params)
            slots = (dst,)
        elif kind == "qdt":
            src = self._operand(node.args[0], "hi")
            d_slot, r_slot = self._alloc(None), self._alloc(None)
            seg = RunSeg("qdt", (src,), (d_slot, r_slot), ())
            slots = (d_slot, r_slot)
        elif kind == "gdt":
            # Both operands pad with the float lattice bottom (−inf):
            # the driver's ``gdt_stage`` reads it back as the pad marker
            # and derives the sanitized resident planes from it.
            isrc = self._operand(node.args[0], "lo")
            ssrc = self._operand(node.args[1], "lo")
            dst = self._alloc(None)
            seg = RunSeg("gdt", (isrc, ssrc), (dst,), node.params)
            slots = (dst,)
        else:  # pragma: no cover - Expr.__post_init__ guards kinds
            raise LoweringError(f"unhandled kernel kind {kind!r}")
        self.segments.append(seg)
        self.kernel_slots[node] = slots
        return slots

    def _point(self, node: Expr) -> int:
        """Lower a strictly-pointwise expression over kernel outputs as
        one ``point`` run segment (memoized).

        The segment's single param is a *relative* expression whose
        leaves ``__p0 … __pn`` bind to ``srcs`` in order; the executable
        evaluates it elementwise on the padded slots.  The dst's pad
        region is dirty (``None`` state), so the ordinary refill
        machinery masks it before any kernel consumer reads it.
        """
        slot = self.point_slots.get(node)
        if slot is not None:
            return slot
        srcs: list[int] = []

        def rel(n: Expr) -> Expr:
            if n.kind in KERNEL_KINDS:
                src = self._kernel(n)[0]
            elif n.kind == "pick" and n.args[0].kind in KERNEL_KINDS:
                src = self._kernel(n.args[0])[n.param("i")]
            elif _is_pre(n):
                src = self._operand(n, "lo")
            else:
                if n.kind not in _POINT_KINDS:
                    raise LoweringError(
                        f"{n.kind} depends on a kernel output but is not "
                        "an elementwise map — it cannot run between "
                        "kernels (compute it as a separate compiled "
                        "expression)"
                    )
                return Expr(n.kind, tuple(rel(a) for a in n.args), n.params)
            if src not in srcs:
                srcs.append(src)
            return E.input(f"__p{srcs.index(src)}")

        expr = rel(node)
        dst = self._alloc(None)
        self.segments.append(
            RunSeg("point", tuple(srcs), (dst,), (("expr", expr),))
        )
        self.point_slots[node] = dst
        return dst

    def _collect_outputs(self, node: Expr, needed: list, seen: set):
        """Kernel outputs the finalize evaluation of ``node`` reads."""
        if node in seen:
            return
        seen.add(node)
        if node.kind in KERNEL_KINDS:
            slots = self._kernel(node)
            for i in range(node.n_outputs):
                if (node, i) not in needed:
                    needed.append((node, i))
            return
        if node.kind == "pick" and node.args[0].kind in KERNEL_KINDS:
            child, i = node.args[0], node.param("i")
            self._kernel(child)
            if (child, i) not in needed:
                needed.append((child, i))
            return
        for a in node.args:
            self._collect_outputs(a, needed, seen)

    def lower(self) -> Program:
        self._check_no_kernel_under_pointwise_operand(self.root)
        needed: list = []
        self._collect_outputs(self.root, needed, set())
        kernel_outputs = tuple(
            (node, i, self.kernel_slots[node][i]) for node, i in needed
        )
        return Program(
            expr=self.root,
            input_names=_input_names(self.root),
            prepare=tuple(self.prepare),
            run_fills=tuple(self.fills),
            run_input_slots=tuple(self.input_slots),
            segments=tuple(self.segments),
            run_outputs=tuple(slot for _, _, slot in kernel_outputs),
            kernel_outputs=kernel_outputs,
            n_outputs=self.root.n_outputs,
        )

    def _check_no_kernel_under_pointwise_operand(self, root: Expr):
        """Kernel operands must resolve to run slots: prepare values,
        (possibly picked) kernel outputs, or strictly-elementwise maps
        of those (lowered as ``point`` segments).  A *non*-elementwise
        pointwise node between kernels — a per-image reduction or a
        crop-contract node like ``qdt_regularize`` — has nowhere to run
        without leaving the padded program, so it raises here, before
        any slot is allocated."""
        seen = set()

        def check_point(n):
            # mirrors _point's recursion, validating without allocating
            if (n.kind in KERNEL_KINDS or _is_pre(n)
                    or (n.kind == "pick"
                        and n.args[0].kind in KERNEL_KINDS)):
                return
            if n.kind not in _POINT_KINDS:
                raise LoweringError(
                    f"{n.kind} depends on a kernel output but is not an "
                    "elementwise map — such pointwise stages between "
                    "kernels are not lowerable (compute it as a "
                    "separate compiled expression)"
                )
            for a in n.args:
                check_point(a)

        def walk(node):
            if node in seen:
                return
            seen.add(node)
            if node.kind in KERNEL_KINDS:
                for a in node.args:
                    check_point(a)
            for a in node.args:
                walk(a)

        walk(root)


@functools.lru_cache(maxsize=512)
def lower(expr: Expr) -> Program:
    """Lower ``expr`` into a :class:`Program` (memoized on the graph)."""
    return _Lowerer(expr).lower()


# ---------------------------------------------------------------------------
# pointwise evaluation (shared by prepare and finalize)
# ---------------------------------------------------------------------------


def eval_pointwise(node: Expr, inputs: dict, kernel_vals: dict, memo: dict):
    """Evaluate the pointwise region of the graph with torch.

    ``inputs`` maps leaf names to tensors; ``kernel_vals`` maps
    ``(kernel Expr, out_idx)`` to already-computed (cropped) tensors —
    empty for the prepare phase, whose exprs have no kernel deps.
    """
    if node in memo:
        return memo[node]
    kind = node.kind
    if kind in KERNEL_KINDS:
        val = kernel_vals[(node, 0)]
    elif kind == "pick":
        child = node.args[0]
        if child.kind in KERNEL_KINDS:
            val = kernel_vals[(child, node.param("i"))]
        else:  # pragma: no cover - pointwise nodes are single-output
            raise LoweringError(f"pick of single-output {child.kind}")
    elif kind == "input":
        val = inputs[node.param("name")]
    else:
        args = [eval_pointwise(a, inputs, kernel_vals, memo)
                for a in node.args]
        if kind == "sat_sub":
            val = OPS.sat_sub(args[0], node.param("h"))
        elif kind == "sat_add":
            val = OPS.sat_add(args[0], node.param("h"))
        elif kind == "sub":
            val = OPS.sub(args[0], args[1])
        elif kind == "ge":
            val = OPS.ge(args[0], node.param("t"))
        elif kind == "hfill_marker":
            val = OPS.hfill_marker(args[0])
        elif kind == "raobj_marker":
            val = OPS.raobj_marker(args[0])
        elif kind == "qdt_regularize":
            val = OPS.qdt_regularize(args[0])
        else:  # pragma: no cover - Expr.__post_init__ guards kinds
            raise LoweringError(f"unhandled pointwise kind {kind!r}")
    memo[node] = val
    return val
