"""Halo-coverage proof over lowered run programs (check class a; port
of ``repro.analysis.halo``, on ``repro_torch.api.lower.Program``).

The padded engine's exactness rests on two disciplines the lowering and
planner are supposed to maintain; this module re-proves both from the
:class:`~repro.api.lower.Program` alone, **independently** of the
``_Lowerer`` bookkeeping that produced it:

**Pad-state discipline.**  Every kernel segment consumes its operands
with the pad region holding that op's absorbing identity ("hi" = +top
for erosion-family, "lo" = -bottom for dilation-family).  The checker
runs an abstract interpreter over the segment list: canonical inputs
start at their declared ``run_fills``; a masked ``refill`` segment
resets a slot's pad to a named identity; a kernel segment's output pad
is *evolved(ident)* — the identity-extension image evolved by the op,
which remains absorbing for further same-identity kernels but for
nothing else.  Consuming a slot whose pad state is neither the required
identity nor evolved(required identity) is an ERROR: values could leak
through the pad (exactly the bug class a dropped or wrong-fill refill
segment introduces).

**Reach coverage.**  A fused segment of ``n`` elementary filters has
Chebyshev reach ``n``.  Per kernel launch the schedule provides
``fuse_k`` halo rows/cols (each CUDA block's window is its sub-tile and
``fuse_k`` pixels around it, proved by ``repro_torch.analysis.indexmaps``)
and runs ``fuse_k`` elementary steps, so
per-launch reach never exceeds the halo; across launches the plan's
``n_chunks`` must cover the longest fixed chain
(``n_chunks · fuse_k ≥ n``).  The masked pad-refill segments between
kernel segments are part of the proof: they are what resets the pad
between identities so per-launch coverage composes.

Also proved here: program well-formedness (slot def-before-use, single
assignment, canonical input binding) — the invariant class that catches
input slots bound by position instead of by ``run_input_slots``.
"""
from __future__ import annotations

from repro_torch.analysis.findings import ERROR, WARN, Finding

#: Absorbing identity each op requires in its operands' pad region —
#: re-derived from lattice algebra (erosion = min-op, absorbed by the
#: lattice top; dilation = max-op, absorbed by the bottom), on purpose
#: not imported from ``api.lower`` so the two derivations cross-check.
REQUIRED_FILL = {"erode": "hi", "dilate": "lo"}

_KINDS = ("chain", "geodesic", "reconstruct", "qdt", "gdt", "refill",
          "point")


def _evolved(fill: str) -> tuple:
    return ("evolved", fill)


def _seg_name(i: int, seg) -> str:
    return f"segment {i} ({seg.short()})"


def segment_reach(seg) -> int | None:
    """Chebyshev reach (pixels of influence) of one kernel segment;
    None for convergence-driven segments (reach = iterations to
    convergence, unbounded statically).  Raises on a kind this proof
    does not know — silently assuming 0 reach for a new segment kind
    would under-cover its halo."""
    if seg.kind == "chain":
        return int(seg.param("n"))
    if seg.kind == "geodesic":
        # the geodesic clamp is pointwise: reach equals the chain's
        return int(seg.param("n"))
    if seg.kind in ("reconstruct", "qdt", "gdt"):
        return None
    if seg.kind in ("refill", "point"):
        return 0  # pointwise: masked fill / elementwise expression
    raise ValueError(
        f"segment_reach: unknown segment kind {seg.kind!r} — teach the "
        "halo proof its reach before lowering it"
    )


def check_program(program) -> list:
    """Well-formedness + pad-state discipline of one lowered program."""
    out = []

    def err(subject, message):
        out.append(Finding("halo", ERROR, subject, message))

    fills = program.run_fills
    slots = program.run_input_slots
    if len(fills) != len(slots) or len(fills) != len(program.prepare):
        err("inputs",
            f"canonical input arity mismatch: {len(program.prepare)} "
            f"prepare exprs, {len(fills)} fills, {len(slots)} slots")
        return out
    if len(set(slots)) != len(slots):
        err("inputs", f"duplicate canonical input slots {slots}")
        return out

    # abstract pad state per defined slot
    state: dict[int, object] = {}
    for slot, fill in zip(slots, fills):
        if fill not in ("hi", "lo"):
            err("inputs", f"slot {slot}: unknown pad fill {fill!r}")
        state[slot] = fill

    for i, seg in enumerate(program.segments):
        name = _seg_name(i, seg)
        if seg.kind not in _KINDS:
            err(name, f"unknown segment kind {seg.kind!r}")
            continue
        for s in seg.srcs:
            if s not in state:
                err(name, f"reads slot {s} before any definition — "
                          "canonical inputs must bind through "
                          "run_input_slots")
        for d in seg.dsts:
            if d in state:
                err(name, f"writes slot {d}, which is already live "
                          "(single-assignment violated; a canonical "
                          "input or earlier segment output would be "
                          "clobbered)")
        if any(s not in state for s in seg.srcs):
            # cannot track pad state through an undefined read
            for d in seg.dsts:
                state[d] = None
            continue

        if seg.kind == "refill":
            fill = seg.param("fill")
            if fill not in ("hi", "lo"):
                err(name, f"refill to unknown identity {fill!r}")
            state[seg.dsts[0]] = fill
            continue

        if seg.kind == "point":
            if len(seg.dsts) != 1 or not seg.srcs:
                err(name, f"arity: expected ≥1 srcs/1 dst, got "
                          f"{len(seg.srcs)}/{len(seg.dsts)}")
            # elementwise on the padded planes: the pad region computes
            # from whatever fills the operands carry — poison the
            # output so a kernel consumer must refill first
            for d in seg.dsts:
                state[d] = None
            continue

        if seg.kind == "gdt":
            if len(seg.srcs) != 2 or len(seg.dsts) != 1:
                err(name, f"arity: expected 2 srcs/1 dst, got "
                          f"{len(seg.srcs)}/{len(seg.dsts)}")
            for s in seg.srcs:
                got = state.get(s)
                if got != "lo":
                    err(name,
                        f"operand slot {s} pad state is {got!r} but "
                        "gdt's pad detection keys on the exact "
                        "lattice-bottom fill 'lo' (−inf) — an evolved "
                        "or foreign pad would be misclassified as "
                        "image cells")
            # distance plane: pad holds +inf distances, absorbing for
            # nothing — poison it like the qdt outputs.
            for d in seg.dsts:
                state[d] = None
            continue

        if seg.kind == "qdt":
            need = "hi"  # QDT iterates erosion
            n_srcs, n_dsts = 1, 2
        elif seg.kind == "chain":
            need = REQUIRED_FILL.get(seg.param("op"))
            n_srcs, n_dsts = 1, 1
        else:  # geodesic / reconstruct
            need = REQUIRED_FILL.get(seg.param("op"))
            n_srcs, n_dsts = 2, 1
        if need is None:
            err(name, f"unknown op {seg.param('op')!r}")
            for d in seg.dsts:
                state[d] = None
            continue
        if len(seg.srcs) != n_srcs or len(seg.dsts) != n_dsts:
            err(name, f"arity: expected {n_srcs} srcs/{n_dsts} dsts, "
                      f"got {len(seg.srcs)}/{len(seg.dsts)}")
        if seg.kind == "chain" and int(seg.param("n")) < 1:
            err(name, f"chain length {seg.param('n')} < 1")
        for s in seg.srcs:
            got = state.get(s)
            if got != need and got != _evolved(need):
                err(name,
                    f"operand slot {s} pad state is {got!r} but the "
                    f"{seg.kind} requires the absorbing identity "
                    f"{need!r} — values can leak through the pad "
                    "(missing or wrong masked refill segment)")
        for d in seg.dsts:
            state[d] = _evolved(need)
        if seg.kind == "qdt":
            # d/r planes: pad holds distances/residuals, absorbing for
            # nothing — poison them so any downstream consumer errors.
            for d in seg.dsts:
                state[d] = None

    for s in program.run_outputs:
        if s not in state:
            out.append(Finding("halo", ERROR, "outputs",
                               f"run output slot {s} is never defined"))

    n_kernel = len(program.kernel_segments)
    if program.pad_safe != (n_kernel == 1):
        out.append(Finding(
            "halo", ERROR, "pad_safe",
            f"pad_safe={program.pad_safe} but the program has "
            f"{n_kernel} kernel segments — bucket padding would be "
            f"{'unsound' if program.pad_safe else 'needlessly exact-shape'}"
        ))
    return out


def check_coverage(program, plan, shape3=None, segments=None,
                   convergent=None) -> list:
    """Reach coverage of ``program`` under ``plan`` (cuda schedule).

    ``plan`` provides ``fuse_k`` halo rows per launch and runs
    ``fuse_k`` elementary steps per launch — per-launch reach is covered
    by construction; what can drift is the *cross-launch* accounting:
    the plan's ``n_chunks`` under-covering the longest fixed chain, or
    the plan not covering the bound image at all.

    ``segments``/``convergent`` restrict the check to one plan group of
    a specialized executable (``Executable.seg_plans``): the group's
    segment subset is proved against the group's own plan.  Defaults
    cover the whole program under its single shared plan.
    """
    out = []
    if plan is None:
        return out
    if segments is None:
        segments = program.segments
    if convergent is None:
        convergent = program.convergent
    if shape3 is not None:
        n, h, w = shape3
        if plan.n_images != n:
            out.append(Finding("halo", ERROR, "plan/shape",
                               f"plan.n_images={plan.n_images} != batch "
                               f"size {n}"))
        if plan.height_pad < h or plan.width_pad < w:
            out.append(Finding(
                "halo", ERROR, "plan/shape",
                f"plan pads ({plan.height_pad}, {plan.width_pad}) do not "
                f"cover the image ({h}, {w}) — the crop would read "
                "identity fill"))
    reaches = [r for s in segments
               if (r := segment_reach(s)) is not None and s.kind != "refill"]
    max_reach = max(reaches, default=0)
    if not convergent and max_reach:
        covered = plan.n_chunks * plan.fuse_k
        if covered < max_reach:
            out.append(Finding(
                "halo", WARN, "plan/chunks",
                f"plan.n_chunks={plan.n_chunks} × fuse_k={plan.fuse_k} "
                f"= {covered} < longest fixed chain {max_reach} — the "
                "advisory launch count under-covers the declared "
                "Chebyshev reach (stale plan for this program)"))
    # per-launch: steps per launch never exceed the declared halo
    per_launch = min(max_reach, plan.fuse_k) if max_reach else 0
    if per_launch > plan.fuse_k:  # pragma: no cover - min() forbids it
        out.append(Finding(
            "halo", ERROR, "plan/halo",
            f"{per_launch} elementary steps per launch exceed the "
            f"declared {plan.fuse_k}-row halo"))
    return out
