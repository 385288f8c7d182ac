"""``compile(expr, shape, dtype, backend, device=...)`` — the one entry
that turns an expression graph into an
:class:`~repro_torch.api.executable.Executable` (port of
``repro.api.compile``).

Compilation first rewrites the graph with the expression optimizer
(``repro_torch.opt``, on by default as in the reference; ``rewrite=False``
compiles the source graph verbatim), then lowers the *canonical* graph
(``repro_torch.api.lower``) and binds one
:class:`~repro_torch.core.chain.ChainPlan` per plan group with the
reference's planner: a single-class program (all fixed chains, or all
convergent) shares one plan; a mixed program is specialized per
contiguous fixed/convergent group (``specialize=None`` auto,
``True``/``False`` force), with a re-band between groups.  A cache-miss
build then goes through the static verifier
(``repro_torch.analysis``) when ``verify=`` or ``REPRO_VERIFY`` asks for
it, as in the reference.

Executables are cached in a module-level LRU keyed on the canonical
graph plus the binding ``(shape, dtype, backend, plan, max_chunks,
specialize, device)``, so source graphs that are algebraically equal
share one compiled program; ``cache_stats()`` exposes the hit/miss
counters, with hits split into ``structural_hits`` (the same source
graph again) and ``shared_hits`` (another source graph with the same
canonical form).
"""
from __future__ import annotations

import collections
import threading

from repro_torch.api.executable import Executable
from repro_torch.api.expr import Expr, Pipe
from repro_torch.api.lower import _RESIDENT, lower
from repro_torch.core.backend import (as_dtype, canonicalize_backend,
                                      resolve_device)
from repro_torch.core.chain import plan_chain

#: Executables kept resident.
CACHE_CAPACITY = 512

#: Segment kinds whose work is convergence-driven (vs fixed-length).
_CONVERGENT_KINDS = ("reconstruct", "qdt", "gdt")

_cache: collections.OrderedDict = collections.OrderedDict()
_sources: dict = {}  # cache key → set of source Exprs that mapped to it
_lock = threading.Lock()
_hits = 0
_misses = 0
_structural_hits = 0
_shared_hits = 0


def compile(expr: Expr, shape, dtype, backend: str | None = None, *,
            plan=None, max_chunks: int | None = None,
            verify: bool | None = None, rewrite: bool = True,
            specialize: bool | None = None, device=None) -> Executable:
    """Lower ``expr`` and bind it to a concrete (shape, dtype, backend,
    device).

    ``shape`` is ``(H, W)`` (the executable then takes and returns 2-D
    tensors) or ``(N, H, W)`` for batched execution.  ``backend`` is
    ``"cuda"`` (the default: the padded, scheduled engine on the fused
    kernels) or ``"torch"`` (the unpadded oracle engine).  ``device``
    defaults to ``"cuda"`` and raises when no GPU is present; pass
    ``device="cpu"`` to run on the CPU, where the ``"cuda"`` engine's
    kernel wrappers run their plain PyTorch versions.  ``plan``
    overrides the derived plan (validated against the shape; disables
    per-group specialization); ``max_chunks`` caps the reconstructions'
    K-chunk iterations.  ``rewrite`` (default on) runs the expression
    optimizer first; ``rewrite=False`` compiles the source graph verbatim.

    ``verify`` controls the static verifier hook
    (``repro_torch.analysis.verifier:verify_executable`` at the cheap
    "fast" level, cache-miss builds only): ``None`` defers to the
    ``REPRO_VERIFY`` environment toggle (the test suite turns it on),
    ``True``/``False`` force it.  An ERROR-severity finding raises
    ``repro_torch.analysis.findings:VerificationError`` before the
    executable enters the cache.
    """
    if isinstance(expr, Pipe):
        raise TypeError(
            "got an unapplied pipe — apply it to an input first, e.g. "
            "E.input('f') >> E.erode(4)"
        )
    if not isinstance(expr, Expr):
        raise TypeError(f"expected an Expr, got {type(expr).__name__}")
    backend = canonicalize_backend(backend)
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:
        shape3, was_2d = (1, *shape), True
    elif len(shape) == 3:
        shape3, was_2d = shape, False
    else:
        raise ValueError(f"shape must be (H, W) or (N, H, W), got {shape}")
    dtype = as_dtype(dtype)

    if rewrite:
        # local import: repro_torch.opt sits between api.expr and
        # api.lower in the layering but imports lower's graph walkers
        from repro_torch.opt import rewrite_traced

        rewritten = rewrite_traced(expr)
        canonical, trace = rewritten.expr, rewritten.trace
    else:
        canonical, trace = expr, ()

    global _hits, _misses, _structural_hits, _shared_hits
    key = (canonical, shape3, was_2d, dtype, backend, plan, max_chunks,
           specialize, str(device))
    with _lock:
        exe = _cache.get(key)
        if exe is not None:
            _hits += 1
            seen = _sources.setdefault(key, set())
            if expr in seen:
                _structural_hits += 1
            else:
                _shared_hits += 1
                seen.add(expr)
            _cache.move_to_end(key)
            return exe
        _misses += 1

    exe = _build(canonical, shape3, was_2d, dtype, backend, plan,
                 max_chunks, specialize, device, trace)
    if verify or verify is None:
        # local import: analysis sits above api in the layering
        from repro_torch.analysis.verifier import (verify_executable,
                                                   verify_on_compile)

        if verify or verify_on_compile():
            verify_executable(exe, level="fast").raise_if_errors()
    with _lock:
        _cache[key] = exe
        _sources.setdefault(key, set()).add(expr)
        while len(_cache) > CACHE_CAPACITY:
            old_key, _ = _cache.popitem(last=False)
            _sources.pop(old_key, None)
    return exe


def segment_groups(program) -> tuple:
    """Partition ``program.segments`` into contiguous plan groups.

    Each group is ``(segment_indices, convergent)``: a maximal run of
    kernel segments of one work class — fixed-length (chain/geodesic)
    or convergence-driven (reconstruct) — plus the refill and ``point``
    segments that prepare operands for it (both attach to the *next*
    kernel segment; trailing ones join the last group).
    """
    groups: list = []
    current: list = []
    current_conv: bool | None = None
    pending: list = []  # refills/points awaiting their consumer's class
    for i, seg in enumerate(program.segments):
        if seg.kind in ("refill", "point"):
            pending.append(i)
            continue
        conv = seg.kind in _CONVERGENT_KINDS
        if current_conv is None or conv == current_conv:
            current.extend(pending)
            current.append(i)
            current_conv = conv
        else:
            groups.append((tuple(current), current_conv))
            current = [*pending, i]
            current_conv = conv
        pending = []
    if pending:
        current.extend(pending)
    if current:
        groups.append((tuple(current), bool(current_conv)))
    return tuple(groups)


def _group_plan(program, idxs, h, w, dtype, n, convergent):
    """One ChainPlan tuned to a single plan group's segments."""
    segs = [program.segments[i] for i in idxs]
    lens = [s.param("n") for s in segs if s.kind in ("chain", "geodesic")]
    resident = max((_RESIDENT.get(s.kind, 1) for s in segs), default=1)
    return plan_chain(
        h, w, dtype,
        None if convergent else (max(lens) if lens else None),
        n_images_resident=resident,
        n_images=n,
        convergent=convergent,
    )


def _build(expr, shape3, was_2d, dtype, backend, plan, max_chunks,
           specialize, device, trace):
    program = lower(expr)
    n, h, w = shape3
    if (not dtype.is_floating_point
            and any(s.kind == "gdt" for s in program.segments)):
        raise TypeError(
            f"gdt requires a float dtype (the distance plane is a float "
            f"lattice), got {dtype}"
        )
    if plan is not None:
        # a mismatched schedule is a caller bug on either engine
        if plan.n_images != n:
            raise ValueError(
                f"plan.n_images={plan.n_images} != batch size {n}"
            )
        if plan.height_pad < h or plan.width_pad < w:
            raise ValueError(
                f"plan pads ({plan.height_pad}, {plan.width_pad}) "
                f"smaller than image ({h}, {w})"
            )
    seg_plans = None
    if backend == "cuda" and program.kernel_segments:
        if plan is None:
            groups = segment_groups(program)
            if len(groups) > 1 and specialize is not False:
                seg_plans = tuple(
                    (idxs, _group_plan(program, idxs, h, w, dtype, n, conv))
                    for idxs, conv in groups
                )
                plan = seg_plans[0][1]
            else:
                lens = [s.param("n") for s in program.segments
                        if s.kind in ("chain", "geodesic")]
                plan = plan_chain(
                    h, w, dtype,
                    None if program.convergent
                    else (max(lens) if lens else None),
                    n_images_resident=program.n_resident,
                    n_images=n,
                    convergent=program.convergent,
                )
    else:
        plan = None  # the oracle engine runs unpadded
    return Executable(program, shape3, dtype, backend, plan, max_chunks,
                      was_2d, device, seg_plans=seg_plans,
                      rewrite_trace=trace)


def cache_stats() -> dict:
    """Compile-cache counters.

    ``hits`` splits into ``structural_hits`` — the very same source
    graph was compiled before — and ``shared_hits`` — a *different*
    source graph canonicalized to an already-compiled program (never
    counted as a miss)."""
    with _lock:
        total = _hits + _misses
        return {
            "entries": len(_cache),
            "capacity": CACHE_CAPACITY,
            "hits": _hits,
            "structural_hits": _structural_hits,
            "shared_hits": _shared_hits,
            "misses": _misses,
            "hit_rate": _hits / total if total else 0.0,
        }


def cached_executables() -> tuple:
    """Every executable the compile cache holds, least recently used
    first (``chip_smoke.py`` verifies each at the "full" level)."""
    with _lock:
        return tuple(_cache.values())


def clear_cache() -> None:
    global _hits, _misses, _structural_hits, _shared_hits
    with _lock:
        _cache.clear()
        _sources.clear()
        _hits = 0
        _misses = 0
        _structural_hits = 0
        _shared_hits = 0
