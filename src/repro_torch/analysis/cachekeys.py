"""Cache-key completeness (check class d; port of
``repro.analysis.cachekeys``).

``Executable.key`` is simultaneously the compile-cache key and the
``repro_torch.serve`` bucket/cache identity; ``ChainPlan.key`` is its
schedule component.  A key that ignores a lowering-relevant field
serves *stale programs*: two distinct compilations collide and one
silently answers for the other (the bug class ``serve/cache.py`` has
no other defence against).

The check is mutation-based but static: structurally perturb each
field that can change what a call computes — every ``ChainPlan``
dataclass field, every run-phase component of the lowered ``Program``
(segment kinds/params/srcs/dsts, fills, input slots, outputs) and
every binding of the ``Executable`` (shape, dtype, backend,
``max_chunks``, ``was_2d``, plan, and the port's device: ``cpu``
against ``cuda``, whose executables run different code) — rebuild the
key, and require it to move.  Fields deliberately *outside* the run
signature (the root ``expr``, prepare/finalize graphs) are not
perturbed: excluding them is what lets HMAX and DOME co-batch, and the
compile cache keys on the expression graph itself so they cannot go
stale.

``key_of`` is injectable so the self-tests can hand in a broken key
function and assert the checker reports the gap.
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.findings import ERROR, Finding

__all__ = ["check_plan_key", "check_executable_key",
           "perturb_plan", "perturb_program"]


def _bump(value):
    """A same-type structurally different value."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if isinstance(value, float):
        return value + 0.125 if value < 1.0 else value - 0.125
    if isinstance(value, str):
        return value + "_x"
    if isinstance(value, tuple):
        return (*value, "_x")
    return ("_perturbed", value)


def _forge_plan(plan, field: str):
    """A copy of ``plan`` with one field changed, bypassing
    ``__post_init__`` (the perturbed plan need not be valid — only its
    key must differ)."""
    cls = type(plan)
    mutant = object.__new__(cls)
    for f in dataclasses.fields(cls):
        value = getattr(plan, f.name)
        object.__setattr__(mutant, f.name,
                           _bump(value) if f.name == field else value)
    return mutant


def perturb_plan(plan):
    """Yield ``(field_name, mutant_plan)`` for every dataclass field —
    enumerated dynamically so a field added later is covered without
    touching this module."""
    for f in dataclasses.fields(type(plan)):
        yield f.name, _forge_plan(plan, f.name)


def check_plan_key(plan, key_of=None) -> list:
    key_of = key_of or (lambda p: p.key)
    base = key_of(plan)
    out = []
    for field, mutant in perturb_plan(plan):
        if key_of(mutant) == base:
            out.append(Finding(
                "cache-key", ERROR, "ChainPlan.key",
                f"insensitive to field {field!r} — two plans differing "
                "only there collide in every compiled-program cache"))
    return out


def _perturb_params(params: tuple):
    if not params:
        return (("_perturbed", 1),)
    name, value = params[0]
    swap = {"erode": "dilate", "dilate": "erode",
            "hi": "lo", "lo": "hi"}
    new = swap.get(value, _bump(value))
    return ((name, new), *params[1:])


def perturb_program(program):
    """Yield ``(description, mutant_program)`` covering every run-phase
    component.  Mutants are built with :func:`dataclasses.replace`, so
    they are real ``Program`` instances (possibly semantically invalid
    — irrelevant: only key sensitivity is under test)."""
    for i, seg in enumerate(program.segments):
        segs = list(program.segments)
        segs[i] = dataclasses.replace(seg, params=_perturb_params(seg.params))
        yield (f"segments[{i}].params",
               dataclasses.replace(program, segments=tuple(segs)))
        if seg.srcs:
            segs = list(program.segments)
            segs[i] = dataclasses.replace(
                seg, srcs=tuple(s + 1000 for s in seg.srcs))
            yield (f"segments[{i}].srcs",
                   dataclasses.replace(program, segments=tuple(segs)))
        if seg.dsts:
            segs = list(program.segments)
            segs[i] = dataclasses.replace(
                seg, dsts=tuple(d + 1000 for d in seg.dsts))
            yield (f"segments[{i}].dsts",
                   dataclasses.replace(program, segments=tuple(segs)))
        segs = list(program.segments)
        segs[i] = dataclasses.replace(
            seg, kind="geodesic" if seg.kind != "geodesic" else "chain")
        yield (f"segments[{i}].kind",
               dataclasses.replace(program, segments=tuple(segs)))
    if program.run_fills:
        flipped = ("lo" if program.run_fills[0] == "hi" else "hi",
                   *program.run_fills[1:])
        yield ("run_fills", dataclasses.replace(program, run_fills=flipped))
    if program.run_input_slots:
        shifted = (program.run_input_slots[0] + 1000,
                   *program.run_input_slots[1:])
        yield ("run_input_slots",
               dataclasses.replace(program, run_input_slots=shifted))
    if program.run_outputs:
        shifted = (program.run_outputs[0] + 1000, *program.run_outputs[1:])
        yield ("run_outputs",
               dataclasses.replace(program, run_outputs=shifted))


def check_executable_key(exe, key_of=None) -> list:
    """Perturb every lowering-relevant field feeding ``Executable.key``
    and assert the key changes."""
    import torch

    from repro_torch.api.executable import Executable

    key_of = key_of or (lambda e: e.key)
    shape3 = (exe.n_images, exe.height, exe.width)

    def rebuild(program=None, shape3_=None, dtype=None, backend=None,
                plan="same", max_chunks="same", was_2d=None, device=None):
        return Executable(
            program if program is not None else exe.program,
            shape3_ if shape3_ is not None else shape3,
            dtype if dtype is not None else exe.dtype,
            backend if backend is not None else exe.backend,
            exe.plan if plan == "same" else plan,
            exe.max_chunks if max_chunks == "same" else max_chunks,
            exe.was_2d if was_2d is None else was_2d,
            device if device is not None else exe.device,
        )

    base = key_of(rebuild())
    mutants = []
    for desc, prog in perturb_program(exe.program):
        mutants.append((f"program.{desc}", rebuild(program=prog)))
    for axis in range(3):
        s = tuple(v + (8 if i == axis else 0) for i, v in enumerate(shape3))
        mutants.append((f"shape3[{axis}]", rebuild(shape3_=s)))
    other_dt = torch.uint16 if exe.dtype != torch.uint16 else torch.uint8
    mutants.append(("dtype", rebuild(dtype=other_dt)))
    mutants.append(("backend",
                    rebuild(backend=exe.backend + "_x")))
    mutants.append(("was_2d", rebuild(was_2d=not exe.was_2d)))
    mutants.append(("max_chunks",
                    rebuild(max_chunks=(exe.max_chunks or 0) + 17)))
    other_dev = "cuda" if exe.device.type == "cpu" else "cpu"
    mutants.append(("device", rebuild(device=torch.device(other_dev))))
    if exe.plan is not None:
        for field, plan in perturb_plan(exe.plan):
            mutants.append((f"plan.{field}", rebuild(plan=plan)))

    out = []
    for desc, mutant in mutants:
        if key_of(mutant) == base:
            out.append(Finding(
                "cache-key", ERROR, "Executable.key",
                f"insensitive to {desc} — distinct compilations would "
                "collide in the compile cache and the serve "
                "compiled-program cache"))
    return out
