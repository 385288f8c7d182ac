"""Verification orchestration: one executable in, one report out (port
of ``repro.analysis.verifier``).

Three levels:

``fast``
    the always-on compile hook (``api/compile.py`` runs it on every
    cache-miss build when ``REPRO_VERIFY`` is enabled — the test suite
    turns it on in ``conftest.py``).  Pure-Python structural proofs
    only: program well-formedness + pad-state discipline, plan
    constraints and reach coverage (per plan group when the executable
    is specialized), executable-bound dtype facts.  No launch model, no
    key mutation.
``full``
    everything ``fast`` proves, plus the CUDA launchers' geometry over
    every launch the executable's segments make
    (``repro_torch.analysis.indexmaps``: a block shape exists and fits,
    every window reads inside its array and pins exactly the rows
    outside its image, the sub-tiles partition the output), in place
    of the reference's BlockSpec enumeration and Mosaic diagnostics,
    then the cache-key mutation sweeps.  This is what the lint CLI and
    the mutation self-tests run.
``sound``
    everything ``full`` proves, plus the rewrite soundness hook
    (``repro_torch.analysis.rewrites``): every optimizer rule
    application the executable was compiled with is replayed on
    randomized small inputs on the ``"torch"`` engine of the
    executable's own device and must be bit-exact.  The one level that
    *executes* anything — and only tiny oracle programs, never the
    compiled kernels under test.

Below ``sound``, the functions never execute the compiled program —
every fact is read off the lowered ``Program``, the ``ChainPlan`` and a
model of the launchers' address arithmetic.
"""
from __future__ import annotations

import os

from repro_torch.analysis import cachekeys, dtypes, halo, indexmaps, plans
from repro_torch.analysis.findings import Report

__all__ = ["verify_executable", "verify_on_compile", "LEVELS"]

LEVELS = ("fast", "full", "sound")


def verify_executable(exe, level: str = "fast") -> Report:
    """Statically verify one
    :class:`~repro_torch.api.executable.Executable`."""
    if level not in LEVELS:
        raise ValueError(f"level must be one of {LEVELS}, got {level!r}")
    shape3 = (exe.n_images, exe.height, exe.width)
    report = Report(subject=repr(exe))

    report.extend(halo.check_program(exe.program))
    report.extend(dtypes.check_executable_dtypes(exe))
    if exe.seg_plans is not None:
        segs = exe.program.segments
        for idxs, plan in exe.seg_plans:
            group = tuple(segs[i] for i in idxs)
            conv = any(s.kind in ("reconstruct", "qdt", "gdt")
                       for s in group)
            report.extend(plans.check_plan(plan, shape3))
            report.extend(halo.check_coverage(
                exe.program, plan, shape3, segments=group, convergent=conv))
    elif exe.plan is not None:
        report.extend(plans.check_plan(exe.plan, shape3))
        report.extend(halo.check_coverage(exe.program, exe.plan, shape3))

    if level in ("full", "sound"):
        report.extend(indexmaps.check_executable_launches(exe))
        for plan in exe.all_plans:
            report.extend(cachekeys.check_plan_key(plan))
        report.extend(cachekeys.check_executable_key(exe))

    if level == "sound" and exe.rewrite_trace:
        from repro_torch.analysis import rewrites

        report.extend(rewrites.check_trace(exe.rewrite_trace,
                                           device=exe.device))
    return report


def verify_on_compile() -> bool:
    """Is the compile-time hook enabled?  Controlled by ``REPRO_VERIFY``
    (unset/"0"/"off"/"false" → disabled), the reference's variable:
    ``tests/conftest.py`` enables it for the whole suite, so every
    executable any test compiles — the port's too — is verified for
    free."""
    return os.environ.get("REPRO_VERIFY", "0").lower() \
        not in ("0", "", "off", "false", "no")
