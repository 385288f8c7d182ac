"""Exhaustive repo lint: ``python -m repro_torch.analysis.lint`` (port
of ``repro.analysis.lint``).

Sweeps every expression operator in the port's serve registry across a
dtype × shape × backend matrix, compiles each combination on
``--device`` (verify hook deferred — this CLI *is* the verifier) and
runs the full-level static checks: halo/pad-state proofs, plan
constraints, the CUDA launchers' geometry over every launch, cache-key
mutation sweeps and dtype audits.  The serve bucketer's pad fills are
audited once against the kernel lattice identities on top.

``--device`` defaults to the GPU and raises without one, as ``compile``
does; ``--device cpu`` lints on the CPU (the facts are static, so the
verdict is the same; ``--rewrites`` replays on the chosen device).

Because the expression optimizer is on by default, every compiled
case is the *rewritten* program — a clean sweep asserts the rewritten
registry lints clean.  ``--rewrites`` additionally replays every
applied optimizer rule per op on randomized small inputs
(``repro_torch.analysis.rewrites``), demanding bit-exactness against
the unrewritten graph.

Exit status: 1 when any ERROR-severity finding survives (or any WARN
under ``--strict``), 0 otherwise.  Apart from the
``--rewrites`` replay (tiny oracle programs), nothing is executed: a
clean sweep is a set of static proofs about every program the
registry can currently lower.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.analysis import dtypes as dtype_checks
from repro_torch.analysis.findings import Report, VerificationError
from repro_torch.analysis.verifier import verify_executable
from repro_torch.core.backend import BACKENDS

#: Default sweep matrix: the paper's char→double crossover dtypes, a
#: lane-aligned shape, a batched non-square shape and a ragged shape
#: (exercises the tile_w=0 fallback), on both engines (``BACKENDS``:
#: ``"cuda"`` and ``"torch"``).
DTYPES = ("uint8", "uint16", "float32", "float64")
SHAPES = ((1, 64, 64), (4, 48, 96), (1, 33, 70))


def _sample_params(spec) -> tuple:
    """Canonical sample params for one OpSpec (registration defaults)."""
    return tuple((name, spec.params[name].sample())
                 for name in sorted(spec.params))


def iter_registry_cases(ops=None, dtypes=DTYPES, shapes=SHAPES,
                        backends=BACKENDS):
    """Yield ``(label, expr, shape3, dtype, backend)`` for every
    expression op in the registry; custom (hand-written ``run``) specs
    have no lowered program to verify and are skipped."""
    from repro_torch.serve import registry

    for name in ops or registry.names():
        spec = registry.get(name)
        if spec.expr_builder is None:
            continue
        expr = spec.build_expr(_sample_params(spec))
        for dtype in dtypes:
            if np.dtype(dtype).kind not in spec.dtypes:
                continue  # e.g. gdt ops are float-lattice only
            for shape3 in shapes:
                for backend in backends:
                    yield (f"{name}[{dtype},{shape3},{backend}]",
                           expr, shape3, dtype, backend)


def run_lint(ops=None, dtypes=DTYPES, shapes=SHAPES, backends=BACKENDS,
             level="full", rewrites=False, verbose=False,
             out=sys.stdout, device=None) -> Report:
    """Compile and verify every registry case on ``device`` (``None``
    is the GPU, which raises without one)."""
    from repro_torch.api.compile import compile as api_compile
    from repro_torch.core.backend import resolve_device

    device = resolve_device(device)
    total = Report(subject="repro_torch.analysis.lint")
    # the bucketer fill audit is global (all supported dtypes), not
    # restricted to the sweep matrix — it is cheap and shape-free
    total.extend(dtype_checks.check_bucketer_fills())
    n_cases = 0
    seen_exprs: dict = {}
    for label, expr, shape3, dtype, backend in iter_registry_cases(
            ops, dtypes, shapes, backends):
        n_cases += 1
        seen_exprs.setdefault(label.split("[")[0], expr)
        try:
            exe = api_compile(expr, shape3, dtype, backend, verify=False,
                              device=device)
        except VerificationError as e:  # pragma: no cover - verify=False
            total.extend(e.errors)
            continue
        report = verify_executable(exe, level=level)
        if verbose or not report.ok:
            print(f"{label}: {len(report.errors())} error(s), "
                  f"{len(report.warnings())} warning(s)", file=out)
        total.extend(report.findings)
    n_rewritten = 0
    if rewrites:
        # optimizer soundness sweep: once per op (the trace and the
        # canonical graph do not depend on the shape/backend matrix)
        from repro_torch.analysis.rewrites import check_rewrites
        from repro_torch.opt import rewrite_traced

        for name, expr in sorted(seen_exprs.items()):
            result = rewrite_traced(expr)
            findings = check_rewrites(expr, device=device)
            if result.changed:
                n_rewritten += 1
            if verbose or findings:
                rules = ",".join(a.rule for a in result.trace) or "-"
                print(f"rewrites[{name}]: {result.n_applied} applied "
                      f"({rules}), {len(findings)} finding(s)", file=out)
            total.extend(findings)
    msg = (f"lint: {n_cases} registry case(s) verified — "
           f"{len(total.errors())} error(s), "
           f"{len(total.warnings())} warning(s)")
    if rewrites:
        msg += (f"; rewrite soundness replayed on {len(seen_exprs)} op(s) "
                f"({n_rewritten} rewritten)")
    print(msg, file=out)
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="statically verify every registry operator across a "
                    "dtype/shape/backend matrix",
    )
    p.add_argument("--ops", nargs="*", default=None,
                   help="restrict to these registry ops (default: all)")
    p.add_argument("--dtypes", nargs="*", default=list(DTYPES))
    p.add_argument("--shapes", nargs="*", default=None,
                   help="NxHxW triples, e.g. 4x48x96")
    p.add_argument("--backends", nargs="*", default=list(BACKENDS),
                   choices=list(BACKENDS))
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--level", default="full",
                   choices=["fast", "full", "sound"])
    p.add_argument("--rewrites", action="store_true",
                   help="additionally replay the expression optimizer's "
                        "rewrites on every registry op (numeric "
                        "bit-exactness, randomized small inputs)")
    p.add_argument("--strict", action="store_true",
                   help="treat warnings as errors")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print every case, not only failing ones")
    args = p.parse_args(argv)

    shapes = SHAPES
    if args.shapes:
        shapes = tuple(tuple(int(v) for v in s.split("x"))
                       for s in args.shapes)
        if any(len(s) != 3 for s in shapes):
            p.error("shapes must be NxHxW triples")

    report = run_lint(ops=args.ops, dtypes=tuple(args.dtypes),
                      shapes=shapes, backends=tuple(args.backends),
                      level=args.level, rewrites=args.rewrites,
                      verbose=args.verbose, device=args.device)
    for f in report.findings:
        print(f)
    failed = report.errors() or (args.strict and report.warnings())
    print("lint:", "FAILED" if failed else "ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
