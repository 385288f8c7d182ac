"""Static program verifier for lowered morphology plans (port of
``repro.analysis``).

Proves invariants about :class:`~repro_torch.api.expr.Expr` graphs,
lowered :class:`~repro_torch.api.lower.Program`\\ s and
:class:`~repro_torch.core.chain.ChainPlan` schedules **without executing
them** — five check classes (halo coverage, dtype safety, plan
constraints, cache-key completeness, and the CUDA launchers' geometry
under the reference's ``index-map`` name), three entry points (the
``verify=`` hook in ``repro_torch.api.compile``, the ``python -m
repro_torch.analysis.lint`` CLI, and direct calls from the mutation
self-tests).  See ``docs/VERIFIER.md`` for the reference's design.
"""
from repro_torch.analysis.cachekeys import (check_executable_key,
                                            check_plan_key)
from repro_torch.analysis.dtypes import (SUPPORTED_DTYPES,
                                         check_bucketer_fills,
                                         check_distance_plane,
                                         check_fill_value,
                                         check_qdt_accumulator)
from repro_torch.analysis.findings import (CHECKS, ERROR, WARN, Finding,
                                           Report, VerificationError)
from repro_torch.analysis.halo import check_coverage, check_program
from repro_torch.analysis.indexmaps import (check_partition,
                                            check_plan_index_maps,
                                            check_windows)
from repro_torch.analysis.plans import check_plan
from repro_torch.analysis.verifier import verify_executable, verify_on_compile

__all__ = [
    "CHECKS", "ERROR", "WARN", "Finding", "Report", "VerificationError",
    "SUPPORTED_DTYPES",
    "check_bucketer_fills", "check_distance_plane", "check_fill_value",
    "check_qdt_accumulator",
    "check_coverage", "check_program",
    "check_windows", "check_partition", "check_plan_index_maps",
    "check_plan",
    "check_executable_key", "check_plan_key",
    "verify_executable", "verify_on_compile",
]
