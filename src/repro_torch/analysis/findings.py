"""Finding/report model shared by every static check (port of
``repro.analysis.findings``, unchanged).

A check function returns a list of :class:`Finding`; the orchestration
in ``repro_torch.analysis.verifier`` aggregates them into a
:class:`Report`.
Severities:

``ERROR``
    a provable structural violation — the program/plan/key would
    compute wrong results, crash, or serve stale cache entries.  Lint
    exits non-zero and the compile-time hook raises
    :class:`VerificationError`.
``WARN``
    a domain-conditional hazard (e.g. int32 QDT residuals can overflow
    only for images spanning more than the int32 range).  Reported,
    never fatal.
"""
from __future__ import annotations

import dataclasses

ERROR = "error"
WARN = "warn"

#: The check classes; every Finding carries one.  ``index-map`` holds
#: the CUDA launchers' geometry facts (``analysis/indexmaps.py``).
CHECKS = ("halo", "dtype", "plan", "cache-key", "index-map", "rewrite")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified fact about a program/plan/executable."""

    check: str      # one of CHECKS
    severity: str   # ERROR | WARN
    subject: str    # what was checked ("segment 2 (chain er4)", "plan", ...)
    message: str    # what is wrong, with the numbers that prove it

    def __str__(self):
        return f"[{self.severity.upper():5s}] {self.check}: " \
               f"{self.subject}: {self.message}"


@dataclasses.dataclass
class Report:
    """Aggregated findings of one verification run."""

    findings: list = dataclasses.field(default_factory=list)
    subject: str = ""

    def extend(self, findings) -> "Report":
        self.findings.extend(findings)
        return self

    def errors(self) -> list:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == WARN]

    @property
    def ok(self) -> bool:
        """No errors (warnings do not fail verification)."""
        return not self.errors()

    def raise_if_errors(self):
        errs = self.errors()
        if errs:
            raise VerificationError(self.subject, errs)

    def __str__(self):
        if not self.findings:
            return f"{self.subject or 'report'}: clean"
        lines = [f"{self.subject or 'report'}: "
                 f"{len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s)"]
        lines += [f"  {f}" for f in self.findings]
        return "\n".join(lines)


class VerificationError(AssertionError):
    """A static check proved an ERROR-severity violation.

    Subclasses ``AssertionError`` on purpose: a failed proof about a
    compiled artifact is an internal-invariant failure, not bad user
    input.
    """

    def __init__(self, subject: str, errors: list):
        self.subject = subject
        self.errors = list(errors)
        msg = "\n".join(str(f) for f in self.errors)
        super().__init__(
            f"static verification failed for {subject or 'program'}:\n{msg}"
        )
