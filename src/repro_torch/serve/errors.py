"""Structured error model for the serving lifecycle (a copy of
``repro.serve.errors``: the same classes, codes and hierarchy).

Every way a request can fail is a *typed* outcome raised (admission) or
recorded on the ticket (execution), so callers can branch on error
class/``code`` instead of parsing tracebacks, and so the service can
guarantee its core robustness contract: **no unstructured exception
escapes ``Service.poll()``** — a failing batch resolves into per-request
typed errors while healthy co-batched requests still complete.

Taxonomy (see ``docs/ROBUSTNESS.md`` for the full contract):

admission-time (raised synchronously from ``Service.submit``)
    :class:`InvalidRequestError`
        malformed request: wrong arity, ragged shapes/dtypes, non-2-D
        images.  Subclasses :class:`ValueError` so pre-existing callers
        keep working.
    :class:`UnsupportedDtypeError`
        dtype outside the lattice the kernels define identities for
        (integer and floating dtypes only).
    :class:`NonFiniteInputError`
        a floating-point payload containing NaN/±Inf — these collide
        with the absorbing pad fills (±Inf *are* the float lattice
        identities), so downstream bit-exactness would silently break.
    :class:`QueueFullError`
        admission control: the service's bounded queue is full and the
        request is load-shed instead of growing the backlog.

execution-time (recorded on ``Ticket.error``, raised by ``result()``)
    :class:`DeadlineExceededError`
        the request's deadline expired while it was still queued; it is
        shed at launch instead of wasting device time.
    :class:`ExecutorError`
        a batch kept failing after the executor's retry budget; wraps
        the underlying cause (``cause`` attribute).
    :class:`PoisonedRequestError`
        quarantine outcome: bisect-retry isolated *this* request as the
        one that keeps killing its batch.  Healthy co-batched requests
        are re-run and complete normally.

Partial convergence (the scheduler watchdog hitting its chunk budget)
is deliberately **not** an error: the partial result is returned with
``Ticket.degraded = True`` (see the degraded-mode contract in
``docs/ROBUSTNESS.md``).
"""
from __future__ import annotations


class ServeError(Exception):
    """Base of every typed serving error; ``code`` is a stable,
    machine-readable slug (mirrored by the metrics counters)."""

    code = "serve_error"


class RequestRejected(ServeError, ValueError):
    """Admission-time rejection: the request never entered a bucket.

    Subclasses :class:`ValueError` because the pre-robustness service
    raised plain ``ValueError`` for malformed requests.
    """

    code = "rejected"


class InvalidRequestError(RequestRejected):
    """Malformed request (arity, rank, ragged shape/dtype)."""

    code = "invalid"


class UnsupportedDtypeError(RequestRejected):
    """Dtype has no lattice identity (not integer/floating)."""

    code = "unsupported_dtype"


class NonFiniteInputError(RequestRejected):
    """Float payload contains NaN/±Inf, which would be
    indistinguishable from the absorbing pad fills downstream."""

    code = "non_finite"


class QueueFullError(ServeError):
    """Load shedding: the bounded request queue is at capacity."""

    code = "shed"


class ServiceClosedError(ServeError):
    """The service was closed (``Service.close()`` /
    ``AsyncService.close()``); no new requests are admitted.  Requests
    already admitted at close time still drain to a terminal outcome."""

    code = "closed"


class DeadlineExceededError(ServeError):
    """The request's deadline expired before its bucket dispatched."""

    code = "deadline"


class ExecutorError(ServeError):
    """A batch failed and kept failing through the retry budget; the
    original exception is preserved on ``cause``."""

    code = "executor"

    def __init__(self, message: str, *, cause: BaseException | None = None):
        super().__init__(message)
        self.cause = cause
        if cause is not None:
            self.__cause__ = cause


class PoisonedRequestError(ExecutorError):
    """Bisect-retry isolated this request as the one poisoning its
    batch (every subset containing it failed; its siblings' subsets
    succeeded or were themselves isolated)."""

    code = "poisoned"
