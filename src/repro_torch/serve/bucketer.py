"""Request queue + shape/dtype bucketer (port of ``repro.serve.bucketer``).

Incoming requests are coalesced per *bucket* so the executor can push
full ``(N, H, W)`` stacks through one compiled program:

* **bucket key** = (lowered run signature, padded (H, W), dtype) —
  cross-op packing: ops whose run phases compile identically co-batch
  regardless of op name (see :class:`BucketKey`).  For pad-safe ops the
  image shape is rounded up to ``pad_quantum`` multiples, so a 500×300
  and a 512×320 request share one compiled program; pad-unsafe ops get
  exact-shape buckets (still batched across same-shape requests).
* **batch canonicalization**: a flushed batch of n requests is padded
  with sentinel images to the next power of two ≤ ``max_batch``, so the
  handful of canonical batch shapes reuse compiled programs instead of
  recompiling per occupancy.  Sentinels are filled with the op's
  absorbing identity — under the active-tile requeue scheduler (see
  ``docs/ARCHITECTURE.md``) they converge in one chunk and stop costing
  work.
* **deadline flush**: every queue records its oldest enqueue time; the
  service launches a bucket when it reaches ``max_batch`` *or* its
  oldest request has waited ``max_delay_ms`` — a straggler request
  never waits longer than that for co-batched traffic that may never
  arrive.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np

from repro_torch.core.backend import as_dtype
from repro_torch.core.morphology import bottom_value, top_value
from repro_torch.serve.errors import (NonFiniteInputError,
                                      UnsupportedDtypeError)


def pad_fill(dtype, which: str):
    """Absorbing fill value: "hi" = erosion identity, "lo" = dilation's
    (the lattice top/bottom already defined by ``core.morphology``), as a
    0-d NumPy array of ``dtype``."""
    value = top_value if which == "hi" else bottom_value
    return np.asarray(value(as_dtype(dtype)), np.dtype(dtype))


def check_payload(op: str, images) -> None:
    """Admission gate between user payloads and the absorbing pad fills.

    The bucket staging pads every request with lattice identities —
    which for floating dtypes are **±Inf**.  A payload that itself
    contains NaN/±Inf is therefore indistinguishable from padding once
    staged: the kernels would absorb it silently and the demuxed result
    would be garbage while still *looking* bit-exact.  Instead of
    coercing, admission rejects such payloads with a typed error; dtypes
    outside the lattice (no min/max identity) are rejected likewise.
    """
    for im in images:
        kind = np.dtype(im.dtype).kind
        if kind not in "uif":
            raise UnsupportedDtypeError(
                f"op {op!r}: dtype {im.dtype} has no lattice identity "
                "(integer and floating dtypes only)"
            )
        if kind == "f" and not np.isfinite(im).all():
            raise NonFiniteInputError(
                f"op {op!r}: input contains NaN/Inf, which collides with "
                "the absorbing pad fills (float lattice identities are "
                "±Inf) — sanitize the payload before submitting"
            )


def bucket_hw(h: int, w: int, quantum: int) -> tuple[int, int]:
    """Round a shape up to the bucket grid."""
    q = max(1, quantum)
    return (math.ceil(h / q) * q, math.ceil(w / q) * q)


def canonical_batch(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class BucketKey(NamedTuple):
    """Bucket identity: the lowered *run signature* + padded shape +
    dtype.  Keying on the run signature instead of the op name is what
    lets different ops with identical compiled run phases (HMAX / DOME
    / RAOBJ — all one dilate-reconstruction) co-batch; params that only
    affect prepare/finalize (e.g. HMAX's ``h``) never split buckets."""

    sig: tuple             # run-phase signature (registry.RunInfo.sig)
    hw: tuple[int, int]    # bucket (H, W) after canonicalization
    dtype: str
    tag: str               # human label for the run phase (derived)

    def label(self) -> str:
        """Human/metrics-facing name for this bucket."""
        return f"{self.tag}/{self.hw[0]}x{self.hw[1]}/{self.dtype}"


@dataclasses.dataclass
class Ticket:
    """Per-request handle, fulfilled by the executor's demux.  ``value``
    is the cropped result tensor on the service's device (a tuple of
    them for a multi-output op).

    Typed outcome surface: exactly one of ``value``/``error`` is set
    once ``done``; ``error`` is always a
    :class:`~repro_torch.serve.errors.ServeError` subclass (the lifecycle
    guarantees no unstructured exception reaches a ticket).
    ``degraded`` marks a *successful* result whose convergence watchdog
    tripped — the value is a partial fixpoint (see the degraded-mode
    contract in ``docs/ROBUSTNESS.md``).  ``deadline`` is the absolute
    monotonic time after which the request is shed instead of served.
    """

    request_id: int
    op: str
    t_enqueue: float
    done: bool = False
    value: Any = None
    error: Exception | None = None
    degraded: bool = False
    deadline: float | None = None
    t_done: float = 0.0
    _service: Any = dataclasses.field(default=None, repr=False)
    _bucket_key: Any = dataclasses.field(default=None, repr=False)
    _queued: bool = dataclasses.field(default=False, repr=False)
    _done_cbs: list = dataclasses.field(default_factory=list, repr=False)

    def _fulfill(self, now: float) -> None:
        """Mark the ticket done (exactly once) and fire completion
        callbacks — the single terminal transition every lifecycle path
        (demux, recovery, expiry, shed) goes through, which is what
        lets the async front-end resolve futures and the property suite
        assert exactly-one-terminal-outcome."""
        if self.done:
            return
        self.done = True
        self.t_done = now
        cbs, self._done_cbs = list(self._done_cbs), []
        for cb in cbs:
            cb(self)

    def add_done_callback(self, cb) -> None:
        """Call ``cb(ticket)`` when the ticket reaches its terminal
        outcome (immediately if already done).  Callbacks run on the
        thread that completes the ticket — the single service thread
        or the asyncio loop pumping it."""
        if self.done:
            cb(self)
        else:
            self._done_cbs.append(cb)

    def result(self):
        """The request's output; drives the service forward if needed."""
        if not self.done and self._service is not None:
            self._service._complete(self)
        if self.error is not None:
            raise self.error
        if not self.done:
            raise RuntimeError(
                f"request {self.request_id} ({self.op}) not completed — "
                "call Service.flush() or poll()"
            )
        return self.value

    @property
    def outcome(self) -> str:
        """Stable slug for the request's lifecycle outcome: ``pending``,
        ``ok``, ``degraded``, or the typed error's ``code``."""
        if not self.done:
            return "pending"
        if self.error is not None:
            return getattr(self.error, "code", "error")
        return "degraded" if self.degraded else "ok"


@dataclasses.dataclass
class PendingRequest:
    """A submitted request staged in a bucket queue.

    Requests in one bucket may come from *different ops* (cross-op
    packing), so everything per-op rides on the request: the staging
    info derived from its lowered program and its finalize callable.
    """

    ticket: Ticket
    images: tuple           # original user images (np, unpadded)
    inputs: tuple           # canonical inputs after prepare (unpadded,
                            # CPU tensors)
    shape: tuple[int, int]  # original (H, W) for the demux crop
    info: Any = None        # registry.RunInfo (staging/bucket identity)
    finalize: Any = None    # (outputs, images) -> outputs, or None
    poisoned: bool = False  # fault harness: this request kills its batch
    timer: Any = None       # armed expiry TimerHandle, cancelled at launch


class BucketQueue:
    """FIFO queues per bucket key with deadline accounting."""

    def __init__(self, max_batch: int, max_delay_s: float):
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self._queues: dict[BucketKey, list[PendingRequest]] = {}

    def add(self, key: BucketKey, req: PendingRequest) -> bool:
        """Enqueue; True when the bucket just reached ``max_batch``."""
        q = self._queues.setdefault(key, [])
        q.append(req)
        return len(q) >= self.max_batch

    def pop(self, key: BucketKey,
            limit: int | None = None) -> list[PendingRequest]:
        """Dequeue up to ``limit`` (default ``max_batch``) oldest
        requests of a bucket."""
        cap = self.max_batch if limit is None else limit
        q = self._queues.get(key, [])
        batch, rest = q[:cap], q[cap:]
        if rest:
            self._queues[key] = rest
        else:
            self._queues.pop(key, None)
        return batch

    def size(self, key: BucketKey) -> int:
        return len(self._queues.get(key, ()))

    def oldest(self, key: BucketKey) -> PendingRequest | None:
        q = self._queues.get(key)
        return q[0] if q else None

    def discard(self, key: BucketKey, req: PendingRequest) -> bool:
        """Remove one specific queued request (deadline expiry firing
        from a timer while the request still sits in its bucket)."""
        q = self._queues.get(key)
        if not q:
            return False
        try:
            q.remove(req)
        except ValueError:
            return False
        if not q:
            self._queues.pop(key, None)
        return True

    def due(self, now: float) -> list[BucketKey]:
        """Buckets whose oldest request has exceeded the flush deadline."""
        return [
            key for key, q in self._queues.items()
            if q and now - q[0].ticket.t_enqueue >= self.max_delay_s
        ]

    def keys(self) -> list[BucketKey]:
        return [k for k, q in self._queues.items() if q]

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())
