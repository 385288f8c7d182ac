"""Double-buffered executor on one CUDA stream: overlap host staging
with device compute, demux per-request results — and keep serving
through failures (port of ``repro.serve.executor``).

The reference leans on JAX's asynchronous dispatch.  Here every
executor owns **one CUDA stream** and runs all of its device work on
it: the staging copies (``upload``: the host-padded stack, in pinned
memory, copied with ``non_blocking=True``), the bucket program itself
(the kernel launchers run on the current stream, which the executor
sets), and the demux's crops and finalize stages.  ``dispatch`` records
a :class:`torch.cuda.Event` after the program and returns; the service
stages the *next* batch on the host while the device crunches this
one, and the executor only blocks — on the oldest batch's event — when
``depth`` batches are already in flight (``depth=2`` is classic double
buffering).  Nothing of a batch runs on the legacy default stream, so
nothing of it can race the batch under ``depth >= 2``.  A program whose
driver reads the device back (the convergent scheduler reads its
activity grid once a chunk) blocks the host inside ``dispatch`` until
it converges; the overlap then comes only from the batches behind
fixed-length chains.  On a CPU device there is no stream and no event:
every call completes before it returns.

Draining a batch demuxes it: each real request slot is cropped back to
its original (H, W) (dropping the pad-to-bucket canonicalization), the
*request's own* finalize stage runs on the service's device (requests
in one bucket may come from different ops under cross-op packing —
e.g. DOME's ``f - hmax`` residual next to plain HMAX requests), the
ticket is fulfilled, and sentinel slots (batch padding up to the
canonical size) are discarded.  A delivered value is a tensor on the
service's device, complete when its ticket is fulfilled, and recorded
on the caller's current stream so the allocator keeps its memory until
the caller's work on it is done.  Slots whose convergence watchdog
tripped (the per-image vector from ``Executable.run_batch_stats``) are
delivered with ``Ticket.degraded = True`` — partial convergence is a
degraded result, not an error.

Fault tolerance (the recovery ladder, as in the reference):

1. **retry with backoff** — a failed batch (staging, dispatch, or the
   asynchronous CUDA error surfacing at the event's ``synchronize``) is
   re-run synchronously up to ``max_retries`` times via the
   service-provided ``runner`` closure; transient errors clear here and
   only cost a ``retried`` counter bump.
2. **bisect quarantine** — a batch that keeps failing is split in
   halves and each half re-run recursively, so a single poisoned
   request converges to a singleton that fails alone: *it* gets a typed
   :class:`~repro_torch.serve.errors.PoisonedRequestError` while every
   healthy co-batched request completes bit-exactly (sub-batch
   execution is bit-exact by the bucketer's absorbing-pad/sentinel
   invariance).

The ladder re-runs on the same engine and device: it never falls back
to the ``"torch"`` engine or to the CPU.  No exception escapes the
executor's public surface: every failure ends as a typed error on the
affected tickets.  Injected faults (``serve/faults.py`` sites
``dispatch``/``drain``) enter exactly where the real failures would.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.serve import faults as F
from repro_torch.serve.bucketer import BucketKey, PendingRequest
from repro_torch.serve.errors import ExecutorError, PoisonedRequestError
from repro_torch.serve.metrics import ServeMetrics


class Staged(NamedTuple):
    """A batch's canonical inputs on the device, and the host buffers
    their copies read (pinned on a CUDA device: kept until the batch's
    event has fired)."""

    inputs: tuple
    host: tuple


class InflightBatch(NamedTuple):
    outputs: tuple           # device tensors, one per run output
    converged: Any           # (n_slots,) bool CPU tensor, or None
    requests: list           # real PendingRequests (sentinel slots excluded)
    key: BucketKey
    n_slots: int
    t_dispatch: float
    runner: Any              # sync re-execution closure (recovery ladder)
    util: Any = None         # (busy, cap) chunk-utilization ints, or None
    done: Any = None         # CUDA event recorded after the program
    host: tuple = ()         # the staged host buffers, alive until ``done``


class Executor:
    def __init__(self, metrics: ServeMetrics, depth: int = 2,
                 clock=time.monotonic, faults: F.FaultInjector = F.NULL,
                 max_retries: int = 2, backoff_s: float = 0.0,
                 sleep=time.sleep, device=None):
        if depth < 1:
            raise ValueError("pipeline depth must be >= 1")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.depth = depth
        self.metrics = metrics
        self.clock = clock
        self.faults = faults
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.sleep = sleep
        #: ``None`` is the GPU (raises without one), as for ``Service``
        self.device = resolve_device(device)
        #: the one stream every device operation of this executor uses
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._inflight: collections.deque[InflightBatch] = collections.deque()

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    # -- the stream ----------------------------------------------------------

    def on_stream(self):
        """Context in which torch work runs on the executor's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def host_buffer(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """An uninitialised host tensor for staging (pinned on a CUDA
        device, so its copy can run asynchronously)."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.stream is not None)

    def upload(self, host: tuple) -> Staged:
        """Copy staged host buffers to the device on the stream."""
        with self.on_stream():
            inputs = tuple(h.to(self.device, non_blocking=True)
                           for h in host)
        return Staged(inputs=inputs, host=host)

    def _record(self):
        """An event after the work queued on the stream so far."""
        if self.stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self.stream)
        return event

    def run_now(self, entry, staged: Staged):
        """Run a program synchronously on the stream (recovery re-runs
        and warm-up): ``(outputs, converged|None)``, complete on return."""
        outputs, conv, _ = self._call_entry(entry, staged.inputs)
        if self.stream is not None:
            self.stream.synchronize()
        return outputs, conv

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, entry, key: BucketKey,
                 requests: list[PendingRequest], n_slots: int,
                 staged: Staged, runner=None) -> None:
        """Launch one batch (async) and retire the oldest if the
        pipeline is full.  Never raises: a failure at the call enters
        the recovery ladder instead."""
        try:
            outputs, conv, util = self._call_entry(entry, staged.inputs)
        except Exception as exc:
            self.recover(key, requests, runner, exc)
            return
        self._inflight.append(InflightBatch(
            outputs=outputs, converged=conv, requests=requests, key=key,
            n_slots=n_slots, t_dispatch=self.clock(), runner=runner,
            util=util, done=self._record(), host=staged.host,
        ))
        while len(self._inflight) > self.depth:
            self.drain_one()

    def _call_entry(self, entry, inputs):
        """Run a cache entry's primary callable on the stream →
        ``(outputs, conv|None, util|None)`` where ``util`` is the
        ``(busy_chunks, cap_chunks)`` pair of ``run_batch_stats``."""
        with self.on_stream():
            if entry.stats_fn is not None:
                outputs, conv, busy, cap = entry.stats_fn(*inputs)
                return outputs, conv, (busy, cap)
            out = entry.fn(*inputs)
        return (out if isinstance(out, tuple) else (out,)), None, None

    # -- drain + demux -----------------------------------------------------

    def drain_one(self) -> bool:
        """Block on the oldest in-flight batch and demux it."""
        if not self._inflight:
            return False
        batch = self._inflight.popleft()
        try:
            self.faults.check("drain", batch.key.label())
            if batch.done is not None:
                batch.done.synchronize()  # async CUDA errors surface here
        except Exception as exc:
            self.recover(batch.key, batch.requests, batch.runner, exc)
            return True
        self._demux(batch.key, batch.requests, batch.n_slots,
                    batch.outputs, batch.converged, batch.t_dispatch,
                    util=batch.util)
        return True

    def drain_all(self) -> None:
        while self.drain_one():
            pass

    def _deliver(self, requests, outputs):
        """Crop and finalize every request's slot on the stream →
        per request, its value or the exception its finalize raised."""
        results = []
        with self.on_stream():
            for slot, req in enumerate(requests):
                h, w = req.shape
                cropped = tuple(o[slot, :h, :w] for o in outputs)
                try:
                    if req.finalize is not None:
                        images = tuple(torch.as_tensor(im, device=self.device)
                                       for im in req.images)
                        cropped = tuple(req.finalize(cropped, images))
                    # arity per request: co-batched ops share a run phase
                    # but may fan their finalize into different outputs
                    results.append(cropped[0] if req.info.n_outputs == 1
                                   else cropped)
                except Exception as exc:  # surface per-request
                    results.append(exc)
        if self.stream is not None:
            self.stream.synchronize()
            consumer = torch.cuda.current_stream(self.device)
            for value in results:
                for t in (value if isinstance(value, tuple) else (value,)):
                    if isinstance(t, torch.Tensor):
                        t.record_stream(consumer)
        return results

    def _demux(self, key: BucketKey, requests, n_slots: int, outputs,
               converged, t_dispatch: float, util=None) -> None:
        """Crop, finalize and deliver per-request results (shared by the
        async drain path and the synchronous recovery re-runs)."""
        results = self._deliver(requests, outputs)
        now = self.clock()
        conv = None if converged is None else np.asarray(converged)
        latencies = []
        pixels = 0
        n_errors = 0
        n_degraded = 0
        for slot, (req, value) in enumerate(zip(requests, results)):
            h, w = req.shape
            if isinstance(value, Exception):
                req.ticket.error = ExecutorError(
                    f"finalize failed for request {req.ticket.request_id} "
                    f"({req.ticket.op})", cause=value)
                n_errors += 1
            else:
                req.ticket.value = value
                if conv is not None and not conv[slot]:
                    req.ticket.degraded = True
                    n_degraded += 1
                    self.metrics.count("degraded")
            req.ticket._fulfill(now)
            latencies.append(now - req.ticket.t_enqueue)
            pixels += h * w

        busy, cap = ((int(util[0]), int(util[1])) if util is not None
                     else (0, 0))
        self.metrics.record_batch(
            key.label(),
            n_real=len(requests),
            n_slots=n_slots,
            pixels=pixels,
            t_dispatch=t_dispatch,
            t_done=now,
            latencies_s=latencies,
            n_errors=n_errors,
            n_degraded=n_degraded,
            busy_chunks=busy,
            cap_chunks=cap,
        )

    # -- recovery ladder: retry with backoff, then bisect quarantine -------

    def recover(self, key: BucketKey, requests, runner,
                exc: Exception) -> None:
        """A batch failed: retry whole, then bisect-quarantine.

        Every request ends with a typed outcome — value, degraded
        value, or :class:`PoisonedRequestError`/:class:`ExecutorError`
        — and nothing is raised to the caller.
        """
        self.metrics.count("batch_failures")
        if runner is None:
            # no re-execution path (direct executor use): typed failure
            self._fail_batch(requests, ExecutorError(
                f"batch {key.label()} failed with no runner to retry",
                cause=exc))
            return
        for attempt in range(self.max_retries):
            if self.backoff_s > 0.0:
                self.sleep(self.backoff_s * (2 ** attempt))
            self.metrics.count("retried")
            try:
                outputs, n_slots, conv = runner(requests)
            except Exception as exc2:
                exc = exc2
                continue
            self._demux(key, requests, n_slots, outputs, conv,
                        t_dispatch=self.clock())
            return
        self._quarantine(key, requests, runner, exc)

    def _quarantine(self, key: BucketKey, requests, runner,
                    cause: Exception) -> None:
        """Bisect-retry: isolate poisoned request(s) so healthy
        co-batched requests still complete bit-exactly."""
        if len(requests) == 1:
            req = requests[0]
            req.ticket.error = PoisonedRequestError(
                f"request {req.ticket.request_id} ({req.ticket.op}) "
                "poisoned its batch: every containing subset failed",
                cause=cause)
            req.ticket._fulfill(self.clock())
            self.metrics.count("poisoned")
            return
        mid = len(requests) // 2
        for part in (requests[:mid], requests[mid:]):
            try:
                outputs, n_slots, conv = runner(part)
            except Exception as exc:
                self._quarantine(key, part, runner, exc)
            else:
                self.metrics.count("quarantine_reruns")
                self._demux(key, part, n_slots, outputs, conv,
                            t_dispatch=self.clock())

    def _fail_batch(self, requests, exc: Exception) -> None:
        now = self.clock()
        for req in requests:
            req.ticket.error = exc
            req.ticket._fulfill(now)
