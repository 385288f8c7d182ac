"""Continuous batching: refill converged slots mid-flight (port of
``repro.serve.continuous``).

The batch executor retires a bucket only when *every* image in the
batch has converged — under the requeue scheduler a batch of mixed
images runs at the speed of its slowest member, and every early
finisher parks as dead capacity until the straggler lands.  The
:class:`SlotEngine` removes that coupling: it owns one resident
:class:`~repro_torch.api.executable.SlotSession` per bucket (a padded
device stack whose row blocks are independent images), advances it in
*rounds* of ``refill_quantum`` scheduler chunks, and the moment the
per-image converged vector marks a slot finished it harvests that slot
and admits the next queued request into it — while the other slots keep
iterating.

Every device operation of the engine runs on the executor's stream
(``Executor.on_stream``): a request's padded inputs are staged in NumPy
into the executor's pinned host buffers and copied with
``non_blocking=True``, and the admission, the rounds (with the
scheduler's per-chunk read-back) and the harvest's crops all run there.
A harvested value is a copy — the next admission writes into the
resident stack in place — and is delivered through the executor's demux
(crop to the request's shape, finalize, record on the caller's stream).

Correctness leans on two invariants:

* **per-slot independence** — the plan pins band halos inside each
  image's row block, so one slot's values never leak into another's,
  and a slot admitted mid-flight starts from exactly the state a solo
  run would stage (same absorbing pads, all-active rows, zero chunk
  counter).  Harvested outputs are therefore bit-exact with solo
  execution.
* **budget truncation** — each slot carries the per-image chunk budget
  a solo run compiles with; a budget-cut slot is harvested as a
  degraded partial fixpoint identical to a solo run truncated at the
  same budget (``Ticket.degraded``).

Fault sites follow the batch path's grammar (``serve/faults.py``):
``dispatch`` fires once per admit wave, ``drain`` once per round, and a
``poison``-marked occupant kills its *session* — the engine evicts every
occupant into the executor's recovery ladder (retry, then bisect
quarantine), which isolates the poisoned request and re-runs the
healthy ones bit-exactly on the same engine and device, then
re-initializes the session state.  No exception escapes
:meth:`SlotEngine.step`.

Accounting: each round reports ``busy/total`` slots and the chunk-counter
deltas (``busy_chunks``/``cap_chunks``) to ``ServeMetrics.record_round``,
and every admission into a session that already has live occupants
bumps the ``refills`` counter.
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.core.backend import as_dtype
from repro_torch.serve import faults as F
from repro_torch.serve.bucketer import BucketKey, pad_fill


class SlotEngine:
    """Resident continuous-batching session for one bucket key."""

    def __init__(self, service, key: BucketKey, info, entry):
        self.service = service
        self.key = key
        self.info = info
        self.entry = entry
        self.session = entry.exe.slot_session(service.refill_quantum)
        self.state = None                       # lazy: built on first admit
        self.slots: list = [None] * self.session.n_slots
        self._t_admit = [0.0] * self.session.n_slots
        self._prev_chunks = np.zeros(self.session.n_slots, np.int64)
        self.rounds = 0
        self.refills = 0  # this engine's share of the ``refills`` counter

    # -- occupancy ---------------------------------------------------------

    @property
    def n_occupied(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def occupied(self) -> bool:
        return any(r is not None for r in self.slots)

    # -- admission ---------------------------------------------------------

    def pull(self) -> int:
        """Admit queued requests into free slots; returns how many.

        Pops only what fits (surplus stays queued with its expiry
        timers intact) and sheds expired requests *after* the pop, so a
        deadline that lapsed during a compile is caught here instead of
        being dispatched.
        """
        free = [i for i, r in enumerate(self.slots) if r is None]
        if not free:
            return 0
        svc = self.service
        batch = svc._queue.pop(self.key, limit=len(free))
        if not batch:
            return 0
        for req in batch:
            req.ticket._queued = False
            if req.timer is not None:
                req.timer.cancel()
                req.timer = None
        batch = svc._shed_expired(batch)
        if not batch:
            return 0
        return self._admit(batch, free)

    def _admit(self, batch, free) -> int:
        svc = self.service
        ex = svc.executor
        try:
            if self.state is None:
                with ex.on_stream():
                    self.state = self.session.init()
            svc.faults.check("dispatch", self.key.label())
        except Exception as exc:
            svc.executor.recover(self.key, batch, self._runner(), exc)
            return 0
        refill = self.occupied  # others still iterating: these are refills
        for j, (req, slot) in enumerate(zip(batch, free)):
            try:
                staged = self._staged(req)
                with ex.on_stream():
                    self.state = self.session.admit(self.state, slot,
                                                    *staged.inputs)
            except Exception as exc:
                # the session's planes may be half-written: evict it
                self._fail_session(exc, batch[j:])
                return j
            self.slots[slot] = req
            self._t_admit[slot] = svc.clock()
            self._prev_chunks[slot] = 0  # admit re-arms the slot counter
            if refill:
                self.refills += 1
                svc.metrics.count("refills")
        return len(batch)

    def _staged(self, req):
        """One request's canonical inputs padded to the bucket (H, W)
        with the program's absorbing fills — byte-identical to the slice
        of the batch path's ``_stage`` stack this request would occupy —
        in pinned host buffers, copied to the device on the stream."""
        h, w = self.key.hw
        dtype = np.dtype(self.key.dtype)
        rh, rw = req.shape
        ex = self.service.executor
        host = []
        for j in range(self.info.n_inputs):
            buf = ex.host_buffer((h, w), as_dtype(dtype))
            arr = buf.numpy()
            arr[...] = pad_fill(dtype, self.info.fills[j])
            arr[:rh, :rw] = np.asarray(req.inputs[j])
            host.append(buf)
        return ex.upload(tuple(host))

    # -- rounds ------------------------------------------------------------

    def step(self) -> bool:
        """One scheduler round: advance every occupied slot by up to
        ``refill_quantum`` chunks, harvest finished slots, refill from
        the queue.  Returns True when any work happened; never raises
        (failures evict the session into the recovery ladder)."""
        occupied = [i for i, r in enumerate(self.slots) if r is not None]
        if not occupied:
            return False
        svc = self.service
        ex = svc.executor
        try:
            for i in occupied:
                if self.slots[i].poisoned:
                    raise F.InjectedFault(
                        "poison",
                        f"request {self.slots[i].ticket.request_id}")
            with ex.on_stream():
                self.state, finished, exhausted = self.session.round(
                    self.state)
            svc.faults.check("drain", self.key.label())
            if ex.stream is not None:
                ex.stream.synchronize()  # asynchronous errors surface here
        except Exception as exc:
            self._fail_session(exc)
            return True
        self.rounds += 1
        # chunk-weighted utilization: counter deltas are exactly the
        # chunks each slot ran this round; the device was held for the
        # longest slot's chunks across every slot
        chunks = np.asarray(self.session.chunks_of(self.state),
                            dtype=np.int64)
        delta = chunks - self._prev_chunks
        self._prev_chunks = chunks
        svc.metrics.record_round(self.key.label(), n_busy=len(occupied),
                                 n_slots=self.session.n_slots,
                                 t=svc.clock(),
                                 busy_chunks=int(delta.sum()),
                                 cap_chunks=(int(delta.max())
                                             * self.session.n_slots))
        done = [i for i in occupied if finished[i]]
        if done:
            self._harvest(done, np.asarray(exhausted))
        self.pull()
        return True

    def _harvest(self, done, exh) -> None:
        """Deliver finished slots through the executor's demux (crop to
        request shape, finalize, fulfill) and free them."""
        svc = self.service
        with svc.executor.on_stream():
            # copies: the next admission writes the stack in place
            outs = tuple(o[done] for o in self.session.extract(self.state))
        conv = ~exh[done]  # exhausted slot: degraded partial fixpoint
        requests = [self.slots[i] for i in done]
        t0 = min(self._t_admit[i] for i in done)
        svc.executor._demux(self.key, requests, len(done), outs, conv,
                            t_dispatch=t0)
        for i in done:
            self.slots[i] = None  # parked: no active rows, no cost

    def _fail_session(self, exc: Exception, pending=()) -> None:
        """A round (or an admission) failed, injected or real: evict
        every occupant, and ``pending`` requests not yet admitted, into
        the recovery ladder and reset the session state.  Retry re-runs
        them as a batch on the same engine and device; bisect isolates
        poisoned requests while healthy ones complete bit-exactly."""
        svc = self.service
        evicted = [r for r in self.slots if r is not None] + list(pending)
        self.slots = [None] * self.session.n_slots
        self.state = None  # the next admission starts a fresh one
        self._prev_chunks[:] = 0
        svc.executor.recover(self.key, evicted, self._runner(), exc)

    def _runner(self):
        svc = self.service
        return functools.partial(svc._run_sync, self.key, self.info)
