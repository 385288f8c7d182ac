"""The serving front-end: admit → bucket → compile-or-hit → execute,
as an event-driven engine with a fault-tolerant request lifecycle (port
of ``repro.serve.service``).

``Service`` ties the pieces together: the :mod:`registry` validates ops
and params and lowers each request's expression, the :mod:`bucketer`
coalesces requests into *run-signature*/shape/dtype buckets (cross-op
packing: ops with identical compiled run phases co-batch), the
:mod:`cache` maps ``Executable.key`` — the same identity the
``repro_torch.api`` compile cache uses — to compiled bucket programs +
their :class:`ChainPlan`, and the :mod:`executor` runs the
double-buffered pipeline on its CUDA stream and demuxes results,
applying each request's own finalize stage.  With ``continuous=True``,
refillable buckets (one convergence-driven segment on the ``"cuda"``
engine, wavefront schedule) run on a resident
:class:`~repro_torch.serve.continuous.SlotEngine` instead: converged
slots are harvested and refilled mid-flight while stragglers keep
iterating.

The service runs on ``device`` (``None`` is the GPU, which raises
without one; the CPU must be asked for with ``device="cpu"``) with the
engine ``backend`` (``"cuda"``, the default and the reference's
``"pallas"``, or ``"torch"``, the reference's ``"xla"``).  Staging pads
on the host in NumPy; the executor copies the stack to the device.

Event-driven core: the service never sleeps and never spawns a thread —
every deferred action is a timer on a :class:`~repro_torch.serve.loop
.EventLoop` sharing the service's injectable clock:

* a **flush timer** per non-empty bucket, armed for its oldest
  request's ``max_delay_ms`` deadline, launches the bucket with no
  caller involvement the next time the loop is pumped;
* an **expiry timer** per deadlined request sheds it the moment its
  deadline lapses while queued (and launch re-checks deadlines *after*
  compiling, so a request expiring during a long compile is never
  dispatched).

Cooperative callers pump the loop via ``submit``/``poll``/``pump``;
:class:`AsyncService` is the asyncio front-end that trampolines
``next_deadline()`` into real ``call_at`` wakeups so deadline flushes
fire with *no* caller, and resolves tickets into awaitable futures via
``Ticket.add_done_callback``.  Under a
:class:`~repro_torch.serve.loop.VirtualClock` the same engine replays
deterministically.

Robustness contract (as in the reference, ``docs/ROBUSTNESS.md``):

* **admission** rejects malformed requests *synchronously* with typed
  errors (:mod:`repro_torch.serve.errors`) before they can poison a
  bucket: arity/shape/dtype validation, lattice-dtype and non-finite
  payload checks (``bucketer.check_payload``), load shedding when the
  bounded queue (``max_queue``) is full, and
  :class:`ServiceClosedError` after ``close()``;
* **deadlines**: each request may carry one (``deadline_ms`` per
  request, ``default_deadline_ms`` service-wide); expired requests are
  shed — by timer while queued, and again post-compile at launch —
  with :class:`DeadlineExceededError` instead of wasting device time;
* **backpressure**: with ``high_water`` set, admission that leaves the
  backlog at/above the watermark force-launches the fullest buckets
  (counted as ``backpressure_flushes``);
* **execution failures** never escape ``poll()``/``flush()``/
  ``submit()``: the executor retries the batch with backoff, then
  bisect-quarantines so only poisoned requests fail (typed) while
  healthy co-batched requests complete bit-exactly — on the same
  engine and device, never falling back to another; the slot engine
  evicts its whole session into the same ladder;
* **partial convergence** (scheduler watchdog) is delivered as a
  degraded result (``Ticket.degraded``), counted per bucket and in the
  lifecycle counters.

Adaptive bucketing: with ``adaptive_quantum=True`` the per-run-
signature traffic histograms (``ServeMetrics.traffic``) periodically
re-evaluate ``pad_quantum`` — high pad waste halves the quantum
(``quantum_splits``), many distinct bucket grids at negligible waste
doubles it (``quantum_merges``).

Deterministic fault injection (``serve/faults.py``, ``REPRO_FAULTS``)
enters at the named sites; a Service built without ``faults=`` picks up
the environment schedule.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.backend import (as_dtype, canonicalize_backend,
                                      resolve_device)
from repro_torch.serve import faults as F
from repro_torch.serve import registry
from repro_torch.serve.bucketer import (BucketKey, BucketQueue,
                                        PendingRequest, Ticket, bucket_hw,
                                        canonical_batch, check_payload,
                                        pad_fill)
from repro_torch.serve.cache import CacheEntry, CompiledProgramCache
from repro_torch.serve.continuous import SlotEngine
from repro_torch.serve.errors import (DeadlineExceededError,
                                      InvalidRequestError, QueueFullError,
                                      ServiceClosedError,
                                      UnsupportedDtypeError)
from repro_torch.serve.executor import Executor, Staged
from repro_torch.serve.loop import EventLoop
from repro_torch.serve.metrics import ServeMetrics


class Service:
    def __init__(
        self,
        *,
        backend: str = "cuda",
        max_batch: int = 8,
        max_delay_ms: float = 5.0,
        pad_quantum: int = 64,
        cache_capacity: int = 64,
        pipeline_depth: int = 2,
        max_queue: int | None = None,
        default_deadline_ms: float | None = None,
        max_retries: int = 2,
        retry_backoff_ms: float = 0.0,
        continuous: bool = False,
        refill_quantum: int = 4,
        high_water: int | None = None,
        adaptive_quantum: bool = False,
        adapt_every: int = 16,
        clock=time.monotonic,
        sleep=time.sleep,
        loop: EventLoop | None = None,
        faults: F.FaultInjector | None = None,
        device=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if high_water is not None and high_water < 1:
            raise ValueError("high_water must be >= 1 (or None to disable)")
        if adapt_every < 1:
            raise ValueError("adapt_every must be >= 1")
        if refill_quantum < 1:
            raise ValueError("refill_quantum must be >= 1")
        self.backend = canonicalize_backend(backend)
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.pad_quantum = pad_quantum
        self.max_queue = max_queue
        self.default_deadline_ms = default_deadline_ms
        self.high_water = high_water
        self.continuous = continuous
        self.refill_quantum = refill_quantum
        self.adaptive_quantum = adaptive_quantum
        self.adapt_every = adapt_every
        self.loop = loop if loop is not None else EventLoop(clock)
        self.clock = self.loop.clock
        self.faults = faults if faults is not None else F.from_env()
        self.metrics = ServeMetrics()
        self.cache = CompiledProgramCache(cache_capacity)
        # source graphs seen per compiled-program identity, so the
        # ``programs_shared`` counter can spot distinct operators whose
        # (rewritten) run phases land on one compiled program
        self._program_sources: dict = {}
        self.executor = Executor(self.metrics, depth=pipeline_depth,
                                 clock=self.clock, faults=self.faults,
                                 max_retries=max_retries,
                                 backoff_s=retry_backoff_ms / 1e3,
                                 sleep=sleep, device=self.device)
        self._queue = BucketQueue(max_batch, max_delay_ms / 1e3)
        self._engines: dict[BucketKey, SlotEngine] = {}
        self._assets: dict[str, np.ndarray] = {}
        self._flush_timers: dict[BucketKey, object] = {}
        self._quantum: dict[str, int] = {}  # adaptive per-sig overrides
        self._closed = False
        self._next_id = 0

    # -- pinned assets -----------------------------------------------------

    def pin(self, name: str, image) -> None:
        """Pin a host image under ``name`` so later ``submit`` calls can
        pass the name in place of the array — the incremental-update
        pattern: pin the (large, unchanging) image once, then stream
        cheap marker/seed updates against it, e.g.
        ``service.pin("slice", ct); service.submit("gdt", "slice",
        scribbles)``.  Requests resolving a pinned asset count into the
        ``asset_hits`` metric.  Re-pinning a name replaces it (later
        submits see the new array; staged requests keep the old one)."""
        arr = np.asarray(image)
        if arr.ndim != 2:
            raise InvalidRequestError(
                f"pin({name!r}): expected a 2-D image, got shape "
                f"{arr.shape}")
        self._assets[str(name)] = arr

    def unpin(self, name: str) -> None:
        """Drop a pinned asset (KeyError when absent)."""
        del self._assets[name]

    # -- request intake ----------------------------------------------------

    def submit(self, op: str, *images, params=None,
               deadline_ms: float | None = None) -> Ticket:
        """Enqueue one request; returns a :class:`Ticket` whose
        ``result()`` drives the pipeline as needed.

        Admission is the only stage that raises: malformed requests get
        a typed :class:`~repro.serve.errors.RequestRejected` subclass,
        a full bounded queue gets :class:`QueueFullError`, a closed
        service :class:`ServiceClosedError`.  Once a ticket is
        returned, every later failure is recorded *on the ticket*
        (typed), never raised from ``poll``/``flush``.

        ``deadline_ms`` (or the service's ``default_deadline_ms``)
        bounds how long the request may sit queued: an expiry timer
        sheds it with :class:`DeadlineExceededError` the moment its
        deadline lapses (launch re-checks after compiling, too).
        """
        if self._closed:
            self.metrics.count("rejected")
            raise ServiceClosedError(
                f"op {op!r}: service is closed — no new requests admitted")
        try:
            spec, imgs, canon = self._admit(op, images, params)
        except Exception:
            self.metrics.count("rejected")
            raise
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            self.metrics.count("shed")
            raise QueueFullError(
                f"op {op!r}: queue full ({self.max_queue} pending) — "
                "request load-shed; retry later or raise max_queue"
            )
        info = registry.request_info(op, canon)
        if info.n_rewrites:
            self.metrics.count("rewrites_applied", info.n_rewrites)
        self.metrics.record_arrival(info.label, imgs[0].shape)
        if self.adaptive_quantum and info.pad_safe:
            self._adapt_quantum(info)

        if self.faults.should_fire("deadline"):
            deadline_ms = self.faults.value("deadline", 0.0)
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms

        now = self.clock()
        ticket = Ticket(
            request_id=self._next_id, op=op, t_enqueue=now,
            deadline=None if deadline_ms is None else now + deadline_ms / 1e3,
            _service=self,
        )
        self._next_id += 1
        req = PendingRequest(
            ticket=ticket, images=imgs,
            inputs=spec.prepare_inputs(imgs, canon), shape=imgs[0].shape,
            info=info, finalize=registry.request_finalize(op, canon),
            poisoned=self.faults.should_fire("poison"),
        )
        key = self._bucket_for(info, imgs[0].shape, imgs[0].dtype)
        ticket._bucket_key = key
        ticket._queued = True
        if ticket.deadline is not None:
            # strict `now > deadline` shedding: fire just past the line
            req.timer = self.loop.call_at(
                ticket.deadline + 1e-9,
                functools.partial(self._expire, key, req))
        filled = self._queue.add(key, req)
        if filled:
            self._launch(key)
        elif self._queue.size(key) == 1:
            self._rearm_flush(key)
        if (self.high_water is not None
                and len(self._queue) >= self.high_water):
            self._backpressure()
        self.loop.run_due()
        return ticket

    def _admit(self, op: str, images, params):
        """Admission validation: typed rejections, nothing staged yet."""
        spec = registry.get(op)
        if len(images) != spec.arity:
            raise InvalidRequestError(
                f"op {op!r} takes {spec.arity} image(s), got {len(images)}"
            )
        resolved = []
        for im in images:
            if isinstance(im, str):
                try:
                    im = self._assets[im]
                except KeyError:
                    raise InvalidRequestError(
                        f"op {op!r}: unknown pinned asset {im!r} "
                        f"(pinned: {sorted(self._assets)})") from None
                self.metrics.count("asset_hits")
            resolved.append(im)
        imgs = tuple(np.asarray(im) for im in resolved)
        for im in imgs:
            if im.ndim != 2:
                raise InvalidRequestError(
                    f"op {op!r}: expected 2-D images, got shape {im.shape}"
                )
            if im.shape != imgs[0].shape or im.dtype != imgs[0].dtype:
                raise InvalidRequestError(
                    f"op {op!r}: all inputs must share shape/dtype; got "
                    f"{[(i.shape, str(i.dtype)) for i in imgs]}"
                )
        check_payload(op, imgs)  # lattice dtype + non-finite rejection
        if np.dtype(imgs[0].dtype).kind not in spec.dtypes:
            raise UnsupportedDtypeError(
                f"op {op!r} supports dtype kinds {spec.dtypes!r}, got "
                f"{imgs[0].dtype} (gdt-backed ops iterate a float "
                "distance lattice)"
            )
        return spec, imgs, spec.canonical_params(params)

    # -- engine pumping ----------------------------------------------------

    def poll(self) -> None:
        """Pump the engine once: fire due timers (bucket flushes,
        request expiries) and advance every slot engine one round.

        Part of the robustness contract: ``poll`` never raises — batch
        failures resolve into typed per-ticket errors via the
        executor's recovery ladder.
        """
        self.loop.run_due()
        self._step_engines()

    def pump(self) -> bool:
        """One cooperative engine turn: timers, one engine round each,
        one pipeline drain.  Returns True when any progress was made
        (the asyncio front-end's trampoline unit)."""
        progress = self.loop.run_due() > 0
        progress = self._step_engines() or progress
        if self.executor.inflight:
            progress = self.executor.drain_one() or progress
        return progress

    def flush(self) -> None:
        """Launch every queued bucket, run every slot engine to empty
        and drain the whole pipeline."""
        while True:
            for key in self._queue.keys():
                self._launch(key)
            if not self._step_engines() and not len(self._queue):
                break
        self.executor.drain_all()

    def close(self) -> None:
        """Drain everything, then refuse new work (idempotent).
        Requests admitted before close still reach terminal outcomes."""
        if not self._closed:
            self.flush()
            self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def work_pending(self) -> bool:
        """True while anything queued, resident in a slot engine, or in
        the executor pipeline still needs pumping."""
        return bool(len(self._queue) or self.executor.inflight
                    or any(e.occupied for e in self._engines.values()))

    def next_deadline(self) -> float | None:
        """Earliest armed timer (flush/expiry) on the service clock —
        what the asyncio front-end turns into a real wakeup."""
        return self.loop.next_deadline()

    def _step_engines(self) -> bool:
        progress = False
        for engine in list(self._engines.values()):
            progress = engine.step() or progress
        return progress

    def _complete(self, ticket: Ticket) -> None:
        """Drive the engine until ``ticket`` resolves (Ticket.result)."""
        while not ticket.done:
            progress = self.loop.run_due() > 0
            if ticket._queued:
                self._launch(ticket._bucket_key)
                progress = True
            progress = self._step_engines() or progress
            progress = self.executor.drain_one() or progress
            if not progress:
                break

    # -- bucket launch -----------------------------------------------------

    def _rearm_flush(self, key: BucketKey) -> None:
        """(Re-)arm the bucket's deadline-flush timer for its current
        oldest request; cancel it when the bucket is empty."""
        old = self._flush_timers.pop(key, None)
        if old is not None:
            old.cancel()
        oldest = self._queue.oldest(key)
        if oldest is not None:
            self._flush_timers[key] = self.loop.call_at(
                oldest.ticket.t_enqueue + self._queue.max_delay_s,
                functools.partial(self._launch, key))

    def _expire(self, key: BucketKey, req: PendingRequest) -> None:
        """Expiry-timer callback: shed ``req`` if it is still queued
        (deadlines only bound queue time; in-flight requests finish)."""
        req.timer = None
        t = req.ticket
        if t.done or not t._queued:
            return
        if not self._queue.discard(key, req):
            return
        t._queued = False
        now = self.clock()
        t.error = DeadlineExceededError(
            f"request {t.request_id} ({t.op}) waited "
            f"{(now - t.t_enqueue) * 1e3:.1f}ms, past its deadline"
        )
        t._fulfill(now)
        self.metrics.count("expired")
        self._rearm_flush(key)  # the bucket's oldest may have changed

    def _backpressure(self) -> None:
        """Watermark relief: force-launch the fullest buckets until the
        backlog drops below ``high_water`` (or nothing can launch)."""
        while self._queue.keys() and len(self._queue) >= self.high_water:
            key = max(self._queue.keys(), key=self._queue.size)
            before = len(self._queue)
            self.metrics.count("backpressure_flushes")
            self._launch(key)
            if len(self._queue) >= before:
                break  # engine full / everything shed: don't spin

    def _launch(self, key: BucketKey) -> None:
        """Launch one bucket: into its slot engine when continuous and
        refillable, else as one canonical batch.  Never raises."""
        timer = self._flush_timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        engine = self._engines.get(key)
        if engine is None and self.continuous:
            engine = self._spawn_engine(key)
        if engine is not None:
            engine.pull()
            self._rearm_flush(key)
            return
        requests = self._queue.pop(key)
        for req in requests:
            req.ticket._queued = False
            if req.timer is not None:
                req.timer.cancel()
                req.timer = None
        self._rearm_flush(key)  # anything beyond max_batch stays queued
        requests = self._shed_expired(requests)
        if not requests:
            return
        info = requests[0].info
        runner = functools.partial(self._run_sync, key, info)
        n_slots = canonical_batch(len(requests), self.max_batch)
        try:
            entry = self._entry_for(key, info, n_slots, warm=False)
            # deadline re-check *after* compiling: a request whose
            # deadline lapsed during a long trace/compile must not be
            # dispatched (the old poll-time-only check raced here)
            live = self._shed_expired(requests)
            if not live:
                return
            if len(live) < len(requests):
                requests = live
                n_slots = canonical_batch(len(requests), self.max_batch)
                entry = self._entry_for(key, info, n_slots, warm=False)
            stacked = self._stage(info, key, requests, n_slots)
            self.faults.check("dispatch", key.label())
            self._check_poison(requests)
        except Exception as exc:
            # staging/compile/injected failure before dispatch: the
            # requests are already out of the queue — hand them to the
            # recovery ladder instead of stranding them (or raising out
            # of poll()).
            self.executor.recover(key, requests, runner, exc)
            return
        self.executor.dispatch(entry, key, requests, n_slots, stacked,
                               runner=runner)

    def _spawn_engine(self, key: BucketKey) -> SlotEngine | None:
        """Build the bucket's slot engine if its program is refillable
        (one convergent segment on the ``"cuda"`` engine); None routes
        to the batch path.  Compile failures fall through — the batch
        path's ladder reports them."""
        oldest = self._queue.oldest(key)
        if oldest is None or oldest.info.expr is None:
            return None
        try:
            entry = self._entry_for(key, oldest.info, self.max_batch,
                                    warm=False)
        except Exception:
            return None
        if entry.exe is None or not entry.exe.refillable:
            return None
        engine = SlotEngine(self, key, oldest.info, entry)
        self._engines[key] = engine
        return engine

    def _shed_expired(self, requests):
        """Deadline shedding at launch: typed errors, no device time."""
        now = self.clock()
        live = []
        for req in requests:
            t = req.ticket
            if t.done:
                continue  # expiry timer beat us to it
            if t.deadline is not None and now > t.deadline:
                if req.timer is not None:
                    req.timer.cancel()
                    req.timer = None
                t.error = DeadlineExceededError(
                    f"request {t.request_id} ({t.op}) waited "
                    f"{(now - t.t_enqueue) * 1e3:.1f}ms, past its deadline"
                )
                t._fulfill(now)
                self.metrics.count("expired")
            else:
                live.append(req)
        return live

    @staticmethod
    def _check_poison(requests) -> None:
        """Fault site: a poisoned request kills any batch containing it
        (deterministically — that is what bisect-retry needs)."""
        for req in requests:
            if req.poisoned:
                raise F.InjectedFault(
                    "poison", f"request {req.ticket.request_id}")

    def _run_sync(self, key: BucketKey, info, requests):
        """Synchronous (re-)execution for the executor's recovery
        ladder: restage the given subset, run, block.  Returns
        ``(outputs, n_slots, converged)``."""
        n_slots = canonical_batch(len(requests), self.max_batch)
        entry = self._entry_for(key, info, n_slots, warm=False)
        stacked = self._stage(info, key, requests, n_slots)
        self._check_poison(requests)
        outputs, conv = self.executor.run_now(entry, stacked)
        return outputs, n_slots, conv

    # -- bucketing policy --------------------------------------------------

    def _bucket_for(self, info, shape, dtype) -> BucketKey:
        """The one place (submit + warmup) bucket keys are derived."""
        h, w = shape
        quantum = self._quantum.get(info.label, self.pad_quantum)
        return BucketKey(
            sig=info.sig,
            hw=bucket_hw(h, w, quantum) if info.pad_safe else (h, w),
            dtype=str(np.dtype(dtype)),
            tag=info.label,
        )

    def _adapt_quantum(self, info) -> None:
        """Periodically re-fit the run signature's pad quantum to its
        observed traffic (every ``adapt_every`` arrivals): pad waste
        above 25% halves the quantum (``quantum_splits``), while many
        distinct bucket grids at under 5% waste doubles it
        (``quantum_merges``) to recover co-batching.  Pure function of
        the arrival history — deterministic under the virtual clock."""
        ts = self.metrics.traffic.get(info.label)
        if ts is None or ts.arrivals % self.adapt_every:
            return
        q = self._quantum.get(info.label, self.pad_quantum)
        raw = padded = 0
        grids = set()
        for (h, w), n in ts.shapes.items():
            hh, ww = bucket_hw(h, w, q)
            raw += n * h * w
            padded += n * hh * ww
            grids.add((hh, ww))
        if not padded:
            return
        waste = 1.0 - raw / padded
        if waste > 0.25 and q > 8:
            self._quantum[info.label] = q // 2
            self.metrics.count("quantum_splits")
        elif waste < 0.05 and len(grids) > 2 and q < 1024:
            self._quantum[info.label] = q * 2
            self.metrics.count("quantum_merges")

    # -- compile-or-hit ----------------------------------------------------

    def _cache_identity(self, key: BucketKey, info, n_slots: int):
        """The cache key (and, for expression ops, the Executable —
        compiling is a cheap cached lookup).  The ``budget`` fault site
        compiles with an injected ``max_chunks``; since ``max_chunks``
        is part of ``Executable.key``, injected and clean programs never
        share a cache entry."""
        if info.expr is not None:
            budget = self.faults.value("budget", None)
            exe = api.compile(
                info.expr, (n_slots, *key.hw), np.dtype(key.dtype),
                self.backend,
                max_chunks=None if budget is None else int(budget),
                device=self.device,
            )
            if info.source is not None:
                seen = self._program_sources.setdefault(exe.key, set())
                if info.source not in seen:
                    if seen:
                        self.metrics.count("programs_shared")
                    seen.add(info.source)
            return exe.key, exe
        return (info.sig, (n_slots, *key.hw), key.dtype, self.backend,
                str(self.device)), None

    def _entry_for(self, key: BucketKey, info, n_slots: int,
                   warm: bool) -> CacheEntry:
        """Compiled bucket program: the cache key *is* the compile key."""
        lookup = self.cache.warm if warm else self.cache.get
        cache_key, exe = self._cache_identity(key, info, n_slots)
        if exe is not None:
            return lookup(
                cache_key,
                lambda: CacheEntry(fn=exe.run_batch, plan=exe.plan,
                                   key=cache_key,
                                   stats_fn=exe.run_batch_stats, exe=exe),
            )
        spec = registry.get(info.sig[1])  # ("custom", name, canon)
        return lookup(
            cache_key,
            functools.partial(self._build_custom, spec, info.sig[2], key,
                              n_slots, cache_key),
        )

    def _build_custom(self, spec, canon: tuple, key: BucketKey,
                      n_slots: int, cache_key: tuple) -> CacheEntry:
        h, w = key.hw
        plan = None
        if self.backend == "cuda" and spec.plan_builder is not None:
            plan = spec.plan_builder(n_slots, h, w, np.dtype(key.dtype),
                                     dict(canon))

        def call(*inputs):
            out = spec.run(inputs, canon, self.backend, plan)
            return out if isinstance(out, tuple) else (out,)

        return CacheEntry(fn=call, plan=plan, key=cache_key)

    def _stage(self, info, key: BucketKey, requests,
               n_slots: int) -> Staged:
        """Host staging: pad each canonical input to the bucket shape and
        stack, in NumPy into the executor's (pinned) host buffers, then
        copy the stacks to the device on the executor's stream; sentinel
        slots keep the absorbing fill (they converge in one chunk under
        the active-tile scheduler)."""
        h, w = key.hw
        dtype = np.dtype(key.dtype)
        host = []
        for j in range(info.n_inputs):
            buf = self.executor.host_buffer((n_slots, h, w), as_dtype(dtype))
            arr = buf.numpy()
            arr[...] = pad_fill(dtype, info.fills[j])
            for i, req in enumerate(requests):
                rh, rw = req.shape
                arr[i, :rh, :rw] = np.asarray(req.inputs[j])
            host.append(buf)
        return self.executor.upload(tuple(host))

    # -- warm-up + introspection ------------------------------------------

    def warmup(self, entries) -> None:
        """Prefill the compiled-program cache.

        ``entries`` is an iterable of dicts with keys ``op``, ``shape``
        (H, W), ``dtype`` and optionally ``params`` / ``batch`` (defaults
        to ``max_batch``).  Each entry is compiled *and* executed once on
        a sentinel-only stack, so first real traffic pays for neither a
        compile nor a kernel build; warm builds are excluded from
        hit/miss stats.  With ``continuous=True`` a refillable bucket's
        slot session (init/admit/round/extract) runs once too.
        """
        for e in entries:
            spec = registry.get(e["op"])
            canon = spec.canonical_params(e.get("params"))
            info = registry.request_info(e["op"], canon)
            key = self._bucket_for(info, e["shape"], e["dtype"])
            n_slots = canonical_batch(e.get("batch", self.max_batch),
                                      self.max_batch)
            cache_key, _ = self._cache_identity(key, info, n_slots)
            if cache_key not in self.cache:
                entry = self._entry_for(key, info, n_slots, warm=True)
                # execute the callable dispatch will use (the stats
                # variant for expression programs)
                self.executor.run_now(
                    entry, self._stage(info, key, [], n_slots))
            if self.continuous and info.expr is not None:
                self._warm_session(key, info)

    def _warm_session(self, key: BucketKey, info) -> None:
        """Run a refillable bucket's slot-session entry points once on a
        sentinel slot, on the executor's stream, so the first continuous
        round pays for no kernel build or first-call set-up."""
        entry = self._entry_for(key, info, self.max_batch, warm=True)
        if entry.exe is None or not entry.exe.refillable:
            return
        session = entry.exe.slot_session(self.refill_quantum)
        dtype = np.dtype(key.dtype)
        with self.executor.on_stream():
            sentinels = tuple(
                torch.full(key.hw, pad_fill(dtype, info.fills[j]).item(),
                           dtype=as_dtype(dtype), device=self.device)
                for j in range(info.n_inputs))
            state = session.admit(session.init(), 0, *sentinels)
            state, _, _ = session.round(state)
            session.extract(state)
        if self.executor.stream is not None:
            self.executor.stream.synchronize()

    def stats(self) -> dict:
        """Metrics summary (buckets/totals/counters/cache/faults),
        JSON-serializable."""
        out = self.metrics.summary(self.cache.stats())
        out["faults"] = self.faults.snapshot()
        return out

    def bench_rows(self) -> list[dict]:
        """Rows in the benchmarks ``name,us_per_call,derived`` contract
        (per-bucket latency/throughput plus the lifecycle counters)."""
        return (self.metrics.bench_rows(self.cache.stats())
                + self.metrics.counter_rows())

    def pending(self) -> int:
        """Requests awaiting a result: queued plus resident in slot
        engines (in-flight executor batches are not counted — they are
        already past admission/launch)."""
        return len(self._queue) + sum(e.n_occupied
                                      for e in self._engines.values())


class AsyncService:
    """asyncio front-end: the same engine, with timers trampolined onto
    the running event loop so deadline flushes and expiries fire with
    **no caller**, and tickets awaitable as futures.

    Must be constructed inside a running asyncio event loop (the
    service clock defaults to ``loop.time`` so service timers and
    asyncio wakeups share one timebase).  ``submit`` is synchronous
    (admission raises immediately, as with :class:`Service`) and
    returns the plain :class:`Ticket`; ``await result(ticket)`` parks
    until the engine completes it.  Device rounds run *on* the loop
    thread — the engine is single-threaded by design — so concurrency
    here means overlapping request lifetimes, not parallel compute.
    """

    def __init__(self, *, loop=None, **kwargs):
        import asyncio
        self._aio = loop if loop is not None else asyncio.get_running_loop()
        kwargs.setdefault("clock", self._aio.time)
        self.service = Service(**kwargs)
        self._handle = None

    def submit(self, op: str, *images, params=None,
               deadline_ms: float | None = None) -> Ticket:
        ticket = self.service.submit(op, *images, params=params,
                                     deadline_ms=deadline_ms)
        self._schedule()
        return ticket

    async def result(self, ticket: Ticket):
        """Await the ticket's terminal outcome, then unwrap it (raises
        its typed error exactly like ``Ticket.result``)."""
        if not ticket.done:
            fut = self._aio.create_future()
            ticket.add_done_callback(
                lambda t: fut.done() or fut.set_result(None))
            self._schedule()
            await fut
        if ticket.error is not None:
            raise ticket.error
        return ticket.value

    async def run(self, op: str, *images, params=None,
                  deadline_ms: float | None = None):
        """submit + await result in one call."""
        return await self.result(self.submit(
            op, *images, params=params, deadline_ms=deadline_ms))

    async def close(self):
        """Drain all outstanding work (yielding between pump turns),
        then close the underlying service."""
        import asyncio
        while self.service.work_pending():
            self.service.pump()
            await asyncio.sleep(0)
        self.service.close()
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def stats(self) -> dict:
        return self.service.stats()

    # -- trampoline --------------------------------------------------------

    def _schedule(self) -> None:
        """Arm the next wakeup: immediately while work is in flight,
        else at the service's earliest timer deadline."""
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        svc = self.service
        if svc.work_pending():
            self._handle = self._aio.call_soon(self._pump)
            return
        nxt = svc.next_deadline()
        if nxt is not None:
            self._handle = self._aio.call_later(
                max(0.0, nxt - svc.clock()), self._pump)

    def _pump(self) -> None:
        self._handle = None
        self.service.pump()
        self._schedule()


def serve_stream(service: Service, requests) -> list:
    """Convenience driver: submit ``(op, images, params)`` triples (or
    ``(op, image)`` pairs), flush, and return results in order."""
    tickets = []
    for r in requests:
        op, rest = r[0], r[1:]
        params = rest[-1] if rest and isinstance(rest[-1], dict) else None
        images = rest[:-1] if params is not None else rest
        images = images[0] if len(images) == 1 and isinstance(
            images[0], (tuple, list)) else images
        tickets.append(service.submit(op, *images, params=params))
    service.flush()
    return [t.result() for t in tickets]
