"""repro_torch.serve — shape-bucketed micro-batching service for the
geodesic operators on the GPU, with a compiled-plan cache and a
double-buffered pipeline on one CUDA stream (port of ``repro.serve``,
its default batch path).

One stage per module, as in the reference:

``registry``
    every public operator of ``core.operators`` / ``kernels.ops`` /
    ``gdt`` declared as data (name + param schema + expression builder
    via their ``SERVE_OPS`` hooks); the registry lowers each expression
    through ``repro_torch.api.lower`` and derives the prepare/run/
    finalize stages, pad fills and bucket identity from the lowered
    program.
``bucketer``
    heterogeneous requests coalesced into ``(N, H, W)`` stacks per
    (run-signature, padded-shape, dtype) bucket — HMAX/DOME/RAOBJ
    co-batch — with absorbing-identity padding and a ``max_delay_ms``
    deadline, so stragglers never wait for traffic that may not come.
``cache``
    the LRU compiled-program cache keyed on ``Executable.key`` (lowered
    run signature + bucket shape/dtype/backend + plan key + device).
``executor``
    overlaps *host staging* of the next stack with *device compute* of
    the current one (one CUDA stream per executor, an event per batch,
    bounded in-flight depth = double buffering) and demuxes per-request
    results, cropping bucket padding and dropping sentinel slots.
``metrics``
    per-bucket latency percentiles, batch occupancy, cache hit-rate and
    FPS / MPx-per-s, in the reference's ``stats()``/``bench_rows()``
    schema.
``errors``, ``faults``, ``loop``
    the typed error taxonomy, the seeded fault-injection harness (the
    sites dispatch/drain/poison/deadline/budget) and the deterministic
    timer loop with its injectable clocks — copies of the reference's.
``continuous``
    continuous batching: :class:`SlotEngine` keeps a resident
    :class:`~repro_torch.api.executable.SlotSession` per refillable
    bucket and refills slots the moment their image converges, while
    stragglers keep iterating (``Service(continuous=True)``).
``service``
    :class:`Service` (admission, deadlines, backpressure, adaptive pad
    quantum, ``pin``/``unpin``, ``warmup``, ``stats``, ``bench_rows``),
    the asyncio front-end :class:`AsyncService` and ``serve_stream``.

``Service()`` runs on the GPU (``device=None``) and raises without one;
the tests pass ``device="cpu"``, where the ``"cuda"`` engine's kernel
wrappers run their plain PyTorch versions.
"""
from repro_torch.serve import errors, faults, registry
from repro_torch.serve.bucketer import (BucketKey, Ticket, bucket_hw,
                                        canonical_batch)
from repro_torch.serve.cache import CacheEntry, CompiledProgramCache
from repro_torch.serve.continuous import SlotEngine
from repro_torch.serve.errors import (DeadlineExceededError, ExecutorError,
                                      InvalidRequestError,
                                      NonFiniteInputError,
                                      PoisonedRequestError, QueueFullError,
                                      RequestRejected, ServeError,
                                      ServiceClosedError,
                                      UnsupportedDtypeError)
from repro_torch.serve.executor import Executor
from repro_torch.serve.faults import FaultInjector, FaultSpec, InjectedFault
from repro_torch.serve.loop import EventLoop, VirtualClock
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.service import AsyncService, Service, serve_stream

__all__ = [
    "AsyncService",
    "BucketKey",
    "CacheEntry",
    "CompiledProgramCache",
    "DeadlineExceededError",
    "EventLoop",
    "Executor",
    "ExecutorError",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "InvalidRequestError",
    "NonFiniteInputError",
    "PoisonedRequestError",
    "QueueFullError",
    "RequestRejected",
    "ServeError",
    "ServeMetrics",
    "Service",
    "ServiceClosedError",
    "SlotEngine",
    "Ticket",
    "UnsupportedDtypeError",
    "VirtualClock",
    "bucket_hw",
    "canonical_batch",
    "errors",
    "faults",
    "registry",
    "serve_stream",
]
