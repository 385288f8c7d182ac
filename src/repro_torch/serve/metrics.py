"""Serving metrics: per-bucket latency percentiles, batch occupancy,
throughput (FPS / MPx-per-s) and cache statistics (a copy of
``repro.serve.metrics``: the same ``stats()``/``bench_rows()`` schema).

Throughput is measured over the *wall span* of each bucket (first
dispatch → last drain), not the sum of per-batch intervals — with the
double-buffered executor those intervals overlap, and summing them
would understate FPS exactly when the pipelining works.  Latency
percentiles are computed over a bounded window of the most recent
``LATENCY_WINDOW`` requests per bucket, so a long-running service keeps
O(1) memory per bucket while ``requests`` counts the full history.

``bench_rows()`` / ``as_bench_json()`` emit the same row contract as
``benchmarks/run.py`` (``name,us_per_call,derived`` rows and the
``--json`` name → us_per_call mapping), so serving throughput lands in
the same machine-readable perf trajectory as the kernel benchmarks.
Every emitted field is documented in ``docs/BENCHMARKS.md``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

#: Most recent per-bucket request latencies retained for percentiles.
LATENCY_WINDOW = 4096

#: Lifecycle counters always present in ``summary()["counters"]`` (and
#: as ``serve/counters/*`` rows), so the benchmarks JSON schema is
#: stable whether or not faults occurred.  Semantics (full contract in
#: ``docs/ROBUSTNESS.md``):
#:   rejected    admission-time typed rejections (invalid/non-finite/
#:               unsupported dtype/unknown op)
#:   shed        requests load-shed because the bounded queue was full
#:   expired     requests whose deadline passed while queued (shed at
#:               launch with DeadlineExceededError)
#:   retried     whole-batch retry attempts after an executor failure
#:   poisoned    requests isolated by bisect-retry quarantine
#:   degraded    requests whose convergence watchdog tripped (partial
#:               result returned, Ticket.degraded = True)
#:   batch_failures    batches whose first execution failed
#:   quarantine_reruns successful sub-batch re-executions during bisect
#:   rewrites_applied  optimizer rule applications behind admitted
#:                     requests (``repro_torch.opt``; 0 for already-canonical
#:                     graphs)
#:   programs_shared   times a distinct source graph joined an
#:                     already-compiled program identity (rewrite
#:                     canonicalization or run-signature co-batching)
#:   refills           requests admitted into a continuous-batching
#:                     slot freed mid-flight (other slots still
#:                     iterating) — the continuous-batching win counter
#:   backpressure_flushes  eager bucket launches forced by the
#:                     ``high_water`` backpressure watermark
#:   quantum_splits    adaptive pad_quantum decisions that *shrank* a
#:                     run signature's bucket quantum (splitting
#:                     buckets to cut pad waste)
#:   quantum_merges    adaptive pad_quantum decisions that *grew* it
#:                     (merging sparse buckets to recover co-batching)
COUNTERS = ("rejected", "shed", "expired", "retried", "poisoned",
            "degraded", "batch_failures", "quarantine_reruns",
            "rewrites_applied", "programs_shared", "refills",
            "backpressure_flushes", "quantum_splits", "quantum_merges")


#: Distinct request shapes tracked per run signature (oldest-seen kept:
#: deterministic, bounded).
TRAFFIC_SHAPES = 64


@dataclasses.dataclass
class TrafficStats:
    """Per-run-signature arrival histogram driving the adaptive
    ``pad_quantum``/bucket-split policy: how many requests arrived and
    with which raw (H, W) shapes.  Deliberately tiny and deterministic
    — a Counter over shapes, capped at :data:`TRAFFIC_SHAPES` distinct
    entries — so the policy replays identically under the virtual
    clock."""

    arrivals: int = 0
    shapes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def record(self, shape) -> None:
        self.arrivals += 1
        key = (int(shape[0]), int(shape[1]))
        if key in self.shapes or len(self.shapes) < TRAFFIC_SHAPES:
            self.shapes[key] += 1


@dataclasses.dataclass
class _BucketStats:
    requests: int = 0
    batches: int = 0
    slots: int = 0
    pixels: int = 0
    errors: int = 0
    degraded: int = 0
    rounds: int = 0            # continuous-engine scheduler rounds
    slot_rounds: int = 0       # rounds × engine slots (capacity)
    busy_slot_rounds: int = 0  # slot-rounds spent on live requests
    busy_chunks: int = 0       # scheduler chunks spent on live images
    cap_chunks: int = 0        # chunks × slots the device was held for
    t_first: float | None = None   # earliest dispatch seen
    t_last: float = 0.0            # latest drain seen
    latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=LATENCY_WINDOW)
    )

    @property
    def occupancy(self) -> float:
        """Fraction of device capacity spent on real work.  Under the
        continuous engine this is busy slot-rounds over total
        slot-rounds (time-weighted, the honest number when slots refill
        mid-flight); the batch path keeps requests-over-slots."""
        if self.slot_rounds:
            return self.busy_slot_rounds / self.slot_rounds
        return self.requests / self.slots if self.slots else 0.0

    @property
    def work_occupancy(self) -> float:
        """Chunk-weighted utilization: scheduler chunks spent on live
        image work over the chunk-slots the device was held for.  The
        one occupancy number comparable across the batch path and the
        continuous engine — batch fill (``occupancy``) cannot see a
        converged slot parked behind a straggler, this can.  Falls back
        to :attr:`occupancy` when no chunk telemetry was recorded
        (custom ops, fixed-length chains)."""
        if self.cap_chunks:
            return self.busy_chunks / self.cap_chunks
        return self.occupancy

    @property
    def span_s(self) -> float:
        if self.t_first is None:
            return 0.0
        return max(0.0, self.t_last - self.t_first)


class ServeMetrics:
    def __init__(self):
        self._buckets: dict[str, _BucketStats] = {}
        self.counters = collections.Counter()
        self.traffic: dict[str, TrafficStats] = {}

    def count(self, name: str, n: int = 1) -> None:
        """Bump one lifecycle counter (see :data:`COUNTERS`)."""
        self.counters[name] += n

    def record_arrival(self, sig_label: str, shape) -> None:
        """Feed the per-run-signature traffic histogram (adaptive
        ``pad_quantum`` input; see :class:`TrafficStats`)."""
        self.traffic.setdefault(sig_label, TrafficStats()).record(shape)

    def record_round(self, label: str, *, n_busy: int, n_slots: int,
                     t: float, busy_chunks: int = 0,
                     cap_chunks: int = 0) -> None:
        """One continuous-engine scheduler round: ``n_busy`` of
        ``n_slots`` slots held live requests at time ``t``, consuming
        ``busy_chunks`` of ``cap_chunks`` chunk-slots.  Feeds the
        time-weighted occupancy, the chunk-weighted work occupancy and
        the bucket wall span."""
        b = self._buckets.setdefault(label, _BucketStats())
        b.rounds += 1
        b.slot_rounds += n_slots
        b.busy_slot_rounds += n_busy
        b.busy_chunks += busy_chunks
        b.cap_chunks += cap_chunks
        b.t_first = t if b.t_first is None else min(b.t_first, t)
        b.t_last = max(b.t_last, t)

    def record_batch(
        self,
        label: str,
        *,
        n_real: int,
        n_slots: int,
        pixels: int,
        t_dispatch: float,
        t_done: float,
        latencies_s,
        n_errors: int = 0,
        n_degraded: int = 0,
        busy_chunks: int = 0,
        cap_chunks: int = 0,
    ) -> None:
        b = self._buckets.setdefault(label, _BucketStats())
        b.requests += n_real
        b.batches += 1
        b.slots += n_slots
        b.pixels += pixels
        b.errors += n_errors
        b.degraded += n_degraded
        b.busy_chunks += busy_chunks
        b.cap_chunks += cap_chunks
        b.t_first = t_dispatch if b.t_first is None else min(b.t_first,
                                                             t_dispatch)
        b.t_last = max(b.t_last, t_done)
        b.latencies_s.extend(float(t) for t in latencies_s)

    @staticmethod
    def _percentiles(lat_s) -> dict:
        if not lat_s:
            return {"p50_ms": 0.0, "p90_ms": 0.0, "p99_ms": 0.0,
                    "mean_ms": 0.0}
        a = np.asarray(lat_s) * 1e3
        return {
            "p50_ms": float(np.percentile(a, 50)),
            "p90_ms": float(np.percentile(a, 90)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean()),
        }

    @staticmethod
    def _rates(requests: int, pixels: int, span_s: float) -> tuple:
        if span_s <= 0.0:
            return 0.0, 0.0
        return requests / span_s, pixels / span_s / 1e6

    def summary(self, cache_stats: dict | None = None) -> dict:
        """Full metrics tree (buckets + totals + cache)."""
        buckets = {}
        tot = _BucketStats()
        all_lat: list = []
        for label, b in sorted(self._buckets.items()):
            fps, mpx = self._rates(b.requests, b.pixels, b.span_s)
            buckets[label] = {
                "requests": b.requests,
                "batches": b.batches,
                "errors": b.errors,
                "degraded": b.degraded,
                "batch_occupancy": b.occupancy,
                "work_occupancy": b.work_occupancy,
                "rounds": b.rounds,
                "latency": self._percentiles(b.latencies_s),
                "fps": fps,
                "mpx_per_s": mpx,
            }
            tot.requests += b.requests
            tot.batches += b.batches
            tot.slots += b.slots
            tot.pixels += b.pixels
            tot.errors += b.errors
            tot.degraded += b.degraded
            tot.rounds += b.rounds
            tot.slot_rounds += b.slot_rounds
            tot.busy_slot_rounds += b.busy_slot_rounds
            tot.busy_chunks += b.busy_chunks
            tot.cap_chunks += b.cap_chunks
            if b.t_first is not None:
                tot.t_first = (b.t_first if tot.t_first is None
                               else min(tot.t_first, b.t_first))
                tot.t_last = max(tot.t_last, b.t_last)
            all_lat.extend(b.latencies_s)
        fps, mpx = self._rates(tot.requests, tot.pixels, tot.span_s)
        out = {
            "buckets": buckets,
            "totals": {
                "requests": tot.requests,
                "batches": tot.batches,
                "errors": tot.errors,
                "degraded": tot.degraded,
                "batch_occupancy": tot.occupancy,
                "work_occupancy": tot.work_occupancy,
                "rounds": tot.rounds,
                "latency": self._percentiles(all_lat),
                "fps": fps,
                "mpx_per_s": mpx,
            },
            "counters": self.counter_summary(),
        }
        if cache_stats is not None:
            out["cache"] = cache_stats
        return out

    def counter_summary(self) -> dict:
        """Every canonical counter (zeros included, so the schema is
        stable) plus any ad-hoc ones that were bumped."""
        out = {name: int(self.counters.get(name, 0)) for name in COUNTERS}
        for name in sorted(self.counters):
            out.setdefault(name, int(self.counters[name]))
        return out

    def counter_rows(self) -> list[dict]:
        """Lifecycle counters in the benchmarks row contract.  These
        rows carry *counts*, not times — ``us_per_call`` holds the raw
        count so the ``--json`` name → value schema can track them
        across PRs (documented in ``docs/BENCHMARKS.md``)."""
        return [
            {
                "name": f"serve/counters/{name}",
                "us_per_call": float(value),
                "derived": f"count={value}",
            }
            for name, value in self.counter_summary().items()
        ]

    def bench_rows(self, cache_stats: dict | None = None) -> list[dict]:
        """Rows in the ``benchmarks.common.emit`` contract."""
        rows = []
        for label, b in sorted(self._buckets.items()):
            if not b.requests:
                continue
            pct = self._percentiles(b.latencies_s)
            fps, mpx = self._rates(b.requests, b.pixels, b.span_s)
            derived = (
                f"p50={pct['p50_ms']:.1f}ms p99={pct['p99_ms']:.1f}ms "
                f"occ={b.occupancy:.2f} fps={fps:.1f} mpx/s={mpx:.1f}"
            )
            if b.errors:
                derived += f" errors={b.errors}"
            if b.degraded:
                derived += f" degraded={b.degraded}"
            if cache_stats is not None:
                derived += f" cache_hit={cache_stats['hit_rate']:.2f}"
            rows.append({
                "name": f"serve/{label}",
                "us_per_call": pct["mean_ms"] * 1e3,
                "derived": derived,
            })
        return rows

    def as_bench_json(self, cache_stats: dict | None = None) -> dict:
        """name → us_per_call, the ``benchmarks/run.py --json`` schema."""
        return {r["name"]: r["us_per_call"]
                for r in self.bench_rows(cache_stats)}
