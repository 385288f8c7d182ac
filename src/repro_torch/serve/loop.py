"""Deterministic timer loop + injectable clocks for the serving engine
(a copy of ``repro.serve.loop``).

The event-driven :class:`~repro_torch.serve.service.Service` never reads
``time.monotonic()`` directly: every timestamp comes from an injectable
*clock* (any zero-arg callable returning monotonic seconds) and every
deferred action — bucket deadline flushes, per-request expiry — is a
*timer* on an :class:`EventLoop`.  That seam is what makes the engine
testable: under a :class:`VirtualClock` plus manual ``run_due()``
pumping (as the serving tests' stepped loops do) every
flush, expiry, refill and backpressure decision replays identically,
while the asyncio front-end (``service.AsyncService``) arms the same
timers on a real ``asyncio`` loop so they fire without any caller.

The loop is intentionally *not* a thread or an asyncio loop itself —
it is a heap of ``(when, seq)``-ordered callbacks fired by whoever
pumps it (``Service.submit``/``poll``/``pump`` in cooperative use, an
asyncio ``call_at`` trampoline in async use).  Determinism contract:
timers due at the same instant fire in arming order (``seq``), and
``run_due`` uses one clock reading per pump so a callback arming a
same-instant timer cannot starve the pump.
"""
from __future__ import annotations

import heapq
import time
from typing import Any, Callable


class VirtualClock:
    """A manually advanced monotonic clock (seconds).

    The test half of the virtual-clock harness: inject one of these as
    ``Service(clock=...)`` and drive time explicitly with
    :meth:`advance`.  Calling the instance reads the current time, so
    it is a drop-in for ``time.monotonic``.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds (monotonic: dt >= 0)."""
        if dt < 0:
            raise ValueError("a monotonic clock cannot go backwards")
        self._now += float(dt)
        return self._now


class TimerHandle:
    """A cancellable timer armed on an :class:`EventLoop`."""

    __slots__ = ("when", "seq", "callback", "cancelled")

    def __init__(self, when: float, seq: int, callback: Callable[[], Any]):
        self.when = when
        self.seq = seq
        self.callback = callback
        self.cancelled = False

    def cancel(self) -> None:
        """Mark the timer dead; the loop drops it lazily."""
        self.cancelled = True
        self.callback = None

    def __repr__(self):
        state = "cancelled" if self.cancelled else f"t={self.when:.6f}"
        return f"TimerHandle({state}, seq={self.seq})"


class EventLoop:
    """Single-threaded deterministic timer heap.

    ``call_at``/``call_later`` arm callbacks; ``run_due()`` fires every
    timer whose deadline has passed on the injected clock, in strict
    ``(when, seq)`` order.  Nothing fires spontaneously — the loop is
    pumped by its owner — which is exactly what the deterministic test
    harness needs, and the asyncio adapter turns ``next_deadline()``
    into real wakeups.
    """

    def __init__(self, clock: Callable[[], float] | None = None):
        self.clock = clock if clock is not None else time.monotonic
        self._heap: list[tuple[float, int, TimerHandle]] = []
        self._seq = 0

    def now(self) -> float:
        return self.clock()

    def call_at(self, when: float, callback: Callable[[], Any]) -> TimerHandle:
        """Arm ``callback`` to fire once ``clock() >= when``."""
        handle = TimerHandle(float(when), self._seq, callback)
        self._seq += 1
        heapq.heappush(self._heap, (handle.when, handle.seq, handle))
        return handle

    def call_later(self, delay: float,
                   callback: Callable[[], Any]) -> TimerHandle:
        return self.call_at(self.clock() + delay, callback)

    def run_due(self) -> int:
        """Fire every timer due *now*; returns how many fired.

        The clock is read once, so callbacks arming new timers at or
        before the same instant fire on the *next* pump — a same-time
        re-arm cannot loop this call forever.
        """
        now = self.clock()
        fired = 0
        due: list[TimerHandle] = []
        while self._heap and self._heap[0][0] <= now:
            _, _, handle = heapq.heappop(self._heap)
            if not handle.cancelled:
                due.append(handle)
        for handle in due:  # (when, seq) order by heap extraction
            callback, handle.callback = handle.callback, None
            if callback is not None:
                callback()
                fired += 1
        return fired

    def next_deadline(self) -> float | None:
        """Earliest armed (uncancelled) timer, or None when idle."""
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def pending(self) -> int:
        """Number of live timers (introspection/tests)."""
        return sum(1 for _, _, h in self._heap if not h.cancelled)
