"""repro_torch.serve's event-driven engine against repro.serve's, under
twin virtual clocks and on asyncio: timer-driven flushes with no
caller, deadline expiry as timers (with the expiry-during-compile
race), shedding, backpressure, close, the adaptive pad quantum, the
chaos matrix and seeded fault schedules, the convergence budget, and
one scenario replayed twice.

The streams go through the reference's ``Service`` and the port's
``Service(backend="cuda", device="cpu")`` (``Pair`` of
``test_torch_serve.py``); each ticket must end with the same outcome
and an equal value (``array_equal``), and the counters must be equal.
The reconstruction buckets here are held against the reference's
``"pallas"`` engine in interpret mode, so their chunk counters
(``work_occupancy``) and degraded flags are compared too.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro import serve as RS
from repro_torch import serve as TS
from repro_torch.serve import faults as TF
from repro_torch.serve.metrics import ServeMetrics
from test_torch_serve import Pair, as_numpy, image

pytestmark = pytest.mark.serve


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    share the machine; a wide torch pool per worker oversubscribes it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.default_rng(1702)


def recon_pair(rng, shape=(32, 32), slow=False):
    """(marker, mask) for ``reconstruct``; ``slow=True`` builds a
    serpentine mask whose front walks most of the image (a straggler)."""
    h, w = shape
    if slow:
        f = np.full(shape, 0.1, np.float32)
        for r in range(0, h, 2):
            f[r, :] = 0.9
            if r + 1 < h:
                f[r + 1, -1 if (r // 2) % 2 == 0 else 0] = 0.9
        m = np.full(shape, 0.05, np.float32)
        m[0, 0] = 0.8
    else:
        f = rng.random(shape).astype(np.float32)
        m = (0.9 * f).astype(np.float32)
    return np.minimum(m, f), f


# ---------------------------------------------------------------------------
# the event loop and the metrics (copies of the reference's)
# ---------------------------------------------------------------------------


def _loop_script(mod):
    clk = mod.VirtualClock()
    loop = mod.EventLoop(clk)
    fired = []
    loop.call_at(2.0, lambda: fired.append("late"))
    loop.call_at(1.0, lambda: fired.append("a"))
    loop.call_at(1.0, lambda: fired.append("b"))  # same instant: arm order
    loop.call_at(1.5, lambda: fired.append("cancelled")).cancel()
    handles = {"c": loop.call_at(3.0, lambda: fired.append("c"))}
    loop.call_at(2.5, lambda: handles["c"].cancel())
    trace = [loop.run_due()]
    for dt in (1.2, 1.0, 0.4, 1.0):
        clk.advance(dt)
        trace += [loop.run_due(), loop.next_deadline(), loop.pending()]
    return fired, trace


def test_event_loop_fires_like_the_reference():
    fired, trace = _loop_script(TS)
    assert (fired, trace) == _loop_script(RS)
    assert fired == ["a", "b", "late"]
    clk = TS.VirtualClock(5.0)
    assert clk.advance(1.5) == 6.5
    with pytest.raises(ValueError):
        clk.advance(-0.1)


def test_occupancy_accounting_equals_the_reference():
    """Batch occupancy is requests over slots; work occupancy weighs by
    scheduler chunks; the summaries equal the reference's."""
    from repro.serve.metrics import ServeMetrics as RefMetrics

    summaries = []
    for cls in (ServeMetrics, RefMetrics):
        m = cls()
        m.record_batch("b", n_real=4, n_slots=4, pixels=16,
                       t_dispatch=0.0, t_done=1.0, latencies_s=[0.1] * 4,
                       busy_chunks=46, cap_chunks=160)
        m.record_batch("c", n_real=3, n_slots=4, pixels=16,
                       t_dispatch=0.5, t_done=2.0, latencies_s=[0.2] * 3)
        m.count("retried", 2)
        summaries.append((m.summary(), m.bench_rows(), m.counter_rows()))
    assert summaries[0] == summaries[1]
    s = summaries[0][0]["buckets"]
    assert s["b"]["work_occupancy"] == pytest.approx(46 / 160)
    assert s["c"]["batch_occupancy"] == 0.75


# ---------------------------------------------------------------------------
# timers: flushes and expiries fire from the loop, not from a caller
# ---------------------------------------------------------------------------


def test_flush_timer_launches_without_flush_call(rng):
    pair = Pair(max_batch=4, max_delay_ms=5.0, pad_quantum=16)
    pair.submit("hfill", image(rng))
    pair.advance(0.003)
    pair.pump()
    assert pair.pending() == (1, 1)  # 3 ms < 5 ms: not due yet
    pair.advance(0.003)
    pair.pump()                      # flush timer fires, bucket launches
    assert pair.pending() == (0, 0)
    while pair.port.work_pending():
        pair.pump()
    pair.check()


def test_deadline_expiry_ordering(rng):
    """Two queued deadlines expire in deadline order, each when its
    timer fires."""
    pair = Pair(max_batch=8, max_delay_ms=1e9, pad_quantum=16)
    _, ta = pair.submit("hfill", image(rng), deadline_ms=10.0)
    _, tb = pair.submit("hfill", image(rng), deadline_ms=30.0)
    pair.advance(0.015)
    pair.pump()
    assert ta.outcome == "deadline" and not tb.done
    pair.advance(0.025)
    pair.pump()
    assert tb.outcome == "deadline" and ta.t_done < tb.t_done
    with pytest.raises(TS.DeadlineExceededError):
        ta.result()
    pair.check()
    assert pair.port.stats()["counters"]["expired"] == 2
    assert not pair.port.work_pending()


def test_expiry_during_compile_not_dispatched(rng, monkeypatch):
    """Launch re-checks deadlines after compiling: a request whose
    deadline lapsed during a long compile is shed, not dispatched."""
    pair = Pair(max_batch=1, max_delay_ms=1e9, pad_quantum=16)
    for svc, clock in zip((pair.ref, pair.port), pair.clocks):
        real = svc._entry_for

        def slow_entry_for(*a, _real=real, _clock=clock, **kw):
            _clock.advance(0.05)  # "compile" takes 50 ms
            return _real(*a, **kw)

        monkeypatch.setattr(svc, "_entry_for", slow_entry_for)
    _, t = pair.submit("hfill", image(rng), deadline_ms=10.0)
    assert t.done and t.outcome == "deadline"
    pair.check()
    assert pair.port.stats()["totals"]["requests"] == 0


@pytest.mark.parametrize("case", ["default-deadline", "deadline-site",
                                  "oldest-expires"])
def test_deadlines_shed_like_the_reference(rng, case):
    """A default deadline shed at launch; the ``deadline`` fault site's
    injected 1 ms deadline; the bucket's expired oldest re-arming the
    flush timer for the next."""
    if case == "default-deadline":
        pair = Pair(max_batch=4, max_delay_ms=1e9, pad_quantum=16,
                    default_deadline_ms=10.0)
        pair.submit("hfill", image(rng))
        pair.advance(0.05)
        pair.submit("hfill", image(rng), deadline_ms=1e6)
        pair.flush()
        outcomes = ["deadline", "ok"]
    elif case == "deadline-site":
        pair = Pair(max_batch=4, max_delay_ms=1e9, pad_quantum=16,
                    spec="deadline:n=1,value=1")
        pair.submit("hfill", image(rng))
        pair.submit("hfill", image(rng))
        pair.advance(0.01)
        pair.flush()
        outcomes = ["deadline", "ok"]
        assert pair.port.faults.fired["deadline"] == 1
    else:
        pair = Pair(max_batch=8, max_delay_ms=50.0, pad_quantum=16)
        pair.submit("hfill", image(rng), deadline_ms=10.0)
        pair.advance(0.005)
        pair.submit("hfill", image(rng))
        pair.advance(0.010)
        pair.pump()
        pair.advance(0.045)
        pair.pump()
        while pair.port.work_pending():
            pair.pump()
        outcomes = ["deadline", "ok"]
    pair.check()
    assert [t.outcome for _, t in pair.tickets] == outcomes


# ---------------------------------------------------------------------------
# asyncio: flushes fire with no caller
# ---------------------------------------------------------------------------


def test_asyncio_flush_fires_with_no_caller(rng):
    """Under AsyncService a lone sub-batch request completes from the
    loop's own timer wakeups — no poll, flush or result driving it."""
    im = image(rng)

    async def main():
        svc = TS.AsyncService(max_batch=8, max_delay_ms=5.0, pad_quantum=16,
                              device="cpu")
        t = svc.submit("hfill", im)
        deadline = asyncio.get_running_loop().time() + 30.0
        while not t.done:  # only sleeping — never pumping the service
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.01)
        await svc.close()
        return t

    t = asyncio.run(main())
    assert t.outcome == "ok"
    ref = RS.Service(backend="xla", max_batch=8, max_delay_ms=0.0,
                     pad_quantum=16).submit("hfill", im).result()
    np.testing.assert_array_equal(as_numpy(t.value), as_numpy(ref))


def test_async_result_and_close(rng):
    im = image(rng)

    async def main():
        svc = TS.AsyncService(max_batch=8, max_delay_ms=2.0, pad_quantum=16,
                              device="cpu")
        val = await svc.run("hfill", im)
        await svc.close()
        with pytest.raises(TS.ServiceClosedError):
            svc.submit("hfill", im)
        return val

    val = asyncio.run(main())
    ref = RS.Service(backend="xla", max_batch=8, max_delay_ms=0.0,
                     pad_quantum=16).submit("hfill", im).result()
    np.testing.assert_array_equal(as_numpy(val), as_numpy(ref))


# ---------------------------------------------------------------------------
# shedding, backpressure, close, adaptive quantum
# ---------------------------------------------------------------------------


def test_queue_full_sheds_under_virtual_clock(rng):
    pair = Pair(max_batch=8, max_queue=2, max_delay_ms=5.0, pad_quantum=16)
    pair.submit("hfill", image(rng))
    pair.submit("hfill", image(rng))
    with pytest.raises(TS.QueueFullError):
        pair.submit("hfill", image(rng))
    pair.advance(0.01)
    pair.pump()
    while pair.port.work_pending():
        pair.pump()
    pair.check()
    assert pair.port.stats()["counters"]["shed"] == 1


def test_backpressure_watermark_launches_early(rng):
    pair = Pair(max_batch=8, high_water=3, max_delay_ms=1e9, pad_quantum=16)
    for _ in range(3):
        pair.submit("hfill", image(rng))
    assert pair.pending() == (0, 0)
    while pair.port.work_pending() or pair.ref.work_pending():
        pair.pump()
    pair.check()
    assert pair.port.stats()["counters"]["backpressure_flushes"] >= 1


def test_closed_service_rejects(rng):
    pair = Pair(max_batch=2, pad_quantum=16)
    _, t = pair.submit("hfill", image(rng))
    pair.close()
    assert pair.port.closed and t.done
    with pytest.raises(TS.ServiceClosedError):
        pair.submit("hfill", image(rng))
    pair.close()  # idempotent
    pair.check()


@pytest.mark.parametrize("quantum,shapes,counter,after", [
    (64, [(33, 33)] * 4, "quantum_splits", 32),
    (8, [(16, 16), (24, 24), (32, 32), (16, 16)], "quantum_merges", 16),
], ids=["split", "merge"])
def test_adaptive_quantum(rng, quantum, shapes, counter, after):
    pair = Pair(max_batch=8, max_delay_ms=1e9, pad_quantum=quantum,
                adaptive_quantum=True, adapt_every=4)
    for shape in shapes:
        pair.submit("hfill", image(rng, shape))
    assert pair.port.stats()["counters"][counter] >= 1
    assert set(pair.port._quantum.values()) == {after}
    pair.flush()
    pair.check()


# ---------------------------------------------------------------------------
# faults: the chaos matrix and seeded schedules give the same outcomes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", ["dispatch", "drain", "poison"])
def test_chaos_matrix_healthy_requests_bit_exact(rng, site):
    """One injected failure per stream: dispatch/drain faults clear on
    retry, the poisoned request alone gets a PoisonedRequestError, and
    every healthy request is bit-exact — as on the reference."""
    pair = Pair(spec=f"{site}:n=1", max_batch=4, max_delay_ms=1e9,
                pad_quantum=16, max_retries=1, sleep=lambda s: None)
    for _ in range(4):
        pair.submit("hmax", image(rng), params={"h": 10})
    pair.flush()
    pair.check()
    outcomes = [t.outcome for _, t in pair.tickets]
    counters = pair.port.stats()["counters"]
    if site == "poison":
        assert outcomes.count("poisoned") == 1 and outcomes.count("ok") == 3
        assert counters["quarantine_reruns"] >= 1
    else:
        assert outcomes == ["ok"] * 4 and counters["retried"] >= 1
    assert counters["batch_failures"] >= 1
    assert pair.port.faults.fired[site] == 1


@pytest.mark.parametrize("seed", [1702, 7, 42])
def test_seeded_fault_schedule_same_outcomes(rng, seed):
    """An aggressive seeded schedule over dispatch/drain/poison: every
    ticket ends typed, with the reference's outcome, counters and
    fault snapshot."""
    spec = f"seed={seed};dispatch:p=0.3;drain:p=0.3;poison:p=0.2"
    pair = Pair(spec=spec, max_batch=2, max_delay_ms=0.0, pad_quantum=16,
                max_retries=1, sleep=lambda s: None)
    for i in range(10):
        pair.submit("hfill", image(rng, (16 + 16 * (i % 2), 16)))
        pair.poll()
    pair.flush()
    pair.check()
    for _, t in pair.tickets:
        assert t.done and (t.error is None
                           or isinstance(t.error, TS.ServeError))
    assert set(pair.port.stats()["faults"]["fired"]) <= set(TF.SITES)


def test_stats_surface_faults_and_counters(rng):
    pair = Pair(spec="seed=9;poison:n=1", max_batch=4, max_delay_ms=1e9,
                pad_quantum=16, max_retries=1, sleep=lambda s: None)
    pair.submit("hfill", image(rng))
    pair.flush()
    pair.check()
    s = pair.port.stats()
    assert (s["faults"]["seed"], s["faults"]["armed"]) == (9, ["poison"])
    rows = {r["name"]: r["us_per_call"] for r in pair.port.bench_rows()}
    assert rows["serve/counters/poisoned"] == 1.0
    assert rows["serve/counters/shed"] == 0.0


# ---------------------------------------------------------------------------
# reconstruction buckets on the reference's pallas engine
# ---------------------------------------------------------------------------


def test_pallas_straggler_bucket_work_occupancy(rng):
    """A serpentine straggler and three fast reconstructions in one
    batch: full batch occupancy, but the straggler's chunks hold all
    four slots, so work occupancy is low — with the reference's chunk
    counts, bit for bit."""
    pair = Pair("pallas", max_batch=4, max_delay_ms=1e9, pad_quantum=16)
    cases = [recon_pair(rng, slow=True)] + [recon_pair(rng)
                                            for _ in range(3)]
    for m, f in cases:
        pair.submit("reconstruct", m, f)
    pair.flush()
    pair.check()
    tot = pair.port.stats()["totals"]
    assert tot["batch_occupancy"] == 1.0
    assert 0.0 < tot["work_occupancy"] < 0.5


def test_pallas_budget_degrades_alike():
    """The ``budget`` site compiles with a 1-chunk budget: a spike that
    must flood the whole mask comes back degraded (a value, not an
    error) on both sides, partial values equal; a converging request
    under a clean service is not degraded."""
    marker = np.zeros((32, 32), np.uint8)
    marker[0, 0] = 255
    mask = np.full((32, 32), 255, np.uint8)
    pair = Pair("pallas", spec="budget:value=1", max_batch=1,
                max_delay_ms=1e9, pad_quantum=16)
    pair.submit("reconstruct", marker, mask)
    pair.flush()
    pair.check()
    (_, t), = pair.tickets
    assert t.outcome == "degraded" and t.result() is not None
    assert pair.port.stats()["counters"]["degraded"] == 1


# ---------------------------------------------------------------------------
# one scenario, replayed: the same summary twice, equal to the reference's
# ---------------------------------------------------------------------------


def _scenario(pair: Pair) -> dict:
    """Mixed arrivals on a stepped virtual clock: fills, deadline
    flushes, a tight deadline and a fault schedule."""
    rng = np.random.default_rng(11)
    ops = (("hfill", {}), ("hmax", {"h": 20}), ("erode", {"s": 3}))
    for i in range(12):
        op, params = ops[i % 3]
        pair.submit(op, image(rng, (16 + 8 * (i % 2), 24)), params=params,
                    deadline_ms=2.0 if i == 5 else None)
        for _ in range(2):
            pair.advance(1e-3)
            pair.pump()
    for _ in range(1000):
        if not (pair.port.work_pending() or pair.ref.work_pending()):
            break
        pair.advance(1e-3)
        pair.pump()
    pair.check()
    s = pair.port.stats()
    return {"counters": s["counters"],
            "buckets": {k: (b["requests"], b["batches"])
                        for k, b in s["buckets"].items()},
            "outcomes": [t.outcome for _, t in pair.tickets]}


def test_scenario_replays_identically():
    kw = dict(spec="seed=5;poison:p=0.1;drain:p=0.1", max_batch=4,
              max_delay_ms=4.0, pad_quantum=32, max_retries=1,
              sleep=lambda s: None)
    a, b = _scenario(Pair(**kw)), _scenario(Pair(**kw))
    assert a == b
    assert "pending" not in a["outcomes"] and "deadline" in a["outcomes"]
