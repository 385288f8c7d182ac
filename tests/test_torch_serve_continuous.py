"""Continuous batching in the port (``repro_torch.serve.continuous``,
``Executable.slot_session``, the scheduler's resumable rounds) against
the JAX package on the CPU.

* the scheduler: ``_scheduled_reconstruct``, ``_scheduled_qdt`` (with
  mid-flight ``rp``/``dp``) and ``_scheduled_gdt`` run in rounds of 1
  and 2 chunks with ``resume``, and under a per-image ``budget``, on a
  tiled, compacting plan; after every round the planes, ``finished``,
  ``exhausted``, the chunk counters and the activity grid equal the
  reference's (its ``"pallas"`` engine in interpret mode, one jitted
  round function a case: each compiles for seconds, so the slot
  sessions and the budget-degraded service below cover the other
  combinations);
* ``Executable.refillable`` on every ``SERVE_OPS`` program, on raster
  against wavefront gdt, on 2-D compiles and on the ``"torch"`` engine;
* slot sessions: one admit/round/harvest sequence through the
  reference's and the port's sessions for a reconstruction, a QDT and a
  gdt bucket — every round's stack, ``finished``, ``exhausted`` and
  ``chunks_of`` equal;
* the continuous service: the reference's refill, chaos-matrix, poison
  mid-refill, budget, deadline and ambient-fault cases, the pinned
  incremental gdt and ``AsyncService(continuous=True)`` — each stream
  through ``repro.serve.Service(continuous=True, backend="pallas")``
  and ``repro_torch.serve.Service(continuous=True, device="cpu")`` on
  twin virtual clocks (``Pair`` of ``test_torch_serve.py``): outcomes,
  values, counters and ``bench_rows()`` equal; ``tests/serve_sim.py``'s
  selftest scenario gives the reference's summary; ``warmup`` builds the
  sessions and a custom op's ``plan_builder`` reaches its ``run``.

Every comparison is ``array_equal`` or ``==``, never a tolerance.  The
port's ``"cuda"`` engine runs its kernels' plain versions on CPU
tensors; the card's cases are in ``test_torch_cuda.py``.
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as RA
import repro_torch.api as TA
from repro import serve as RS
from repro.core.chain import ChainPlan
from repro.core.chain import plan_chain as ref_plan_chain
from repro.kernels import ops as RO
from repro.serve import faults as RF
from repro.serve import registry as RR
from repro_torch import serve as TS
from repro_torch.core.chain import plan_chain, plan_from_key
from repro_torch.kernels import ops as TO
from repro_torch.serve import faults as TF
from repro_torch.serve import registry as TR
from serve_sim import SimHarness, selftest_scenario
from test_torch_serve import OP_NAMES, Pair, as_numpy

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


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(ref, port):
    return np.array_equal(np.asarray(ref), np.asarray(as_numpy(port)),
                          equal_nan=True)


def recon_pair(rng, shape=(32, 32), slow=False):
    """(marker, mask) for ``reconstruct`` (those of
    ``tests/test_serve_async.py``); ``slow=True`` builds a serpentine
    mask whose front walks most of the image — a straggler."""
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
# the scheduler: resumable rounds and the per-image budget
# ---------------------------------------------------------------------------

#: Two 32 x 64 images, 16-row bands of two 32-column tiles, K = 4 (the
#: interpreted Pallas kernels compile in seconds), a compacting
#: workspace: the tile and compact steps both run.
PLAN = ChainPlan(16, 4, 64, 32, 2, 1, n_images=2, compact_threshold=0.5,
                 tile_w=32)


def _round_inputs(kind):
    """The stacked (64, 64) planes a solo run of ``kind`` stages: a slow
    and a fast image of 32 x 60 (ragged inside the plan's pads)."""
    rng = np.random.default_rng(23)
    n, h, w = 2, 32, 60
    if kind == "reconstruct":
        # a corner marker flooding a flat mask, and a fast pair
        fast, f2 = recon_pair(rng, (h, w))
        slow = np.zeros((h, w), np.float32)
        slow[0, 0] = 0.8
        marker = np.stack([slow, fast])
        mask = np.stack([np.full((h, w), 0.9, np.float32), f2])
        ident = RO.ident_for("dilate", np.float32)
        return tuple(RO._stacked(RO._pad(jnp.asarray(x), PLAN, ident))
                     for x in (marker, mask))
    if kind == "qdt":
        f = np.where(rng.random((n, h, w)) > 0.3, 255, 0).astype(np.uint8)
        f[0] = 255
        f[0, 0, 0] = 0  # distances across the whole image: many chunks
        fp = RO._stacked(RO._pad(jnp.asarray(f), PLAN,
                                 RO.ident_for("erode", np.uint8)))
        return (fp, jnp.zeros(fp.shape, jnp.int32),
                jnp.zeros(fp.shape, jnp.int32))
    img = (rng.random((n, h, w)) * 3).astype(np.float32)
    seeds = np.zeros(img.shape, np.float32)
    seeds[0, 0, 0] = 1.0                      # one far corner seed
    seeds[1][rng.random((h, w)) < 0.05] = 1.0
    lo = -np.inf
    ip, sp = (RO._stacked(RO._pad(jnp.asarray(x), PLAN, lo))
              for x in (img, seeds))
    return RO.gdt_stage(ip, sp, 1.0e3)


def _ref_round(kind, n_chunks, budget):
    """The reference's round function for ``kind``, jitted:
    ``(planes, state) -> (planes, chunks, finished, state)``."""
    def run(planes, state):
        if kind == "reconstruct":
            fp, mp = planes
            fp, it, _, _, fin, state = RO._scheduled_reconstruct(
                fp, mp, PLAN, "dilate", n_chunks, False, resume=state,
                budget=budget)
            return (fp, mp), it, fin, state
        if kind == "qdt":
            x, r, d = planes
            x, r, d, fin, state = RO._scheduled_qdt(
                x, PLAN, n_chunks, rp=r, dp=d, resume=state, budget=budget)
            return (x, r, d), None, fin, state
        d, ip, sp = planes
        d, fin, state = RO._scheduled_gdt(d, ip, sp, PLAN, 0.7, n_chunks,
                                          resume=state, budget=budget)
        return (d, ip, sp), None, fin, state

    return jax.jit(run)


def _port_round(kind, n_chunks, budget, planes, state):
    plan = plan_from_key(PLAN.key)
    if kind == "reconstruct":
        fp, mp = planes
        fp, it, _, _, fin, state = TO._scheduled_reconstruct(
            fp, mp, plan, "dilate", n_chunks, False, resume=state,
            budget=budget)
        return (fp, mp), it, fin, state
    if kind == "qdt":
        x, r, d = planes
        x, r, d, fin, state = TO._scheduled_qdt(
            x, plan, n_chunks, rp=r, dp=d, resume=state, budget=budget)
        return (x, r, d), None, fin, state
    d, ip, sp = planes
    d, fin, state = TO._scheduled_gdt(d, ip, sp, plan, 0.7, n_chunks,
                                      resume=state, budget=budget)
    return (d, ip, sp), None, fin, state


@pytest.mark.parametrize("kind,n_chunks,budget", [
    ("reconstruct", 1, None), ("qdt", 1, None), ("qdt", 2, 5), ("gdt", 1, 5),
])
def test_scheduler_rounds_equal_the_reference(kind, n_chunks, budget):
    """Round after round from one resumed state: the planes, the chunks
    run, ``finished``, ``exhausted``, the per-image chunk counters and
    the activity grid (device and host copy) equal the reference's."""
    ref_planes = _round_inputs(kind)
    port_planes = tuple(_t(x) for x in ref_planes)
    ref_state = RO.scheduler_state0(PLAN)
    port_state = TO.scheduler_state0(plan_from_key(PLAN.key), "cpu")
    ref_fn = _ref_round(kind, n_chunks, budget)
    for rounds in range(1, 200):
        ref_planes, ref_it, ref_fin, ref_state = ref_fn(ref_planes,
                                                        ref_state)
        port_planes, port_it, port_fin, port_state = _port_round(
            kind, n_chunks, budget, port_planes, port_state)
        for a, b in zip(ref_planes, port_planes):
            assert _eq(a, b), (kind, rounds)
        if ref_it is not None:
            assert int(ref_it) == port_it
        assert np.asarray(ref_fin).tolist() == port_fin.tolist()
        active, chunks, exhausted = ref_state
        assert _eq(active, port_state.active)
        assert np.array_equal(np.asarray(active).ravel(),
                              port_state.active_host)
        assert np.asarray(chunks).tolist() == port_state.img_chunks.tolist()
        assert (np.asarray(exhausted).tolist()
                == port_state.exhausted.tolist())
        if port_fin.all():
            break
    assert rounds >= 2  # the images took several rounds
    if budget is not None:
        # the slow image was cut at the budget, the fast one was not
        assert port_state.exhausted.tolist() == [True, False]
        assert port_state.img_chunks[0] == budget
    else:
        assert not port_state.exhausted.any()


def test_resumed_rounds_equal_one_solo_run():
    """Rounds of 1 chunk, resumed, end where one uninterrupted run ends,
    and under a budget where a run under ``max_chunks=budget`` ends."""
    plan = plan_from_key(PLAN.key)
    fp, mp = (_t(x) for x in _round_inputs("reconstruct"))
    for budget in (None, 3):
        solo = TO._scheduled_reconstruct(fp, mp, plan, "dilate",
                                         budget or 1000, False)
        state, x = None, fp
        while True:
            x, _, _, _, fin, state = TO._scheduled_reconstruct(
                x, mp, plan, "dilate", 1, False, resume=state, budget=budget)
            if fin.all():
                break
        assert torch.equal(x, solo[0])
        assert state.img_chunks.tolist() == solo[5].img_chunks.tolist()
        assert fin.tolist() == [True, True]
        assert solo[4].tolist() == ([True, True] if budget is None
                                    else [False, True])


# ---------------------------------------------------------------------------
# Executable.refillable
# ---------------------------------------------------------------------------


def _serve_programs(op):
    """The registry's expression for ``op`` on both sides (params from
    each schema's sample)."""
    spec = TR.get(op)
    canon = spec.canonical_params({k: v.sample()
                                   for k, v in spec.params.items()})
    dtype = np.float32 if "f" == spec.dtypes else np.uint8
    return (RR.request_info(op, canon).expr, TR.request_info(op, canon).expr,
            dtype)


@pytest.mark.parametrize("op", OP_NAMES)
def test_refillable_equals_the_reference(op):
    """For every served op's program, at a bucket's 3-D shape: the port
    refills exactly the buckets the reference does."""
    ref_expr, port_expr, dtype = _serve_programs(op)
    ref = RA.compile(ref_expr, (4, 32, 32), dtype, "pallas")
    port = TA.compile(port_expr, (4, 32, 32), dtype, device="cpu")
    assert port.refillable == ref.refillable
    assert port.refillable == (op in ("reconstruct", "hmax", "dome",
                                      "hfill", "raobj", "qdt", "qdt_l1",
                                      "gdt"))
    # neither engine refills a 2-D compile, and the oracle engine never
    ref2 = RA.compile(ref_expr, (32, 32), dtype, "pallas")
    port2 = TA.compile(port_expr, (32, 32), dtype, device="cpu")
    assert port2.refillable is ref2.refillable is False
    assert not TA.compile(port_expr, (4, 32, 32), dtype, "torch",
                          device="cpu").refillable


def test_refillable_keys_on_schedule():
    """Only the wavefront schedule keeps a per-slot activity grid
    (``tests/test_gdt.py:test_refillable_keys_on_schedule``)."""
    def expr(api):
        return api.E.gdt(api.E.input("image"), api.E.input("seeds"))

    ref_plan = ref_plan_chain(32, 32, np.float32, None, n_images_resident=3,
                              n_images=2, convergent=True,
                              schedule="raster")
    plan = plan_chain(32, 32, np.float32, None, n_images_resident=3,
                      n_images=2, convergent=True, schedule="raster")
    assert plan.key == ref_plan.key
    for api, kw, p in ((RA, {"backend": "pallas"}, ref_plan),
                       (TA, {"device": "cpu"}, plan)):
        wave = api.compile(expr(api), (2, 32, 32), np.float32, **kw)
        rast = api.compile(expr(api), (2, 32, 32), np.float32, plan=p, **kw)
        assert wave.refillable and not rast.refillable
    with pytest.raises(ValueError, match="not refillable"):
        TA.compile(expr(TA), (2, 32, 32), np.float32, plan=plan,
                   device="cpu").slot_session(2)


# ---------------------------------------------------------------------------
# slot sessions: one admit/round/harvest sequence through both
# ---------------------------------------------------------------------------


def _session_cases(kind):
    """(expr builder, compiled (n, h, w), dtype, n_chunks, requests): the
    requests are tuples of canonical (h, w) inputs, the first a slow
    one.  The buckets are those the service tests below compile (two
    slots: the interpreted reference compiles each program once)."""
    rng = np.random.default_rng(29)
    if kind == "reconstruct":
        reqs = [recon_pair(rng, slow=True)] + [recon_pair(rng)
                                               for _ in range(5)]
        return (lambda E: E.reconstruct(E.input("marker"), E.input("mask"),
                                        op="dilate"),
                (2, 32, 32), np.float32, 2, reqs)
    if kind == "qdt":
        reqs = [((rng.random((32, 32)) > 0.5).astype(np.float32),)
                for _ in range(5)]
        reqs[0][0][2:30, 2:30] = 1.0  # a large object: the straggler
        return (lambda E: E.qdt(E.input("f")), (2, 32, 32), np.float32, 2,
                reqs)
    img = (rng.random((24, 24)) * 3).astype(np.float32)
    reqs = []
    for k in range(4):
        seeds = np.zeros(img.shape, np.float32)
        seeds[4 + 3 * k, 5 + 2 * k] = 1.0
        reqs.append((img, seeds))
    return (lambda E: E.gdt(E.input("image"), E.input("seeds"), lamb=0.7,
                            nu=50.0),
            (2, 24, 24), np.float32, 4, reqs)


@pytest.mark.parametrize("kind", ("reconstruct", "qdt", "gdt"))
def test_slot_session_equals_the_reference(kind):
    """Admit two requests, run rounds, harvest each finished slot and
    admit the next request into it: every round's stack (parked slots
    included), ``finished``, ``exhausted`` and ``chunks_of`` equal the
    reference session's, and each harvested value equals a solo batch
    of that request on the port's batch path."""
    build, shape, dtype, n_chunks, reqs = _session_cases(kind)
    ref = RA.compile(build(RA.E), shape, dtype, "pallas").slot_session(
        n_chunks)
    exe = TA.compile(build(TA.E), shape, dtype, device="cpu")
    port = exe.slot_session(n_chunks)
    assert exe.slot_session(n_chunks) is port  # cached per n_chunks
    assert (port.n_slots, port.n_chunks) == (ref.n_slots, ref.n_chunks)
    rs, ps = ref.init(), port.init()
    queue = list(range(len(reqs)))
    slots = [None] * port.n_slots
    harvested = {}

    def admit(slot):
        nonlocal rs, ps
        i = queue.pop(0)
        rs = ref.admit(rs, slot, *(jnp.asarray(x) for x in reqs[i]))
        ps = port.admit(ps, slot, *(_t(x) for x in reqs[i]))
        slots[slot] = i

    for slot in range(port.n_slots):
        admit(slot)
    for _ in range(300):
        rs, rfin, rexh = ref.round(rs)
        ps, pfin, pexh = port.round(ps)
        assert np.asarray(rfin).tolist() == pfin.tolist()
        assert np.asarray(rexh).tolist() == pexh.tolist()
        assert (np.asarray(ref.chunks_of(rs)).tolist()
                == port.chunks_of(ps).tolist())
        r_out, p_out = ref.extract(rs), port.extract(ps)
        assert len(r_out) == len(p_out)
        for a, b in zip(r_out, p_out):
            assert _eq(a, b)
        for slot, i in enumerate(slots):
            if i is not None and pfin[slot]:
                harvested[i] = tuple(o[slot].clone() for o in p_out)
                slots[slot] = None
                if queue:
                    admit(slot)
        if not any(i is not None for i in slots):
            break
    assert sorted(harvested) == list(range(len(reqs)))
    batch = TA.compile(build(TA.E), (1, *shape[1:]), dtype, device="cpu")
    for i, x in enumerate(reqs):
        solo = batch.run_batch(*(_t(a)[None] for a in x))
        for a, b in zip(solo, harvested[i]):
            assert torch.equal(a[0], b), (kind, i)


# ---------------------------------------------------------------------------
# the continuous service, twin virtual clocks
# ---------------------------------------------------------------------------


def continuous_pair(spec=None, **kw):
    """The reference's ``"pallas"`` service and the port's, continuous
    (the defaults of ``tests/test_faults.py:_continuous_service``, with
    two slots a bucket)."""
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_delay_ms", 1e9)
    kw.setdefault("pad_quantum", 16)
    kw.setdefault("refill_quantum", 2)
    kw.setdefault("max_retries", 1)
    kw.setdefault("sleep", lambda s: None)
    return Pair("pallas", spec=spec, continuous=True, **kw)


def drive(pair, max_steps=2000):
    """Step both services on their virtual clocks until every ticket of
    the pair is done (``tests/test_faults.py:_drive``)."""
    for _ in range(max_steps):
        if all(r.done and p.done for r, p in pair.tickets):
            return
        pair.advance(1e-3)
        pair.poll()
        pair.ref.executor.drain_all()
        pair.port.executor.drain_all()
    raise AssertionError("continuous engine failed to complete tickets")


def test_continuous_refill_bit_exact(rng):
    """A serpentine straggler keeps the session alive while six more
    requests are admitted into freed slots: every ticket ``ok`` and equal
    to the reference's, and the refills counted alike
    (``tests/test_serve_async.py:test_continuous_refill_bit_exact``)."""
    pair = continuous_pair(max_delay_ms=1.0)
    cases = [recon_pair(rng, slow=True)] + [recon_pair(rng)
                                            for _ in range(3)]
    for m, f in cases:
        pair.submit("reconstruct", m, f)
    pair.advance(0.002)
    pair.poll()  # flush timer: engine spawned, first wave admitted
    (engine,) = pair.port._engines.values()
    assert engine.occupied and pair.port.work_pending()
    for _ in range(6):
        pair.submit("reconstruct", *recon_pair(rng))
        pair.poll()  # one engine round an arrival: fast slots free up
    drive(pair)
    pair.check()
    assert pair.port.stats()["counters"]["refills"] > 0
    assert all(p.outcome == "ok" for _, p in pair.tickets)
    assert engine.rounds > 0 and not engine.occupied
    assert pair.port.pending() == 0 and not pair.port.work_pending()


def test_continuous_matches_batch_path(rng):
    """``continuous=True`` and the batch path give the same values on
    the same traffic; each equals the reference's in its mode."""
    cases = [recon_pair(rng) for _ in range(5)]
    values = {}
    for cont in (False, True):
        pair = Pair("pallas", continuous=cont, max_batch=2,
                    max_delay_ms=1e9, pad_quantum=16, refill_quantum=2)
        for m, f in cases:
            pair.submit("reconstruct", m, f)
        pair.flush()
        pair.check()
        values[cont] = [p.result() for _, p in pair.tickets]
        assert bool(pair.port._engines) is cont
    for a, b in zip(values[False], values[True]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("site", ["dispatch", "drain", "poison"])
def test_chaos_matrix_continuous_engine(rng, site):
    """One injected failure at each site of the stepped continuous
    engine: healthy requests ``ok`` and equal, only a poisoned request
    gets a typed error, the counters as the reference's
    (``tests/test_faults.py:test_chaos_matrix_continuous_engine``)."""
    pair = continuous_pair(spec=f"{site}:n=1")
    for _ in range(2):
        pair.submit("reconstruct", *recon_pair(rng))
    pair.flush()
    drive(pair)
    pair.check()
    outcomes = [p.outcome for _, p in pair.tickets]
    counters = pair.port.stats()["counters"]
    if site == "poison":
        assert outcomes.count("poisoned") == 1 and outcomes.count("ok") == 1
        assert counters["poisoned"] == 1
    else:
        assert outcomes == ["ok"] * 2 and counters["retried"] >= 1
    assert counters["batch_failures"] >= 1
    assert pair.port.faults.fired[site] == 1


def test_poison_mid_refill_preserves_healthy_and_straggler(rng):
    """A poisoned request admitted into a freed slot while the straggler
    iterates kills the session; eviction and bisect quarantine isolate
    it and every other occupant completes, as on the reference."""
    pair = continuous_pair()
    cases = [recon_pair(rng, slow=True)] + [recon_pair(rng)
                                            for _ in range(3)]
    for m, f in cases:
        pair.submit("reconstruct", m, f)
    for svc in (pair.ref, pair.port):
        for key in list(svc._queue.keys()):
            svc._launch(key)  # engine spawned, first wave resident
    for _ in range(3):
        pair.poll()  # the fast slots free up while the straggler runs
    for svc, mod in ((pair.ref, RF), (pair.port, TF)):
        svc.faults.specs["poison"] = mod.FaultSpec("poison", n=1)
    pair.submit("reconstruct", *recon_pair(rng))
    for svc in (pair.ref, pair.port):
        for key in list(svc._queue.keys()):
            svc._launch(key)
    drive(pair)
    pair.check()
    outcomes = [p.outcome for _, p in pair.tickets]
    assert outcomes == ["ok"] * 4 + ["poisoned"]
    assert pair.port.stats()["counters"]["refills"] >= 1


def test_budget_degrades_continuous_engine():
    """A 1-chunk budget truncates the slot: a degraded partial fixpoint,
    never an error, equal to the reference's."""
    marker = np.zeros((32, 32), np.float32)
    marker[0, 0] = 1.0
    mask = np.ones((32, 32), np.float32)
    pair = continuous_pair(spec="budget:value=1")
    pair.submit("reconstruct", marker, mask)
    pair.flush()
    drive(pair)
    pair.check()
    (_, t), = pair.tickets
    assert t.error is None and t.degraded and t.outcome == "degraded"
    assert pair.port.stats()["counters"]["degraded"] == 1


def test_deadline_fault_expires_under_stepped_loop(rng):
    pair = continuous_pair(spec="deadline:n=1,value=1.0")
    pair.submit("reconstruct", *recon_pair(rng))
    pair.advance(0.01)
    pair.poll()  # the expiry timer fires from the stepped loop
    pair.check()
    assert [p.outcome for _, p in pair.tickets] == ["deadline"]
    assert pair.port.stats()["counters"]["expired"] == 1


def test_no_unstructured_escape_continuous(rng):
    """An aggressive seeded schedule over the stepped continuous engine:
    every ticket ends typed, with the reference's outcome, counters and
    fault snapshot."""
    pair = continuous_pair(
        spec="seed=1702;dispatch:p=0.3;drain:p=0.3;poison:p=0.2",
        max_delay_ms=2.0)
    for i in range(8):
        try:
            pair.submit("reconstruct", *recon_pair(rng, slow=(i == 0)))
        except TS.ServeError:
            pass
        pair.advance(1e-3)
        pair.poll()
    pair.flush()
    drive(pair)
    pair.check()
    for _, p in pair.tickets:
        assert p.done and (p.error is None
                           or isinstance(p.error, TS.ServeError))
    assert set(pair.port.stats()["faults"]["fired"]) <= set(TF.SITES)


def test_serve_pinned_incremental_updates_continuous():
    """The interactive pattern on the continuous engine: one pinned
    image, three seed updates against its name — equal to the
    reference's, every resolution counted
    (``tests/test_gdt.py:test_serve_pinned_incremental_updates``)."""
    build, _, _, _, reqs = _session_cases("gdt")
    img = reqs[0][0]
    pair = Pair("pallas", continuous=True, max_batch=2, pad_quantum=8)
    pair.pin("slice", img)
    for _, seeds in reqs[:3]:
        pair.submit("gdt", "slice", seeds, params={"lamb": 0.7, "nu": 50.0})
    pair.flush()
    pair.check()
    assert all(p.outcome == "ok" for _, p in pair.tickets)
    assert pair.port.stats()["counters"]["asset_hits"] == 3
    assert len(pair.port._engines) == 1


class PortSimHarness(SimHarness):
    """``tests/serve_sim.py``'s harness around the port's service: the
    same stepping methods and summary, on the port's virtual clock."""

    def __init__(self, **service_kwargs):
        self.clock = TS.VirtualClock()
        service_kwargs.setdefault("clock", self.clock)
        self.service = TS.Service(device="cpu", **service_kwargs)
        self.tickets = []
        self.rejections = []


def test_selftest_scenario_summary_equals_the_reference():
    """The CI flake detector's scenario (stragglers, QDTs, a tight
    deadline, flush timers) under ``continuous=True``: the port's
    summary equals the reference's, every bucket on a slot engine."""
    kw = dict(continuous=True, max_batch=2, max_delay_ms=4.0,
              pad_quantum=32, refill_quantum=2)
    ref = selftest_scenario(SimHarness(backend="pallas", **kw))
    port = selftest_scenario(PortSimHarness(**kw))
    assert port == ref
    assert {b["rounds"] > 0 for b in port["buckets"].values()} == {True}
    assert "pending" not in port["outcomes"]


def test_asyncio_continuous_pumps_while_occupied(rng):
    """``AsyncService(continuous=True)``: after the flush timer admits
    the requests, its trampoline keeps pumping while the slot engine is
    occupied — the tickets complete with no caller driving them, equal
    to the port's batch path."""
    cases = [recon_pair(rng, slow=True)] + [recon_pair(rng)
                                            for _ in range(4)]

    async def main():
        svc = TS.AsyncService(continuous=True, max_batch=4,
                              max_delay_ms=2.0, pad_quantum=16,
                              refill_quantum=2, device="cpu")
        tickets = [svc.submit("reconstruct", m, f) for m, f in cases]
        deadline = asyncio.get_running_loop().time() + 60.0
        while not all(t.done for t in tickets):  # sleeping, never pumping
            assert asyncio.get_running_loop().time() < deadline
            await asyncio.sleep(0.001)
        stats = svc.stats()
        await svc.close()
        return tickets, stats

    tickets, stats = asyncio.run(main())
    assert stats["counters"]["refills"] > 0
    batch = TS.Service(max_batch=4, max_delay_ms=1e9, pad_quantum=16,
                       device="cpu")
    want = [batch.submit("reconstruct", m, f) for m, f in cases]
    batch.flush()
    for t, w in zip(tickets, want):
        assert t.outcome == "ok" and torch.equal(t.result(), w.result())


# ---------------------------------------------------------------------------
# warm-up and custom ops
# ---------------------------------------------------------------------------


def test_warmup_builds_the_slot_sessions():
    """``warmup`` under ``continuous=True`` builds and runs a refillable
    bucket's session (and not a fixed chain's), with the reference's
    cache accounting; the first stream then compiles nothing."""
    pair = continuous_pair()
    entries = [{"op": "reconstruct", "shape": (32, 32),
                "dtype": np.float32, "batch": 1},
               {"op": "erode", "params": {"s": 2}, "shape": (16, 16),
                "dtype": np.uint8, "batch": 1}]
    pair.warmup(entries)
    for svc in (pair.ref, pair.port):
        sessions = {len(e.exe._sessions) for e in svc.cache.entries()
                    if e.exe is not None}
        assert sessions == {0, 1}  # the max_batch reconstruction only
    assert pair.port.cache.stats() == pair.ref.cache.stats()
    rng = np.random.default_rng(3)
    pair.submit("reconstruct", *recon_pair(rng))
    pair.flush()
    pair.check()
    assert pair.port.cache.stats()["misses"] == 0


def test_custom_op_plan_builder_reaches_run():
    """A custom op's ``plan_builder`` builds the bucket's plan on the
    ``"cuda"`` engine, its ``run`` gets it as the fourth argument, and
    the cache entry carries it — as on the reference's ``"pallas"``."""
    seen = {"ref": [], "port": []}

    def make(side, plan_fn):
        def builder(n, h, w, dtype, params):
            return plan_fn(h, w, dtype, None, n_images=n)

        def run(inputs, params, backend, plan):
            seen[side].append((backend, plan.key))
            return inputs[0]

        return builder, run

    for side, reg, plan_fn in (("ref", RR, ref_plan_chain),
                               ("port", TR, plan_chain)):
        builder, run = make(side, plan_fn)
        reg.register(reg.OpSpec(name="_planned_test", params={}, run=run,
                                plan_builder=builder))
    try:
        pair = Pair("pallas", max_batch=2, max_delay_ms=1e9, pad_quantum=16)
        x = np.arange(100, dtype=np.float32).reshape(10, 10)
        pair.submit("_planned_test", x)
        pair.submit("_planned_test", x + 1)
        pair.flush()
        pair.check()
        assert seen["port"] == [("cuda", seen["ref"][0][1])]
        assert seen["ref"][0][0] == "pallas"
        (entry,) = pair.port.cache.entries()
        assert entry.plan.key == seen["ref"][0][1]
        assert entry.plan.n_images == 2
    finally:
        for reg in (RR, TR):
            reg._REGISTRY.pop("_planned_test", None)


def test_failed_admission_evicts_into_the_ladder(rng, monkeypatch):
    """An admission that raises (the session's planes may be half
    written) evicts the occupants and the requests not yet admitted into
    the recovery ladder: every ticket still ends ``ok`` with the value
    the batch path gives, on the same engine and device."""
    cases = [recon_pair(rng) for _ in range(3)]
    svc = TS.Service(continuous=True, max_batch=2, max_delay_ms=1e9,
                     pad_quantum=16, refill_quantum=2, device="cpu",
                     max_retries=1, clock=TS.VirtualClock())
    tickets = [svc.submit("reconstruct", m, f) for m, f in cases[:2]]
    (engine,) = svc._engines.values()
    real = engine.session.admit
    calls = []

    def flaky(state, slot, *inputs):
        calls.append(slot)
        if len(calls) == 1:  # the refill of the third request
            raise RuntimeError("admission failed")
        return real(state, slot, *inputs)

    monkeypatch.setattr(engine, "session",
                        engine.session._replace(admit=flaky))
    tickets.append(svc.submit("reconstruct", *cases[2]))
    svc.flush()
    assert [t.outcome for t in tickets] == ["ok"] * 3
    counters = svc.stats()["counters"]
    assert counters["batch_failures"] == 1 and counters["retried"] == 1
    batch = TS.Service(max_batch=2, max_delay_ms=1e9, pad_quantum=16,
                       device="cpu")
    want = [batch.submit("reconstruct", m, f) for m, f in cases]
    batch.flush()
    for t, w in zip(tickets, want):
        assert torch.equal(t.result(), w.result())
    assert not engine.occupied and engine.state is None
