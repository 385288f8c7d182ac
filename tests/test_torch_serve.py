"""repro_torch.serve against repro.serve on the CPU: the same request
streams, made from a NumPy seed at 33-96 px, go through the reference's
``Service`` and the port's ``Service(backend="cuda", device="cpu")``
(whose kernel wrappers run their plain PyTorch versions) on twin
virtual clocks.  Every ticket must end with the same outcome and, where
it has a value, an equal one (``array_equal``); the services' counters,
cache statistics, bucket tables and ``bench_rows()`` must be equal.

Most streams are held against the reference's ``"xla"`` engine, whose
chunk counters are 0; the erode bucket here (and the reconstruction
bucket of ``test_torch_serve_async.py``) are held against its
``"pallas"`` engine in interpret mode, where ``busy_chunks`` /
``cap_chunks`` (``work_occupancy``) are compared too.  A small stream
served on the card is in ``test_torch_cuda.py`` (no jax there).
"""
import numpy as np
import pytest
import torch

from repro import serve as RS
from repro.serve import faults as RF
from repro.serve import registry as RR
from repro.serve.bucketer import bucket_hw as ref_bucket_hw
from repro.serve.bucketer import canonical_batch as ref_canonical_batch
from repro.serve.bucketer import pad_fill as ref_pad_fill
from repro_torch import serve as TS
from repro_torch.serve import faults as TF
from repro_torch.serve import registry as TR
from repro_torch.serve.bucketer import bucket_hw, canonical_batch, pad_fill

pytestmark = pytest.mark.serve

#: Every op the reference's registry serves (the port must serve these).
OP_NAMES = ("asf", "closing", "dilate", "dome", "erode", "gdt", "geodesic",
            "hfill", "hmax", "open_rec", "opening", "qdt", "qdt_l1", "raobj",
            "reconstruct", "seg_hmin", "seg_scribble")

#: Totals and bucket fields compared on every stream (``work_occupancy``
#: only against the reference's pallas engine: its xla engine counts no
#: chunks).
FIELDS = ("requests", "batches", "errors", "degraded", "batch_occupancy",
          "rounds", "latency", "fps", "mpx_per_s")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    share the machine; a wide torch pool per worker oversubscribes it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def image(rng, shape=(16, 16), dtype=np.uint8):
    if np.dtype(dtype).kind == "f":
        return rng.uniform(0.0, 1.0, shape).astype(dtype)
    return rng.integers(0, 255, shape).astype(dtype)


def as_numpy(value):
    if isinstance(value, tuple):
        return tuple(as_numpy(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.cpu().numpy()
    return np.asarray(value)


class Pair:
    """The reference's and the port's ``Service`` fed one request
    stream, each on its own virtual clock; every call goes to both."""

    def __init__(self, ref_backend="xla", spec=None, **kw):
        self.ref_backend = ref_backend
        self.clocks = (RS.VirtualClock(), TS.VirtualClock())
        rf = {} if spec is None else {"faults": RF.parse(spec)}
        tf = {} if spec is None else {"faults": TF.parse(spec)}
        self.ref = RS.Service(backend=ref_backend, clock=self.clocks[0],
                              **rf, **kw)
        self.port = TS.Service(backend="cuda", device="cpu",
                               clock=self.clocks[1], **tf, **kw)
        self.tickets: list = []

    def submit(self, op, *images, **kw):
        """Submit to both; a rejection must be the same typed error
        with the same message on both sides (then it is re-raised)."""
        out = []
        for svc in (self.ref, self.port):
            try:
                out.append(svc.submit(op, *images, **kw))
            except Exception as exc:  # compared below, then re-raised
                out.append(exc)
        r, p = out
        if isinstance(r, Exception) or isinstance(p, Exception):
            assert type(r).__name__ == type(p).__name__, (r, p)
            assert str(r) == str(p)
            assert getattr(r, "code", None) == getattr(p, "code", None)
            raise p
        self.tickets.append((r, p))
        return r, p

    def __getattr__(self, name):
        """``pair.flush()``, ``pair.poll()``, ... on both services;
        returns the pair of results."""
        def both(*args, **kw):
            return (getattr(self.ref, name)(*args, **kw),
                    getattr(self.port, name)(*args, **kw))
        return both

    def advance(self, dt: float) -> None:
        for clock in self.clocks:
            clock.advance(dt)

    def check(self) -> None:
        """Equal ticket outcomes and values, equal statistics."""
        for r, p in self.tickets:
            assert r.done == p.done and r.outcome == p.outcome, (
                r.op, r.outcome, p.outcome)
            assert r.degraded == p.degraded
            if r.error is not None:
                assert type(r.error).__name__ == type(p.error).__name__
                assert r.error.code == p.error.code
            elif r.done:
                want, got = as_numpy(r.value), as_numpy(p.value)
                if isinstance(want, tuple):
                    assert isinstance(got, tuple) and len(got) == len(want)
                    for w, g in zip(want, got):
                        np.testing.assert_array_equal(g, w, err_msg=r.op)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=r.op)
                    assert got.dtype == want.dtype
                assert isinstance(p.value, (torch.Tensor, tuple))
        sr, sp = self.ref.stats(), self.port.stats()
        for key in ("counters", "cache", "faults"):
            assert sr[key] == sp[key], key
        assert sr["buckets"].keys() == sp["buckets"].keys()
        fields = FIELDS + (("work_occupancy",)
                           if self.ref_backend == "pallas" else ())
        for label in sr["buckets"]:
            for f in fields:
                assert sr["buckets"][label][f] == sp["buckets"][label][f], (
                    label, f)
        for f in fields:
            assert sr["totals"][f] == sp["totals"][f], f
        assert self.ref.bench_rows() == self.port.bench_rows()
        assert self.ref.pending() == self.port.pending()


# ---------------------------------------------------------------------------
# registry: the same ops, schemas and derived stages
# ---------------------------------------------------------------------------


def test_registry_names_equal_the_reference():
    assert TR.names() == RR.names() == OP_NAMES


@pytest.mark.parametrize("op", OP_NAMES)
def test_registry_spec_equals_the_reference(op):
    r, p = RR.get(op), TR.get(op)
    assert dict(p.params) == {k: TR.ParamSpec(**vars(v))
                              for k, v in r.params.items()}
    for field in ("arity", "n_inputs", "n_outputs", "dtypes", "pad_safe"):
        assert getattr(p, field) == getattr(r, field), field
    canon = p.canonical_params({k: v.sample() for k, v in p.params.items()})
    assert canon == r.canonical_params(dict(canon))
    ri, pi = RR.request_info(op, canon), TR.request_info(op, canon)
    for field in ("label", "n_inputs", "n_outputs", "fills", "pad_safe",
                  "n_rewrites"):
        assert getattr(pi, field) == getattr(ri, field), field
    assert ((TR.request_finalize(op, canon) is None)
            == (RR.request_finalize(op, canon) is None))


@pytest.mark.parametrize("op,images,params,error,match", [
    ("nope", 1, None, KeyError, "unknown op"),
    ("hmax", 1, None, ValueError, "missing required param"),
    ("hfill", 1, {"x": 1}, ValueError, "unknown params"),
    ("reconstruct", 2, {"op": "median"}, ValueError, "must be one of"),
    ("erode", 1, {"s": 0}, ValueError, "must be >="),
    ("reconstruct", 1, {"op": "dilate"}, ValueError, "takes 2 image"),
], ids=["unknown-op", "missing", "unknown-param", "choice", "min", "arity"])
def test_registry_param_validation(rng, op, images, params, error, match):
    pair = Pair()
    f = image(rng)
    with pytest.raises(error, match=match):
        pair.submit(op, *[f] * images, params=params)
    assert TR.get("hmax").canonical_params({"h": 40}) == (("h", 40.0),)
    pair.check()


def test_bucket_helpers_equal_the_reference():
    for h, w, q in ((60, 90, 32), (64, 96, 32), (33, 47, 16), (5, 5, 0)):
        assert bucket_hw(h, w, q) == ref_bucket_hw(h, w, q)
    for n, cap in ((1, 8), (3, 8), (5, 4), (3, 3), (8, 8)):
        assert canonical_batch(n, cap) == ref_canonical_batch(n, cap)
    for dtype in (np.uint8, np.uint16, np.int32, np.float32, np.float64):
        for which in ("hi", "lo"):
            want = ref_pad_fill(dtype, which)
            got = pad_fill(dtype, which)
            assert got.dtype == np.dtype(dtype)
            assert got == want or (np.isinf(got) and got == want)


# ---------------------------------------------------------------------------
# streams: bit-exact values, equal counters
# ---------------------------------------------------------------------------

#: The mixed stream's ops: pad-safe and exact-shape buckets, cross-op
#: packing (HMAX/DOME/RAOBJ) and finalize stages.  (The QDT's chunk
#: budget can trip on the port's engine, never on the reference's xla
#: engine: ``test_pallas_qdt_buckets_degrade_alike`` holds it against
#: the reference's pallas engine.)
MIXED = (("hmax", {"h": 40}), ("dome", {"h": 40}), ("raobj", {}),
         ("hfill", {}), ("erode", {"s": 4}), ("asf", {"s": 2}),
         ("open_rec", {"s": 2}))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_mixed_stream_bit_exact(rng, dtype):
    """A shuffled stream mixing shapes, pad-safe and exact-shape ops
    round-trips through bucketing, pad-to-bucket canonicalization,
    sentinel batch padding and the demux crop; round 2 replays every
    bucket from the compiled-program cache."""
    shapes = [(48, 80), (80, 48), (64, 96), (33, 47)]
    h_scale = 1.0 if dtype == np.uint8 else 1 / 200
    cases = []
    for shape in shapes:
        f = image(rng, shape, dtype)
        for op, params in MIXED:
            if "h" in params:
                params = {"h": params["h"] * h_scale}
            cases.append((op, f, params))
    pair = Pair(max_batch=4, max_delay_ms=1e9, pad_quantum=32)
    for _ in range(2):
        for i in rng.permutation(len(cases)):
            op, f, params = cases[i]
            pair.submit(op, f, params=params)
        pair.flush()
    pair.check()
    stats = pair.port.stats()
    assert stats["totals"]["requests"] == 2 * len(cases)
    assert any(b["requests"] > b["batches"]
               for b in stats["buckets"].values())
    assert stats["cache"]["hit_rate"] > 0


def test_pallas_erode_bucket_cache_and_plan(rng):
    """An erode bucket on the reference's pallas engine: cache hits, the
    plan the cached program embeds, and the values."""
    pair = Pair("pallas", max_batch=1, max_delay_ms=1e9, pad_quantum=32)
    f = image(rng, (40, 60))
    for _ in range(3):
        pair.submit("erode", f, params={"s": 4})
    pair.flush()
    pair.check()
    stats = pair.port.stats()["cache"]
    assert stats["misses"] == 1 and stats["hits"] == 2
    (ref_entry,) = pair.ref.cache.entries()
    (entry,) = pair.port.cache.entries()
    assert entry.plan.key == ref_entry.plan.key
    assert entry.plan.key[2] >= 64  # width_pad


def test_pallas_qdt_buckets_degrade_alike():
    """qdt_l1 on ragged frames in one 64x64 bucket of the reference's
    pallas engine: with this seed the 33x47 frame exhausts the QDT's
    chunk budget on both sides (a degraded ticket, its partial value
    equal), the other converges."""
    rng = np.random.default_rng(2)
    pair = Pair("pallas", max_batch=2, max_delay_ms=1e9, pad_quantum=32)
    for shape in ((33, 47), (60, 50)):
        pair.submit("qdt_l1", image(rng, shape))
    pair.flush()
    pair.check()
    assert [p.outcome for _, p in pair.tickets] == ["degraded", "ok"]


def test_arity2_and_multi_output(rng):
    """reconstruct and geodesic (two inputs) and qdt (two outputs)."""
    mask = image(rng, (48, 64))
    marker = np.minimum(image(rng, (48, 64)), mask)
    pair = Pair(max_batch=2, max_delay_ms=1e9, pad_quantum=32)
    pair.submit("reconstruct", marker, mask, params={"op": "dilate"})
    pair.submit("geodesic", marker, mask, params={"n": 5, "op": "dilate"})
    pair.submit("qdt", image(rng, (40, 56)))
    pair.flush()
    pair.check()
    d, r = pair.tickets[-1][1].result()
    assert d.dtype == torch.int32


def test_deadline_flush(rng):
    """A straggler request never waits more than max_delay_ms."""
    pair = Pair(max_batch=4, max_delay_ms=5.0, pad_quantum=32)
    _, t = pair.submit("erode", image(rng, (32, 32)), params={"s": 3})
    assert pair.pending() == (1, 1) and not t.done
    pair.advance(0.004)
    pair.poll()
    assert pair.pending() == (1, 1)
    pair.advance(0.002)
    pair.poll()
    assert pair.pending() == (0, 0)
    pair.flush()
    assert t.done
    pair.check()


def test_batch_occupancy_and_sentinels(rng):
    """3 requests into a max_batch=4 bucket: one batch of the canonical
    size with a sentinel slot, occupancy 3/4."""
    pair = Pair(max_batch=4, max_delay_ms=1e9, pad_quantum=32)
    for _ in range(3):
        pair.submit("dilate", image(rng, (30, 40)), params={"s": 3})
    pair.flush()
    pair.check()
    (bucket,) = pair.port.stats()["buckets"].values()
    assert (bucket["requests"], bucket["batches"]) == (3, 1)
    assert bucket["batch_occupancy"] == pytest.approx(0.75)


def test_full_bucket_launches_and_result_drives_pipeline(rng):
    """A full bucket launches without a poll; ``Ticket.result()`` on a
    queued request completes it without a flush."""
    pair = Pair(max_batch=2, max_delay_ms=1e9, pad_quantum=32)
    f = image(rng)
    pair.submit("erode", f, params={"s": 2})
    assert pair.pending() == (1, 1)
    pair.submit("erode", f, params={"s": 2})
    assert pair.pending() == (0, 0)
    r, p = pair.submit("erode", image(rng, (24, 24)), params={"s": 2})
    np.testing.assert_array_equal(as_numpy(p.result()),
                                  as_numpy(r.result()))
    pair.flush()
    pair.check()


def test_cache_warmup_prefill(rng):
    pair = Pair(max_batch=2, max_delay_ms=1e9, pad_quantum=32)
    pair.warmup([{"op": "erode", "params": {"s": 4}, "shape": (40, 60),
                  "dtype": np.uint8, "batch": 2}])
    assert pair.port.cache.stats()["warm_builds"] == 1
    for _ in range(2):
        pair.submit("erode", image(rng, (40, 60)), params={"s": 4})
    pair.flush()
    pair.check()
    stats = pair.port.cache.stats()
    assert stats["misses"] == 0 and stats["hits"] == 1


def test_cache_lru_eviction(rng):
    """Eviction follows recency of use: touching A before inserting C
    evicts B, and A stays resident."""
    pair = Pair(max_batch=1, max_delay_ms=1e9, pad_quantum=16,
                cache_capacity=2)
    for shape in ((16, 16), (32, 32), (16, 16), (48, 48), (16, 16)):
        pair.submit("erode", image(rng, shape), params={"s": 2})
    pair.flush()
    pair.check()
    stats = pair.port.cache.stats()
    assert (stats["entries"], stats["misses"], stats["hits"],
            stats["evictions"]) == (2, 3, 2, 1)


def test_dispatch_failure_resolves_tickets(rng):
    """A custom op whose run raises: both tickets resolve with a typed
    PoisonedRequestError (the cause preserved), nothing escapes."""
    def bad_run(*args):  # the reference passes a plan; the port does not
        raise RuntimeError("boom")

    for reg in (RR, TR):
        reg.register(reg.OpSpec(name="_boom_test", params={}, run=bad_run))
    try:
        pair = Pair(max_batch=2, max_delay_ms=1e9, pad_quantum=16,
                    max_retries=1)
        pair.submit("_boom_test", image(rng, (8, 8)))
        pair.submit("_boom_test", image(rng, (8, 8)))
        pair.check()
        for _, t in pair.tickets:
            assert t.outcome == "poisoned"
            with pytest.raises(TS.PoisonedRequestError, match="poisoned"):
                t.result()
            assert isinstance(t.error.cause, RuntimeError)
        assert pair.port.stats()["counters"]["poisoned"] == 2
    finally:
        for reg in (RR, TR):
            reg._REGISTRY.pop("_boom_test", None)


def test_optimizer_counters(rng):
    """``rewrites_applied`` (ASF's adjacent chains merge) and
    ``programs_shared`` (HMAX and DOME are one reconstruction)."""
    pair = Pair(max_batch=1, max_delay_ms=1e9, pad_quantum=16)
    f = image(rng, (24, 24))
    pair.submit("asf", f, params={"s": 1})
    pair.flush()
    pair.submit("hmax", f, params={"h": 40})
    pair.flush()
    pair.submit("dome", f, params={"h": 40})
    pair.flush()
    pair.check()
    counters = pair.port.stats()["counters"]
    assert counters["rewrites_applied"] >= 1
    assert counters["programs_shared"] == 1


def test_pin_serves_the_pinned_image(rng):
    """A pinned float image serves gdt and scribble requests by name;
    ``asset_hits`` counts them, and an unknown name is rejected.  The
    image fills its bucket: the reference's xla engine gives NaN for a
    gdt padded into a larger bucket (its -inf image fill makes NaN
    weights); the padded case is held against its pallas engine below."""
    pair = Pair(max_batch=4, max_delay_ms=1e9, pad_quantum=32)
    img = image(rng, (64, 64), np.float32)
    pair.pin("slice", img)
    for k in range(2):
        marks = np.zeros(img.shape, np.float32)
        marks[5 + 20 * k:9 + 20 * k, 8:14] = 1
        marks[0, :] = marks[-1, :] = 2
        pair.submit("seg_scribble", "slice", marks)
        pair.submit("gdt", "slice", (marks == 1).astype(np.float32),
                    params={"lamb": 0.5})
    with pytest.raises(TS.InvalidRequestError, match="unknown pinned"):
        pair.submit("gdt", "nope", img)
    pair.flush()
    pair.unpin("slice")
    pair.check()
    assert pair.port.stats()["counters"]["asset_hits"] == 4


def test_padded_gdt_equals_the_pallas_engine(rng):
    """A pinned image smaller than its bucket (12x14 in 16x16, its pad
    filled with -inf): the port's gdt equals the reference's pallas
    engine, chunk counters included, and its scribble segmentation the
    xla engine's (finite there)."""
    img = image(rng, (12, 14), np.float32)
    assert bucket_hw(*img.shape, 8) == (16, 16)
    marks = np.zeros(img.shape, np.float32)
    marks[4:7, 5:9] = 1
    marks[0, :] = marks[-1, :] = 2
    for ref_backend, op, second in (
            ("pallas", "gdt", (marks == 1).astype(np.float32)),
            ("xla", "seg_scribble", marks)):
        pair = Pair(ref_backend, max_batch=2, max_delay_ms=1e9,
                    pad_quantum=8)
        pair.pin("ragged", img)
        pair.submit(op, "ragged", second)
        pair.flush()
        pair.check()
        (_, t), = pair.tickets
        assert t.value.shape == img.shape
        assert not torch.isnan(t.value).any()


def test_metrics_bench_json_schema(rng):
    pair = Pair(max_batch=2, max_delay_ms=1e9, pad_quantum=32)
    for _ in range(2):
        pair.submit("erode", image(rng, (24, 24)), params={"s": 2})
    pair.flush()
    pair.check()
    svc = pair.port
    payload = svc.metrics.as_bench_json(svc.cache.stats())
    assert payload
    assert all(k.startswith("serve/") and isinstance(v, float)
               for k, v in payload.items())
    rows = svc.bench_rows()
    assert all({"name", "us_per_call", "derived"} <= set(r) for r in rows)
    assert "occ=" in rows[0]["derived"] and "cache_hit=" in rows[0]["derived"]


# ---------------------------------------------------------------------------
# the fault harness and typed admission
# ---------------------------------------------------------------------------


def test_parse_grammar():
    spec = "seed=7; dispatch:p=0.5,n=2 ;budget:value=1;poison"
    inj, ref = TF.parse(spec), RF.parse(spec)
    assert inj.seed == ref.seed == 7
    assert inj.specs["dispatch"] == TF.FaultSpec("dispatch", n=2, p=0.5)
    assert ({k: vars(v) for k, v in inj.specs.items()}
            == {k: vars(v) for k, v in ref.specs.items()})
    assert not TF.parse("").armed("dispatch")
    assert TF.SITES == RF.SITES


@pytest.mark.parametrize("bad", [
    "unknown_site", "dispatch:q=1", "dispatch:p=x", "seed=x",
    "dispatch:p=2", "dispatch:n=-1", "poison;poison",
])
def test_parse_rejects_malformed(bad):
    with pytest.raises(TF.FaultSpecError) as got:
        TF.parse(bad)
    with pytest.raises(RF.FaultSpecError) as want:
        RF.parse(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", [
    "seed=42;dispatch:p=0.3;poison:p=0.5,n=3",
    "seed=1702;dispatch:p=0.3;drain:p=0.3;poison:p=0.2",
])
def test_injector_draws_equal_the_reference(spec):
    """One spec and seed fire at the same opportunities on both sides."""
    seq = [s for s in ("dispatch", "drain", "poison", "deadline") * 40]
    port, ref = TF.parse(spec), RF.parse(spec)
    assert ([port.should_fire(s) for s in seq]
            == [ref.should_fire(s) for s in seq])
    assert port.snapshot() == ref.snapshot()


def test_from_env():
    inj = TF.from_env({"REPRO_FAULTS": "seed=3;drain:n=1"})
    assert inj.seed == 3 and inj.armed("drain")
    assert TF.from_env({}) is TF.NULL
    assert TF.from_env({"REPRO_FAULTS": "  "}) is TF.NULL


@pytest.mark.parametrize("case", ["nan", "inf", "complex", "bool"])
def test_typed_admission_rejections(rng, case):
    """Non-finite floats and dtypes without a lattice are rejected at
    submit with the reference's typed error and message; nothing
    enters a bucket."""
    pair = Pair(max_batch=4, max_delay_ms=1e9, pad_quantum=16)
    f = image(rng, (16, 16), np.float32)
    if case in ("nan", "inf"):
        f[3, 4] = np.nan if case == "nan" else np.inf
        error, op, params = TS.NonFiniteInputError, "hmax", {"h": 0.1}
    else:
        f = np.zeros((8, 8), np.complex64 if case == "complex" else bool)
        error, op, params = TS.RequestRejected, "hfill", None
    with pytest.raises(error):
        pair.submit(op, f, params=params)
    with pytest.raises(ValueError):  # typed rejections are ValueErrors
        pair.submit(op, f, params=params)
    assert pair.port.stats()["counters"]["rejected"] == 2
    pair.check()


def test_queue_full_sheds(rng):
    pair = Pair(max_batch=8, max_delay_ms=1e9, pad_quantum=16, max_queue=2)
    pair.submit("hfill", image(rng))
    pair.submit("hfill", image(rng))
    with pytest.raises(TS.QueueFullError, match="load-shed"):
        pair.submit("hfill", image(rng))
    pair.flush()
    pair.check()
    assert pair.port.stats()["counters"]["shed"] == 1
    assert pair.port.stats()["totals"]["requests"] == 2
