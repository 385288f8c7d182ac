"""The port's expression optimizer (``repro_torch.opt``) against the
reference's (``repro.opt``), mirroring ``tests/test_opt.py``: each rule
rewrites the same source graph to the same canonical graph (compared
through its printing), the catalogs are equal, the rewritten programs
give the reference's outputs bit for bit on both port engines, the
guards block the same unsound cases, the compile cache shares programs
across structurally different sources, and ``compile`` gives the
reference's ``stats()`` with default arguments and with
``rewrite=False``.  Tiny shapes; the port runs on the CPU
(``device="cpu"``), where the ``"cuda"`` engine's kernel wrappers take
their plain PyTorch versions.
"""
import numpy as np
import pytest
import torch

import repro.api as RA
import repro.opt as RO
import repro_torch.api as TA
import repro_torch.opt as TO
from repro_torch.api.lower import _input_names

pytestmark = pytest.mark.pipeline

DTYPES = [np.uint8, np.float32]
SHAPES = [(20, 27), (2, 16, 21)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: under several pytest
    workers on one machine each worker's torch thread pool
    oversubscribes the cores and its threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rule_cases(api):
    """The witness graph of each rule of ``tests/test_opt.py``, built
    with ``api``'s constructors."""
    E, Expr = api.E, api.Expr
    f = E.input("f")
    return {
        "neutral-chain": E.sub(Expr("erode", (E.dilate(3, f),), (("s", 0),)),
                               E.dilate(3, f)),
        "neutral-sat": E.sat_sub(E.sat_add(f, 0), 0),
        "self-reconstruct": E.reconstruct(f, f, op="dilate"),
        "self-geodesic": E.geodesic(f, f, 3, op="dilate"),
        "double-reconstruct": E.reconstruct(
            E.reconstruct(E.sat_sub(f, 40), f, op="dilate"), f,
            op="dilate"),
        "geodesic-prefix": E.reconstruct(
            E.geodesic(E.sat_sub(f, 40), f, 4, op="dilate"), f,
            op="dilate"),
        "rec-opening-idem": E.reconstruct(
            E.erode(3, E.reconstruct(E.erode(3, f), f, op="dilate")),
            f, op="dilate"),
        "chain-merge": E.erode(2, E.erode(3, f)),
        "opening-absorb": E.opening(3, E.opening(1, f)),
        "closing-absorb": E.closing(1, E.closing(3, f)),
    }


def _composites(api):
    """The optimizer's composites of ``benchmarks/bench_pipeline.py``
    (its quick size, s = 2)."""
    E = api.E
    g = E.input("f")
    return {
        "ASF2_over_opening": api.asf_expr(2, E.opening(1, g)),
        "OBR4_twice": E.reconstruct(
            E.erode(4, E.reconstruct(E.erode(4, g), g, op="dilate")),
            g, op="dilate"),
        "DOME_restab": E.sub(g, E.reconstruct(
            E.reconstruct(E.sat_sub(g, 40), g, op="dilate"),
            g, op="dilate")),
    }


REF_CASES, PORT_CASES = _rule_cases(RA), _rule_cases(TA)

#: neutral-chain's witness holds a zero-length segment the lowerer
#: refuses, so it cannot run unrewritten (as in ``tests/test_opt.py``).
EXEC_RULES = tuple(r for r in REF_CASES if r != "neutral-chain")


def _image(rng, shape, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.integers(0, 255, shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _stats_pair(ref_expr, port_expr, shape, dtype, **kw):
    """``stats()`` of the reference's ``"pallas"`` executable and the
    port's ``"cuda"`` one, without the backend's name."""
    ref = RA.compile(ref_expr, shape, dtype, "pallas", **kw).stats()
    port = TA.compile(port_expr, shape, dtype, device="cpu", **kw).stats()
    ref.pop("backend")
    assert port.pop("backend") == "cuda"
    return ref, port


@pytest.mark.parametrize("rule", sorted(REF_CASES))
def test_rule_rewrites_like_the_reference(rule):
    """Each rule fires on its witness, and the port's canonical graph
    and trace equal the reference's."""
    ref = RO.rewrite_traced(REF_CASES[rule])
    port = TO.rewrite_traced(PORT_CASES[rule])
    assert port.changed and rule in {a.rule for a in port.trace}
    assert repr(port.expr) == repr(ref.expr)
    assert [a.rule for a in port.trace] == [a.rule for a in ref.trace]
    assert [(repr(a.before), repr(a.after)) for a in port.trace] == [
        (repr(a.before), repr(a.after)) for a in ref.trace]


def test_catalog_equals_the_reference():
    assert TO.rule_names() == RO.rule_names()
    assert TO.rule_names() == tuple(r.name for r in TO.DEFAULT_RULES)
    assert [r.doc for r in TO.DEFAULT_RULES] == [
        r.doc for r in RO.DEFAULT_RULES]
    assert set(PORT_CASES) == set(TO.rule_names())


def test_neutral_chain_matches_constructor_folding():
    E = TA.E
    f = E.input("f")
    out = TO.rewrite(PORT_CASES["neutral-chain"])
    assert out == E.sub(E.dilate(3, f), E.dilate(3, f))


@pytest.mark.parametrize("rule", sorted(EXEC_RULES))
def test_rewritten_outputs_equal_the_reference(rule, rng):
    """The port's rewritten program (default ``compile``) on both
    engines equals the reference's verbatim program, bit for bit."""
    ref_expr, port_expr = REF_CASES[rule], PORT_CASES[rule]
    n_in = len(_input_names(port_expr))
    for dtype in DTYPES:
        for shape in SHAPES:
            imgs = [_image(rng, shape, dtype) for _ in range(n_in)]
            want = _as_tuple(RA.compile(ref_expr, shape, dtype, "xla",
                                        rewrite=False)(*imgs))
            for backend in ("cuda", "torch"):
                exe = TA.compile(port_expr, shape, dtype, backend,
                                 device="cpu")
                assert exe.rewrite_trace
                got = _as_tuple(exe(*(torch.from_numpy(x) for x in imgs)))
                for w, g in zip(want, got, strict=True):
                    assert np.array_equal(np.asarray(w), g.numpy()), (
                        backend, dtype, shape)


def test_chain_merge_guard_shared_intermediate():
    """A chain over a multiply-consumed node does not merge through it,
    on either side."""
    for api, opt in ((RA, RO), (TA, TO)):
        f = api.E.input("f")
        mid = api.E.erode(2, f)
        assert not opt.rewrite_traced(
            api.E.sub(api.E.erode(3, mid), mid)).changed


def test_absorb_guard_shared_inner_opening():
    """γ_s over a shared γ_t absorbs only where s <= t, as in the
    reference."""
    E = TA.E
    f = E.input("f")
    inner = E.opening(1, f)
    assert not TO.rewrite_traced(E.sub(E.opening(3, inner), inner)).changed
    shared = E.opening(3, f)
    assert TO.rewrite(E.sub(E.opening(1, shared), shared)) == E.sub(
        shared, shared)
    assert TO.rewrite(E.opening(1, E.opening(3, f))) == E.opening(3, f)
    assert TO.rewrite(E.opening(3, E.opening(1, f))) == E.opening(3, f)
    rf = RA.E.input("f")
    rinner = RA.E.opening(1, rf)
    assert not RO.rewrite_traced(
        RA.E.sub(RA.E.opening(3, rinner), rinner)).changed


def test_rewrite_is_idempotent():
    for expr in PORT_CASES.values():
        once = TO.rewrite(expr)
        assert TO.rewrite(once) == once


def test_rewrite_off_escape_hatch(rng):
    """``rewrite=False`` compiles the graph as written (more launches),
    with the reference's statistics either way and equal outputs."""
    ref_expr = REF_CASES["double-reconstruct"]
    port_expr = PORT_CASES["double-reconstruct"]
    img = _image(rng, (24, 24), np.uint8)
    on = TA.compile(port_expr, img.shape, img.dtype, device="cpu")
    off = TA.compile(port_expr, img.shape, img.dtype, device="cpu",
                     rewrite=False)
    assert on.stats()["launches"] < off.stats()["launches"]
    assert off.rewrite_trace == () and on.rewrite_trace
    assert on.key != off.key
    for kw in ({}, {"rewrite": False}):
        ref, port = _stats_pair(ref_expr, port_expr, img.shape, img.dtype,
                                **kw)
        assert port == ref
    assert torch.equal(on(img), off(img))


def test_cache_shares_canonical_programs():
    """Two structurally different graphs with one canonical form share a
    single cache entry; the hit counters tell the share apart."""
    E = TA.E
    f = E.input("f")
    TA.clear_cache()
    a = TA.compile(E.erode(2, E.erode(3, f)), (32, 32), np.uint8, "torch",
                   device="cpu")
    b = TA.compile(E.erode(5, f), (32, 32), np.uint8, "torch", device="cpu")
    assert a is b
    cs = TA.cache_stats()
    assert cs["entries"] == 1
    assert cs["shared_hits"] == 1 and cs["structural_hits"] == 0
    TA.compile(E.erode(5, f), (32, 32), np.uint8, "torch", device="cpu")
    assert TA.cache_stats()["structural_hits"] == 1
    assert TA.cache_stats()["hits"] == 2
    c = TA.compile(E.erode(2, E.erode(3, f)), (32, 32), np.uint8, "torch",
                   device="cpu", rewrite=False)
    assert c is not a and TA.cache_stats()["entries"] == 2
    TA.clear_cache()
    assert TA.cache_stats()["shared_hits"] == 0


def test_register_rule_rejects_duplicates():
    with pytest.raises(ValueError):
        TO.register_rule(TO.Rule("chain-merge", lambda node: None,
                                 lambda b, ctx: True, lambda b: b))
    assert len(TO.active_rules()) == len(TO.DEFAULT_RULES)


@pytest.mark.parametrize("name", sorted(_composites(RA)))
def test_pipeline_composites_match_the_reference(name):
    """The optimizer's composites of ``benchmarks/bench_pipeline.py``:
    ``stats()`` equal to the reference's with default arguments and
    with ``rewrite=False``, and the rewritten outputs equal the
    verbatim ones, bit for bit."""
    from repro.data.images import blobs

    ref_expr, port_expr = _composites(RA)[name], _composites(TA)[name]
    f = blobs(32, 40, dtype=np.uint8, seed=3)
    ref_on, port_on = _stats_pair(ref_expr, port_expr, f.shape, f.dtype)
    ref_off, port_off = _stats_pair(ref_expr, port_expr, f.shape, f.dtype,
                                    rewrite=False)
    assert port_on == ref_on and port_off == ref_off
    assert port_on["launches"] < port_off["launches"]
    if name == "OBR4_twice":
        assert port_on["launches"] == 2 and port_off["launches"] == 4
    want = np.asarray(RA.compile(ref_expr, f.shape, f.dtype, "xla",
                                 rewrite=False)(f))
    for kw in ({}, {"rewrite": False}):
        got = TA.compile(port_expr, f.shape, f.dtype, device="cpu", **kw)(f)
        assert np.array_equal(want, got.numpy()), kw
