"""``repro_torch.api.compile`` against ``repro.api.compile``: every
main-path composite on 2-D images and (N, H, W) stacks, both port
engines against the reference's outputs (its ``"xla"`` engine, which the
reference holds bit-exact with ``"pallas"``), and ``stats()`` equal to
the reference's ``"pallas"`` executable, key for key, with
``rewrite=False`` on both sides and with default arguments (both
rewrite).  Tiny shapes; the port runs on the CPU (``device="cpu"``), where
the ``"cuda"`` engine's wrappers take their plain PyTorch versions.
"""
import numpy as np
import pytest
import torch

import repro.api as RA
import repro_torch.api as TA
from repro.core import operators as ROPS
from repro.data.images import blobs
from repro_torch.core import backend as TB
from repro_torch.core import morphology as TM
from repro_torch.core import operators as TOPS
from repro_torch.kernels import ops as TO

pytestmark = pytest.mark.pipeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: under several pytest
    workers on one machine each worker's torch thread pool
    oversubscribes the cores and its threads spin, which made cases
    here up to 100× slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BUILDERS = {
    "erode": lambda api, f: api.E.erode(5, f),
    "dilate": lambda api, f: api.E.dilate(3, f),
    "opening": lambda api, f: api.E.opening(2, f),
    "closing": lambda api, f: api.E.closing(2, f),
    "hmax": lambda api, f: api.hmax_expr(40, f),
    "dome": lambda api, f: api.dome_expr(40, f),
    "hfill": lambda api, f: api.hfill_expr(f),
    "raobj": lambda api, f: api.raobj_expr(f),
    "obr": lambda api, f: api.opening_by_reconstruction_expr(3, f),
    "asf": lambda api, f: api.asf_expr(2, f),
    "geodesic": lambda api, f: api.E.geodesic(
        api.E.sat_sub(f, 30), f, 11, op="dilate"),
}

SHAPES = {"2d": (37, 140), "3d": (2, 30, 45)}


def _image(shape, dtype):
    if len(shape) == 2:
        return blobs(*shape, dtype=dtype, seed=7)
    return np.stack([blobs(*shape[1:], dtype=dtype, seed=s)
                     for s in range(shape[0])])


@pytest.mark.parametrize("shape", SHAPES, ids=list(SHAPES))
@pytest.mark.parametrize("name", BUILDERS)
def test_compile_matches_reference(name, shape):
    dtype = np.uint8 if shape == "2d" else np.float32
    if name in ("hmax", "dome") and dtype == np.float32:
        dtype = np.uint16   # a contrast of 40 means something in uint16
    shp = SHAPES[shape]
    f = _image(shp, dtype)
    ref_expr = BUILDERS[name](RA, RA.E.input("f"))
    port_expr = BUILDERS[name](TA, TA.E.input("f"))
    ref = np.asarray(RA.compile(ref_expr, shp, dtype, "xla",
                                rewrite=False)(f))
    ref_stats = RA.compile(ref_expr, shp, dtype, "pallas",
                           rewrite=False).stats()
    for backend in ("cuda", "torch"):
        exe = TA.compile(port_expr, shp, dtype, backend, device="cpu")
        out = exe(torch.from_numpy(f))
        assert out.dtype == torch.from_numpy(f).dtype
        assert np.array_equal(ref, out.numpy()), backend
    stats = TA.compile(port_expr, shp, dtype, device="cpu",
                       rewrite=False).stats()
    ref_stats.pop("backend")
    assert stats.pop("backend") == "cuda"
    assert stats == ref_stats
    ref_default = RA.compile(ref_expr, shp, dtype, "pallas").stats()
    default = TA.compile(port_expr, shp, dtype, device="cpu").stats()
    ref_default.pop("backend")
    assert default.pop("backend") == "cuda"
    assert default == ref_default


def test_two_input_reconstruct_and_run_batch_stats():
    f = _image((2, 30, 45), np.uint8)
    marker = np.where(f > 60, f - 60, 0).astype(np.uint8)
    ref = np.asarray(RA.compile(
        RA.E.reconstruct(RA.E.input("marker"), RA.E.input("mask")),
        f.shape, np.uint8, "xla", rewrite=False)(marker, f))
    expr = TA.E.reconstruct(TA.E.input("marker"), TA.E.input("mask"))
    exe = TA.compile(expr, f.shape, np.uint8, device="cpu")
    assert np.array_equal(ref, exe(mask=f, marker=marker).numpy())
    outs, converged, busy, cap = exe.run_batch_stats(
        torch.from_numpy(marker), torch.from_numpy(f))
    assert np.array_equal(ref, outs[0].numpy())
    (out,) = exe.run_batch(torch.from_numpy(marker), torch.from_numpy(f))
    assert np.array_equal(ref, out.numpy())
    assert converged.tolist() == [True, True] and 0 < busy <= cap
    capped = TA.compile(expr, f.shape, np.uint8, max_chunks=1, device="cpu")
    _, converged, busy, cap = capped.run_batch_stats(
        torch.from_numpy(marker), torch.from_numpy(f))
    assert not converged.all() and busy == cap == 2


def test_operator_sugar_and_engine_entry_points():
    f = torch.from_numpy(_image((2, 30, 45), np.uint8))
    cpu = dict(device="cpu")
    for backend in ("cuda", "torch"):
        assert torch.equal(TOPS.hmax(f, 40, backend=backend, **cpu),
                           TOPS.hmax(f, 40, **cpu))
        assert torch.equal(TO.closing(f, 2, backend, **cpu),
                           TO.closing(f, 2, **cpu))
    ref = np.asarray(RA.compile(RA.asf_expr(1), (2, 30, 45), np.uint8,
                                "xla", rewrite=False)(f.numpy()))
    assert np.array_equal(ref, TOPS.asf(f, 1, **cpu).numpy())
    assert TOPS.asf_chain_length(3) == 24
    assert torch.equal(TO.morph_chain(f, 37, "erode", **cpu),
                       TO.morph_chain(f, 37, "erode", "torch", **cpu))
    assert torch.equal(TO.reconstruct(f // 2, f, "dilate", **cpu),
                       TO.reconstruct(f // 2, f, "dilate", "torch", **cpu))


def test_deprecation_shims_warn_and_match():
    """The reference's ``test_deprecation_shims_warn_and_match`` on the
    port: the legacy kwargs warn and give the non-legacy result."""
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.integers(0, 255, (36, 44)).astype(np.uint8))
    mask = torch.from_numpy(rng.integers(0, 255, (36, 44)).astype(np.uint8))
    marker = torch.minimum(f, mask)
    cpu = dict(device="cpu")
    assert TB.default_backend() == TB.canonicalize_backend(None) == "cuda"

    for backend in TB.BACKENDS:
        with pytest.warns(DeprecationWarning, match="backend"):
            legacy = TOPS.hmax(f, 40, backend=backend, **cpu)
        assert torch.equal(legacy, TOPS.hmax(f, 40, **cpu))

    with pytest.warns(DeprecationWarning, match="max_iters"):
        trunc = TOPS.hfill(f, max_iters=f.shape[0] * f.shape[1], **cpu)
    assert torch.equal(trunc, TOPS.hfill(f, **cpu))

    with pytest.warns(DeprecationWarning, match="backend"):
        legacy = TO.reconstruct(marker, mask, "dilate", backend="torch",
                                **cpu)
    assert torch.equal(legacy, TM.dilate_reconstruct(marker, mask))

    with pytest.warns(DeprecationWarning, match="max_chunks"):
        capped = TO.reconstruct(marker, mask, "dilate",
                                max_chunks=f.shape[0] * f.shape[1], **cpu)
    assert torch.equal(capped, TM.dilate_reconstruct(marker, mask))

    with pytest.warns(DeprecationWarning, match="backend"):
        d, r = TO.qdt_planes(f, backend="torch", **cpu)
    dw, rw = TOPS.qdt_raw(f)
    assert torch.equal(d, dw) and torch.equal(r, rw)

    for name in ("erode", "dilate", "opening", "closing"):
        with pytest.warns(DeprecationWarning, match="backend"):
            legacy = getattr(TO, name)(f, 2, backend="cuda", **cpu)
        assert torch.equal(legacy, getattr(TO, name)(f, 2, **cpu))
    with pytest.warns(DeprecationWarning, match="backend"):
        TOPS.qdt(f, backend="torch", **cpu)
    g = f.float()
    with pytest.warns(DeprecationWarning, match="max_chunks"):
        legacy = TO.gdt(g, (f > 250).float(), max_chunks=10 ** 4, **cpu)
    assert torch.equal(legacy, TO.gdt(g, (f > 250).float(), **cpu))


#: Legacy truncated calls: the operator, its arguments, the
#: ``max_iters`` cap of elementary steps and whether it goes positionally.
TRUNCATED = {
    "hmax-positional": ("hmax", (40,), 5, True),
    "dome": ("dome", (40,), 4, False),
    "hfill": ("hfill", (), 3, False),
    "raobj": ("raobj", (), 3, False),
    "obr-positional": ("opening_by_reconstruction", (2,), 6, True),
}


@pytest.mark.parametrize("case", TRUNCATED)
def test_truncated_legacy_calls_match_reference(case):
    """``hmax(f, 40, 5)`` and friends run the reference's truncated
    reconstruction (not the converged one) under its warning."""
    name, args, cap, positional = TRUNCATED[case]
    legacy = ((*args, cap), {}) if positional else (args, {"max_iters": cap})
    f = _image((2, 30, 45), np.uint8)
    with pytest.warns(DeprecationWarning, match="max_iters"):
        ref = np.asarray(getattr(ROPS, name)(f, *legacy[0], **legacy[1]))
    t = torch.from_numpy(f)
    with pytest.warns(DeprecationWarning, match="max_iters"):
        got = getattr(TOPS, name)(t, *legacy[0], **legacy[1], device="cpu")
    assert np.array_equal(ref, got.numpy())
    assert not torch.equal(got, getattr(TOPS, name)(t, *args, device="cpu"))


@pytest.mark.parametrize("specialize", (False, True))
def test_forced_specialization_matches_reference(specialize):
    f = _image((2, 30, 45), np.uint8)
    ref_expr = RA.opening_by_reconstruction_expr(3)
    ref_exe = RA.compile(ref_expr, f.shape, np.uint8, "pallas",
                         rewrite=False, specialize=specialize)
    exe = TA.compile(TA.opening_by_reconstruction_expr(3), f.shape,
                     np.uint8, rewrite=False, specialize=specialize,
                     device="cpu")
    assert [p.key for p in exe.all_plans] == [
        p.key for p in ref_exe.all_plans]
    want = RA.compile(ref_expr, f.shape, np.uint8, "xla", rewrite=False)(f)
    assert np.array_equal(np.asarray(want), exe(f).numpy())


def test_gdt_requires_a_float_dtype():
    f = TA.E.input("f")
    with pytest.raises(TypeError, match="float dtype"):
        TA.compile(TA.E.gdt(f, f), (8, 8), np.uint8, device="cpu")
    exe = TA.compile(TA.E.gdt(f, f), (8, 8), np.float32, device="cpu")
    assert exe.stats()["launches"] == 1 and exe.program.convergent


def test_compile_cache_and_input_checks():
    TA.clear_cache()
    expr = TA.hmax_expr(10)
    a = TA.compile(expr, (9, 9), np.uint8, device="cpu")
    assert TA.compile(expr, (9, 9), torch.uint8, device="cpu") is a
    stats = TA.cache_stats()
    assert (stats["hits"], stats["misses"], stats["entries"]) == (1, 1, 1)
    with pytest.raises(ValueError, match="shape"):
        a(torch.zeros((9, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="dtype"):
        a(torch.zeros((9, 9), dtype=torch.float32))
    with pytest.raises(ValueError, match="backend"):
        TA.compile(expr, (9, 9), np.uint8, "xla", device="cpu")
    with pytest.raises(TypeError, match="pipe"):
        TA.compile(TA.E.erode(2), (9, 9), np.uint8, device="cpu")
    assert a.key != TA.compile(expr, (9, 9), np.uint8, "torch",
                               device="cpu").key
