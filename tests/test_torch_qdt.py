"""The port's quasi-distance transform (Alg. 5) against the reference.

Each QDT kernel's plain PyTorch version against the reference's Pallas
kernel (interpret mode on the CPU) on the same seeded inputs, with
activity grids holding zeros, ragged per-cell ``base`` offsets and
sentinel slots; ``qdt_planes`` and its scheduler statistics against the
reference's ``"pallas"`` engine under the same explicit plans
(``plan_from_key``), tiled and row-only, batched and ragged; the QDT
operators and ``compile(E.qdt(f))`` / ``compile(qdt_l1_expr())`` on both
engines against the reference.  Tiny shapes; the port runs on the CPU
(``device="cpu"``), where the kernel wrappers take their plain versions.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as RA
import repro_torch.api as TA
from repro.core import operators as ROPS
from repro.core.chain import ChainPlan
from repro.data.images import blobs
from repro.kernels import ops as RO
from repro.kernels import qdt_chain as RQ
from repro_torch.core import operators as TOPS
from repro_torch.core.chain import plan_from_key
from repro_torch.kernels import ops as TO
from repro_torch.kernels import qdt_chain as TQ
from repro_torch.kernels import ref as TR

DTYPES = (np.uint8, np.uint16, np.int32, np.float32)
IDS = [d.__name__ for d in DTYPES]

# a 3-image stack of 2 bands each, 16-row bands, K = 4, two 128-col tiles
H, W, BAND, K, BPI, TILE = 96, 256, 16, 4, 2, 128


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


def _rand(rng, shape, dtype, nan=True):
    """Seeded values over the dtype's whole range (NaN in 1 % of float
    pixels), so int32 residuals wrap as in the reference."""
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal(shape).astype(dtype)
        if nan:
            x[rng.random(shape) < 0.01] = np.nan
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape,
                        endpoint=True).astype(dtype)


def _planes(rng, shape, dtype, wide_r=False):
    """Mid-flight r (accumulator dtype) and d planes.  ``wide_r`` draws
    r over the whole int32 range with its extremes in place (negative
    values, values above any uint8 residual): whatever r holds, the
    masked store is ``res > r``, which the CUDA kernel's uint8 clamp of
    r to [-1, 255] must leave unchanged."""
    if wide_r:
        info = np.iinfo(np.int32)
        r = rng.integers(info.min, info.max, shape, endpoint=True)
        r.flat[:4] = (info.min, info.max, -1, 256)
        r = r.astype(np.float32 if np.issubdtype(dtype, np.floating)
                     else np.int32)
    elif np.issubdtype(dtype, np.floating):
        r = _rand(rng, shape, np.float32)
    else:
        r = rng.integers(0, 200, shape).astype(np.int32)
    return r, rng.integers(0, 50, shape).astype(np.int32)


#: (dtype, wide_r) cases of the plain-vs-Pallas tests: r from [0, 200)
#: (ids as before), then r over the whole int32 range.
R_CASES = [(d, False) for d in DTYPES] + [(d, True) for d in DTYPES]
R_IDS = IDS + [f"{i}-r_int32" for i in IDS]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(ref, port):
    return np.array_equal(np.asarray(ref), port.numpy(), equal_nan=True)


def _all_eq(ref, port):
    assert len(ref) == len(port) == 4
    assert [_eq(a, b) for a, b in zip(ref, port)] == [True] * 4


@pytest.mark.parametrize("dtype, wide_r", R_CASES, ids=R_IDS)
def test_qdt_chain_step_plain_matches_pallas(dtype, wide_r):
    rng = np.random.default_rng(10)
    f = _rand(rng, (H, W), dtype)
    r, d = _planes(rng, (H, W), dtype, wide_r)
    base = rng.integers(0, 100, (H // BAND, 1)).astype(np.int32)
    act = np.array([[1], [0], [1], [1], [0], [1]], np.int32)
    args = dict(fuse_k=K, band_h=BAND, bands_per_image=BPI)
    ref = RQ.qdt_chain_step(*map(jnp.asarray, (f, r, d, base)),
                            active=jnp.asarray(act), **args)
    port = TQ.qdt_chain_step_plain(*map(_t, (f, r, d, base)),
                                   active=_t(act), **args)
    _all_eq(ref, port)
    assert port[3].dtype == torch.int32 and port[3].shape == (6, 1)


@pytest.mark.parametrize("dtype, wide_r", R_CASES, ids=R_IDS)
def test_qdt_tile_step_plain_matches_pallas(dtype, wide_r):
    rng = np.random.default_rng(11)
    f = _rand(rng, (H, W), dtype)
    r, d = _planes(rng, (H, W), dtype, wide_r)
    grid = (H // BAND, W // TILE)
    base = rng.integers(0, 100, grid).astype(np.int32)
    act = rng.integers(0, 2, grid).astype(np.int32)
    act[0, 0], act[-1, -1] = 0, 1
    args = dict(fuse_k=K, band_h=BAND, tile_w=TILE, bands_per_image=BPI)
    ref = RQ.qdt_tile_step(*map(jnp.asarray, (f, r, d, base)),
                           active=jnp.asarray(act), **args)
    port = TQ.qdt_tile_step_plain(*map(_t, (f, r, d, base)),
                                  active=_t(act), **args)
    _all_eq(ref, port)


@pytest.mark.parametrize("dtype, wide_r", R_CASES, ids=R_IDS)
def test_qdt_compact_step_plain_matches_pallas(dtype, wide_r):
    rng = np.random.default_rng(12)
    cap, ph, pw = 4, BAND + 2 * K, TILE + 2 * K
    fp = _rand(rng, (cap * ph, pw), dtype)
    r, d = _planes(rng, (cap * BAND, TILE), dtype, wide_r)
    valid = np.array([[1], [1], [0], [1]], np.int32)  # slot 2: sentinel
    base = np.array([[3], [40], [0], [11]], np.int32)
    args = dict(fuse_k=K, band_h=BAND, tile_w=TILE)
    ref = RQ.qdt_compact_step(*map(jnp.asarray, (fp, r, d, valid, base)),
                              **args)
    port = TQ.qdt_compact_step_plain(*map(_t, (fp, r, d, valid, base)),
                                     **args)
    _all_eq(ref, port)
    assert port[3].ravel().tolist()[2] == 0


def test_float64_plain_versions_match_own_oracle():
    """float64 has no JAX counterpart without x64: on one image (every
    band the image's) one chunk of K steps is the port's K-step oracle,
    whose residuals are float32 of the float32-cast operands."""
    rng = np.random.default_rng(13)
    f = _t(rng.standard_normal((H, W)))
    r = torch.zeros((H, W), dtype=torch.float32)
    d = torch.zeros((H, W), dtype=torch.int32)
    want = TR.qdt_chunk(f, r, d, 7, K)
    base = torch.full((H // BAND, 1), 7, dtype=torch.int32)
    got = TQ.qdt_chain_step(f, r, d, base, fuse_k=K, band_h=BAND)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want))
    got = TQ.qdt_tile_step(f, r, d, torch.tensor([[7]], dtype=torch.int32),
                           fuse_k=K, band_h=BAND, tile_w=TILE)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], want))
    assert got[1].dtype == torch.float32 and bool(got[3].all())


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(14)
    f = _t(_rand(rng, (H, W), np.uint8))
    r, d = map(_t, _planes(rng, (H, W), np.uint8))
    before = (TQ.qdt_chain_step.launches, TQ.qdt_tile_step.launches,
              TQ.qdt_compact_step.launches)
    one = torch.tensor([[5]], dtype=torch.int32)
    args = dict(fuse_k=K, band_h=BAND, bands_per_image=BPI)
    # a (1, 1) base broadcasts, as in the reference
    got = TQ.qdt_chain_step(f, r, d, one, **args)
    want = TQ.qdt_chain_step_plain(
        f, r, d, torch.full((6, 1), 5, dtype=torch.int32),
        active=torch.ones((6, 1), dtype=torch.int32), **args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = TQ.qdt_tile_step(f, r, d, one, tile_w=TILE, **args)
    assert got[3].shape == (6, 2)
    cap = 2
    fp = f[: cap * (BAND + 2 * K), : TILE + 2 * K].contiguous()
    rm, dm = r[: cap * BAND, :TILE], d[: cap * BAND, :TILE]
    got = TQ.qdt_compact_step(fp, rm, dm, None, one, fuse_k=K, band_h=BAND,
                              tile_w=TILE)
    assert got[0].shape == (cap * BAND, TILE) and got[3].shape == (cap, 1)
    # the launch counters move only where a CUDA kernel launches
    assert before == (TQ.qdt_chain_step.launches, TQ.qdt_tile_step.launches,
                      TQ.qdt_compact_step.launches)
    with pytest.raises(ValueError, match="r: expected a torch.int32"):
        TQ.qdt_chain_step(f, r.float(), d, one, **args)
    with pytest.raises(ValueError, match="base"):
        TQ.qdt_chain_step(f, r, d, torch.zeros((3, 1), dtype=torch.int32),
                          **args)
    with pytest.raises(ValueError, match="tile_w"):
        TQ.qdt_tile_step(f, r, d, one, tile_w=96, **args)


def _ragged(dtype):
    """Three 64×256 images that converge after different chunk counts:
    flat (one chunk), a large object (erosion iterates longest) and a
    busy one.  The width needs no padding, so a flat image is done after
    its first chunk."""
    hh, ww = 64, 256
    flat = np.zeros((hh, ww), dtype)
    deep = np.zeros((hh, ww), dtype)
    deep[6:58, 10:246] = 200
    busy = np.random.default_rng(15).integers(0, 200, (hh, ww))
    return np.stack([flat, deep, busy.astype(dtype)])


def _batch(dtype):
    return np.stack([blobs(48, 260, dtype, seed=s) for s in (0, 1)])


# (inputs, plan): K = 8 plans keep the interpreted Pallas kernels fast
# (the planner's own plans are held by test_compile_qdt_matches_reference)
PLANES = {
    "one-image-float32": (lambda: blobs(40, 100, np.float32, seed=3),
                          ChainPlan(16, 8, 128, 48, 3, 1, n_images=1,
                                    compact_threshold=0.5)),
    "batch-uint16": (lambda: _batch(np.uint16),
                     ChainPlan(16, 8, 384, 48, 3, 1, n_images=2,
                               compact_threshold=0.5, tile_w=128)),
    "ragged-tiled-uint8": (lambda: _ragged(np.uint8),
                           ChainPlan(16, 8, 256, 64, 4, 1, n_images=3,
                                     compact_threshold=0.5, tile_w=128)),
    "ragged-rows-uint8": (lambda: _ragged(np.uint8),
                          ChainPlan(16, 8, 256, 64, 4, 1, n_images=3,
                                    compact_threshold=0.5, tile_w=0)),
}


@pytest.mark.parametrize("case", PLANES)
def test_qdt_planes_and_stats_match_pallas(case, monkeypatch):
    make, plan = PLANES[case]
    f = make()
    ref_exe = RA.compile(RA.E.qdt(RA.E.input("f")), f.shape, f.dtype,
                         "pallas", plan=plan)
    (ref_d, ref_r), ref_conv, ref_busy, ref_cap = ref_exe.run_batch_stats(
        jnp.asarray(f))
    if case == "one-image-float32":
        # the reference's own entry point runs the same program
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            got = RO.qdt_planes(jnp.asarray(f), "pallas", plan=plan)
        assert all(map(np.array_equal, got, (ref_d, ref_r)))

    compact = []
    step = TO.qdt_compact_step
    monkeypatch.setattr(TO, "qdt_compact_step",
                        lambda *a, **k: compact.append(1) or step(*a, **k))
    port_plan = plan_from_key(plan.key)
    d, r = TO.qdt_planes(_t(f), plan=port_plan, device="cpu")
    assert d.dtype == torch.int32 and d.shape == f.shape
    assert _eq(ref_d, d) and _eq(ref_r, r)
    exe = TA.compile(TA.E.qdt(TA.E.input("f")), f.shape, f.dtype,
                     plan=port_plan, device="cpu")
    assert [p.key for p in exe.all_plans] == [
        p.key for p in ref_exe.all_plans]
    (d2, r2), conv, busy, cap = exe.run_batch_stats(_t(f))
    assert torch.equal(d2, d) and torch.equal(r2, r)
    assert conv.tolist() == np.asarray(ref_conv).tolist()
    assert (busy, cap) == (int(ref_busy), int(ref_cap))
    if case.startswith("ragged"):
        # each image keeps its own distance index; the flat one stopped
        # early, and the sparse tail ran on the compact workspace
        assert busy < cap and compact


def test_qdt_budget_truncation_is_reported():
    f = _ragged(np.uint8)
    plan = plan_from_key(PLANES["ragged-tiled-uint8"][1].key)
    exe = TA.compile(TA.E.qdt(TA.E.input("f")), f.shape, np.uint8,
                     plan=plan, max_chunks=1, device="cpu")
    _, conv, busy, cap = exe.run_batch_stats(_t(f))
    assert conv.tolist() == [True, False, False] and busy == cap == 3
    assert exe.stats()["chunk_budget_qdt"] == 1


def _male():
    return blobs(36, 52, np.uint8, seed=21)


OPERATORS = {
    "qdt_raw": (lambda ops, x: ops.qdt_raw(x), {}),
    "qdt_raw-max_s": (lambda ops, x: ops.qdt_raw(x, 3), {}),
    "qdt_regularize": (
        lambda ops, x: ops.qdt_regularize(ops.qdt_raw(x)[0]), {}),
    "qdt": (lambda ops, x, **kw: ops.qdt(x, **kw), {"device": "cpu"}),
    "qdt-max_s": (lambda ops, x, **kw: ops.qdt(x, 5, **kw),
                  {"device": "cpu"}),
    "granulometric_function": (
        lambda ops, x, **kw: ops.granulometric_function(x, 4, **kw),
        {"device": "cpu"}),
    "pattern_spectrum": (
        lambda ops, x, **kw: ops.pattern_spectrum(x, 4, **kw),
        {"device": "cpu"}),
}


@pytest.mark.parametrize("name", OPERATORS)
def test_qdt_operators_match_reference(name):
    fn, kw = OPERATORS[name]
    f = _male()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = fn(ROPS, jnp.asarray(f))
    port = fn(TOPS, _t(f), **kw)
    ref, port = (ref, port) if isinstance(ref, tuple) else ((ref,), (port,))
    for a, b in zip(ref, port, strict=True):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert _eq(a, b)


def test_qdt_on_flat_disk():
    """QDT of a flat bright square = L∞→η-corrected distance to edge."""
    img = np.zeros((33, 33), np.uint8)
    img[8:25, 8:25] = 100
    d = TOPS.qdt(_t(img), device="cpu").numpy()
    assert d[16, 16] == d.max()     # centre is deepest
    assert d.max() >= 8             # half width of the square
    assert (np.abs(np.diff(d, axis=0)) <= 1).all()
    assert np.array_equal(d, np.asarray(ROPS.qdt(jnp.asarray(img))))


EXPRS = {"qdt": lambda api: api.E.qdt(api.E.input("f")),
         "qdt_l1": lambda api: api.qdt_l1_expr()}
SHAPES = {"2d-uint8": ((37, 140), np.uint8),
          "3d-float32": ((2, 30, 45), np.float32),
          "3d-uint16": ((2, 30, 45), np.uint16)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", EXPRS)
def test_compile_qdt_matches_reference(name, shape):
    shp, dtype = SHAPES[shape]
    f = (blobs(*shp, dtype=dtype, seed=7) if len(shp) == 2 else
         np.stack([blobs(*shp[1:], dtype=dtype, seed=s)
                   for s in range(shp[0])]))
    ref_expr, port_expr = EXPRS[name](RA), EXPRS[name](TA)
    ref = RA.compile(ref_expr, shp, dtype, "xla")(f)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for backend in ("cuda", "torch"):
        out = TA.compile(port_expr, shp, dtype, backend, device="cpu")(_t(f))
        out = out if isinstance(out, tuple) else (out,)
        assert [_eq(a, b) for a, b in zip(ref, out, strict=True)] == [
            True] * len(ref), backend
    stats = TA.compile(port_expr, shp, dtype, device="cpu").stats()
    ref_stats = RA.compile(ref_expr, shp, dtype, "pallas").stats()
    ref_stats.pop("backend")
    assert stats.pop("backend") == "cuda"
    assert stats == ref_stats
