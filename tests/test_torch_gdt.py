"""The port's grey-weighted geodesic distance (``repro_torch.gdt``)
against the reference.

Each gdt kernel's plain PyTorch version against the reference's Pallas
kernel (interpret mode on the CPU) on the same seeded inputs, for λ = 0
(the constant-weight branch) and λ = 0.37, with activity grids holding
zeros, sentinel slots, pad cells (``s = −1``) inside the image, +inf in
``d`` and NaN in ``i``; the float64 plain versions against the port's own
NumPy oracle (the reference computes float64 as float32); ``ops.gdt``
and its scheduler statistics against the reference's ``"pallas"``
engine under the same explicit plans (``plan_from_key``), tiled and
row-only, batched and ragged; ``compile(E.gdt)`` on both engines, the
raster schedule, the λ = 0 Chebyshev bridge to the QDT and both
segmentation composites against the reference.  Everything is compared
with ``array_equal``, never a tolerance.  Tiny shapes; the port runs on
the CPU (``device="cpu"``), where the kernel wrappers take their plain
versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as RA
import repro_torch.api as TA
from repro.core.chain import ChainPlan
from repro.gdt import seg_hmin_expr as ref_seg_hmin
from repro.gdt import seg_scribble_expr as ref_seg_scribble
from repro.kernels import gdt_chain as RG
from repro_torch import gdt as TGDT
from repro_torch.core.chain import plan_chain, plan_from_key
from repro_torch.gdt.reference import gdt_reference
from repro_torch.kernels import gdt_chain as TG
from repro_torch.kernels import ops as TO

LAMBS = (0.0, 0.37)

# a 3-image stack of 2 bands each, 16-row bands, K = 4, two 128-col tiles
H, W, BAND, K, BPI, TILE = 96, 256, 16, 4, 2, 128

# the composites' and the compile tests' weights (those of tests/test_gdt.py)
LAMB, NU = 0.7, 50.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: under several pytest
    workers on one machine each worker's torch thread pool
    oversubscribes the cores and its threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(ref, port):
    return np.array_equal(np.asarray(ref), port.numpy(), equal_nan=True)


def _planes(rng, shape, dtype=np.float32):
    """Mid-flight kernel planes: d in [0, 20) with +inf, i in [0, 3)
    with NaN, s in [0, 1) with pad cells (−1)."""
    d = (rng.random(shape) * 20).astype(dtype)
    d[rng.random(shape) < 0.05] = np.inf
    i = (rng.random(shape) * 3).astype(dtype)
    i[rng.random(shape) < 0.01] = np.nan
    s = rng.random(shape).astype(dtype)
    s[rng.random(shape) < 0.05] = -1.0
    return d, i, s


def _both_eq(ref, port):
    assert len(ref) == len(port) == 2
    assert [_eq(a, b) for a, b in zip(ref, port)] == [True, True]


@pytest.mark.parametrize("lamb", LAMBS)
def test_gdt_chain_step_plain_matches_pallas(lamb):
    rng = np.random.default_rng(30)
    planes = _planes(rng, (H, W))
    act = np.array([[1], [0], [1], [1], [0], [1]], np.int32)
    args = dict(lamb=lamb, fuse_k=K, band_h=BAND, bands_per_image=BPI)
    ref = RG.gdt_chain_step(*map(jnp.asarray, planes),
                            active=jnp.asarray(act), **args)
    port = TG.gdt_chain_step_plain(*map(_t, planes), active=_t(act), **args)
    _both_eq(ref, port)
    assert port[1].dtype == torch.int32 and port[1].shape == (6, 1)


@pytest.mark.parametrize("lamb", LAMBS)
def test_gdt_tile_step_plain_matches_pallas(lamb):
    rng = np.random.default_rng(31)
    planes = _planes(rng, (H, W))
    grid = (H // BAND, W // TILE)
    act = rng.integers(0, 2, grid).astype(np.int32)
    act[0, 0], act[-1, -1] = 0, 1
    args = dict(lamb=lamb, fuse_k=K, band_h=BAND, tile_w=TILE,
                bands_per_image=BPI)
    ref = RG.gdt_tile_step(*map(jnp.asarray, planes),
                           active=jnp.asarray(act), **args)
    port = TG.gdt_tile_step_plain(*map(_t, planes), active=_t(act), **args)
    _both_eq(ref, port)


@pytest.mark.parametrize("lamb", LAMBS)
def test_gdt_compact_step_plain_matches_pallas(lamb):
    rng = np.random.default_rng(32)
    cap, ph, pw = 4, BAND + 2 * K, TILE + 2 * K
    planes = _planes(rng, (cap * ph, pw))
    valid = np.array([[1], [1], [0], [1]], np.int32)  # slot 2: sentinel
    args = dict(lamb=lamb, fuse_k=K, band_h=BAND, tile_w=TILE)
    ref = RG.gdt_compact_step(*map(jnp.asarray, planes),
                              jnp.asarray(valid), **args)
    port = TG.gdt_compact_step_plain(*map(_t, planes), _t(valid), **args)
    _both_eq(ref, port)
    assert port[1].ravel().tolist()[2] == 0


def _to_fixpoint(step, d):
    """Chunks of ``step`` until the distance plane stops moving."""
    for _ in range(200):
        new = step(d)
        if torch.equal(new, d):
            return d
        d = new
    raise AssertionError("no fixpoint within 200 chunks")


@pytest.mark.parametrize("lamb", (0.0, 0.6))
def test_float64_plain_versions_match_own_oracle(lamb):
    """float64 has no JAX counterpart without x64: each kernel's plain
    version, iterated to its fixpoint on one image, equals the port's
    own float64 NumPy oracle."""
    rng = np.random.default_rng(33)
    img = rng.random((BAND * 3, TILE * 2)) * 3
    seeds = (rng.random(img.shape) < 0.02).astype(np.float64)
    want = gdt_reference(img, seeds, lamb=lamb, nu=NU)
    d0, i, s = TO.gdt_stage(_t(img), _t(seeds), NU)
    assert d0.dtype == torch.float64
    geo = dict(lamb=lamb, fuse_k=K, band_h=BAND)
    got = _to_fixpoint(
        lambda d: TG.gdt_chain_step(d, i, s, **geo)[0], d0)
    assert np.array_equal(got.numpy(), want)
    got = _to_fixpoint(
        lambda d: TG.gdt_tile_step(d, i, s, tile_w=TILE, **geo)[0], d0)
    assert np.array_equal(got.numpy(), want)

    # the whole image as one pre-pinned patch of the compact kernel
    def patch(x, ident):
        return torch.nn.functional.pad(x, (K, K, K, K), value=ident)

    h, w = img.shape
    ip, sp = patch(i, TG.I_IDENT), patch(s, TG.S_IDENT)
    got = _to_fixpoint(lambda d: TG.gdt_compact_step(
        patch(d, TG.D_IDENT), ip, sp, None, lamb=lamb, fuse_k=K, band_h=h,
        tile_w=w)[0], d0)
    assert np.array_equal(got.numpy(), want)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(34)
    d, i, s = map(_t, _planes(rng, (H, W)))
    before = (TG.gdt_chain_step.launches, TG.gdt_tile_step.launches,
              TG.gdt_compact_step.launches)
    args = dict(lamb=0.37, fuse_k=K, band_h=BAND, bands_per_image=BPI)
    got = TG.gdt_chain_step(d, i, s, **args)
    want = TG.gdt_chain_step_plain(
        d, i, s, active=torch.ones((6, 1), dtype=torch.int32), **args)
    assert [_eq(a.numpy(), b) for a, b in zip(got, want)] == [True, True]
    assert TG.gdt_tile_step(d, i, s, tile_w=TILE, **args)[1].shape == (6, 2)
    cap = 2
    win = [x[: cap * (BAND + 2 * K), : TILE + 2 * K].contiguous()
           for x in (d, i, s)]
    got = TG.gdt_compact_step(*win, None, lamb=0.0, fuse_k=K, band_h=BAND,
                              tile_w=TILE)
    assert got[0].shape == (cap * BAND, TILE) and got[1].shape == (cap, 1)
    # the launch counters move only where a CUDA kernel launches
    assert before == (TG.gdt_chain_step.launches, TG.gdt_tile_step.launches,
                      TG.gdt_compact_step.launches)
    with pytest.raises(TypeError, match="float32 or float64"):
        TG.gdt_chain_step(*(x.to(torch.int32) for x in (d, i, s)), **args)
    with pytest.raises(ValueError, match="s: expected"):
        TG.gdt_chain_step(d, i, s.double(), **args)
    with pytest.raises(ValueError, match="tile_w"):
        TG.gdt_tile_step(d, i, s, tile_w=96, **args)


@pytest.mark.parametrize("lamb", (0.37, 1.0))
@pytest.mark.parametrize("dtype", (np.float32, np.float64),
                         ids=lambda d: d.__name__)
def test_gdt_weights_are_symmetric(dtype, lamb):
    """w(p, q) = w(q, p) exactly (NaN where NaN), with NaN, ±inf and
    −0.0 in i: the CUDA kernel computes a weight once for both pixels it
    joins.
    The plane of offset δ holds w(p, p − δ); shifted by δ, the plane of
    −δ holds w(p − δ, p), which must be the same away from the border."""
    rng = np.random.default_rng(41)
    i = rng.random((24, 40)) * 3
    for v, frac in ((np.nan, 0.05), (np.inf, 0.05), (-np.inf, 0.05),
                    (-0.0, 0.05), (0.0, 0.05)):
        i[rng.random(i.shape) < frac] = v
    planes = dict(zip(TG.OFFSETS, TG.gdt_weights(_t(i.astype(dtype)), lamb)))
    for (dy, dx), plane in planes.items():
        mirrored = TG.shift2(planes[(-dy, -dx)], dy, dx, np.nan)
        assert np.array_equal(plane[1:-1, 1:-1].numpy(),
                              mirrored[1:-1, 1:-1].numpy(), equal_nan=True)


# ---------------------------------------------------------------------------
# the scheduler under the reference's plans
# ---------------------------------------------------------------------------


def _ragged():
    """Three 32×64 images that converge after different chunk counts:
    no seed (one chunk), one corner seed (the longest wavefront) and
    many seeds."""
    rng = np.random.default_rng(35)
    img = (rng.random((3, 32, 64)) * 3).astype(np.float32)
    seeds = np.zeros(img.shape, np.float32)
    seeds[1, 0, 0] = 1.0
    seeds[2][rng.random((32, 64)) < 0.05] = 1.0
    return img, seeds


def _padded():
    """Two 28×50 images: the plan pads them, so pad cells sit in the
    grid's cells."""
    rng = np.random.default_rng(36)
    img = (rng.random((2, 28, 50)) * 3).astype(np.float32)
    seeds = (rng.random(img.shape) < 0.03).astype(np.float32)
    return img, seeds


def _one():
    rng = np.random.default_rng(37)
    img = (rng.random((40, 100)) * 3).astype(np.float32)
    seeds = np.zeros(img.shape, np.float32)
    seeds[20, 50] = 1.0
    return img, seeds


# (inputs, lamb, plan): K = 8 plans keep the interpreted Pallas kernels
# fast (the planner's own plans are held by test_compile_gdt_*)
PLANES = {
    "one-image-rows-l0": (_one, 0.0,
                          ChainPlan(16, 8, 128, 48, 3, 1, n_images=1,
                                    compact_threshold=0.5)),
    "batch-padded-tiled": (_padded, LAMB,
                           ChainPlan(16, 8, 64, 32, 2, 1, n_images=2,
                                     compact_threshold=0.5, tile_w=32)),
    "ragged-tiled": (_ragged, LAMB,
                     ChainPlan(16, 8, 64, 32, 2, 1, n_images=3,
                               compact_threshold=0.5, tile_w=32)),
    "ragged-rows": (_ragged, LAMB,
                    ChainPlan(16, 8, 64, 32, 2, 1, n_images=3,
                              compact_threshold=0.5, tile_w=0)),
}


@pytest.fixture(scope="module")
def pallas_runs():
    """The reference's ``"pallas"`` engine on each case, run once:
    interpret mode takes seconds per run."""
    cache = {}

    def get(case):
        if case not in cache:
            make, lamb, plan = PLANES[case]
            img, seeds = make()
            exe = RA.compile(
                RA.E.gdt(RA.E.input("image"), RA.E.input("seeds"),
                         lamb=lamb, nu=NU),
                img.shape, img.dtype, "pallas", plan=plan)
            (d,), conv, busy, cap = exe.run_batch_stats(
                jnp.asarray(img), jnp.asarray(seeds))
            cache[case] = (exe, np.asarray(d), np.asarray(conv).tolist(),
                           int(busy), int(cap))
        return cache[case]

    return get


@pytest.mark.parametrize("case", PLANES)
def test_gdt_and_stats_match_pallas(case, pallas_runs, monkeypatch):
    make, lamb, plan = PLANES[case]
    img, seeds = make()
    ref_exe, ref_d, ref_conv, ref_busy, ref_cap = pallas_runs(case)
    assert np.array_equal(ref_d, np.stack(
        [gdt_reference(a, b, lamb=lamb, nu=NU) for a, b in
         zip(img.reshape(-1, *img.shape[-2:]),
             seeds.reshape(-1, *img.shape[-2:]))]).reshape(img.shape))

    compact = []
    step = TO.gdt_compact_step
    monkeypatch.setattr(TO, "gdt_compact_step",
                        lambda *a, **k: compact.append(1) or step(*a, **k))
    port_plan = plan_from_key(plan.key)
    d = TO.gdt(_t(img), _t(seeds), lamb=lamb, nu=NU, plan=port_plan,
               device="cpu")
    assert d.dtype == torch.float32 and _eq(ref_d, d)
    exe = TA.compile(TA.E.gdt(TA.E.input("image"), TA.E.input("seeds"),
                              lamb=lamb, nu=NU),
                     img.shape, img.dtype, plan=port_plan, device="cpu")
    assert [p.key for p in exe.all_plans] == [
        p.key for p in ref_exe.all_plans]
    (d2,), conv, busy, cap = exe.run_batch_stats(_t(img), _t(seeds))
    assert torch.equal(d2, d)
    assert conv.tolist() == ref_conv
    assert (busy, cap) == (ref_busy, ref_cap)
    if case.startswith("ragged"):
        # the seedless image stopped early, and the sparse tail ran on
        # the compact workspace
        assert busy < cap and compact


def test_gdt_budget_truncation_is_reported():
    img, seeds = _ragged()
    plan = plan_from_key(PLANES["ragged-tiled"][2].key)
    exe = TA.compile(TA.E.gdt(TA.E.input("image"), TA.E.input("seeds")),
                     img.shape, np.float32, plan=plan, max_chunks=1,
                     device="cpu")
    _, conv, busy, cap = exe.run_batch_stats(_t(img), _t(seeds))
    assert conv.tolist() == [True, False, False] and busy == cap == 3
    assert exe.stats()["chunk_budget_rec"] == 1


# ---------------------------------------------------------------------------
# compile, the raster schedule, the QDT bridge and the composites
# ---------------------------------------------------------------------------


def _case(rng, shape, dtype, density=0.05):
    """A float image in [0, 3] and a sparse seed plane with one hard
    seed in the middle (as tests/test_gdt.py makes them)."""
    img = (rng.random(shape) * 3.0).astype(dtype)
    seeds = (rng.random(shape) < density).astype(dtype)
    seeds[tuple(d // 2 for d in shape)] = 1.0
    return img, seeds


def _expr(api, lamb=LAMB):
    return api.E.gdt(api.E.input("image"), api.E.input("seeds"), lamb=lamb,
                     nu=NU)


def _oracle(img, seeds, lamb=LAMB):
    """The port's NumPy oracle, image by image."""
    flat = zip(img.reshape(-1, *img.shape[-2:]),
               seeds.reshape(-1, *img.shape[-2:]))
    return np.stack([gdt_reference(a, b, lamb=lamb, nu=NU)
                     for a, b in flat]).reshape(img.shape)


SHAPES = {"2d-float32": ((29, 23), np.float32),
          "3d-float32": ((3, 24, 20), np.float32),
          "2d-float64": ((29, 23), np.float64)}


@pytest.mark.parametrize("shape", SHAPES)
def test_compile_gdt_matches_reference(shape):
    shp, dtype = SHAPES[shape]
    img, seeds = _case(np.random.default_rng(38), shp, dtype)
    want = _oracle(img, seeds)
    if dtype == np.float32:
        ref = RA.compile(_expr(RA), shp, dtype, "xla")(img, seeds)
        assert np.array_equal(np.asarray(ref), want)
    for backend in ("cuda", "torch"):
        out = TA.compile(_expr(TA), shp, dtype, backend,
                         device="cpu")(_t(img), _t(seeds))
        assert out.dtype == torch.from_numpy(img).dtype
        assert np.array_equal(out.numpy(), want), backend
    stats = TA.compile(_expr(TA), shp, dtype, device="cpu").stats()
    ref_stats = RA.compile(_expr(RA), shp, np.float32, "pallas").stats()
    ref_stats.pop("backend")
    assert stats.pop("backend") == "cuda"
    assert stats == ref_stats


def test_gdt_after_a_fixed_chain_rebands_like_the_reference():
    """A fixed chain feeding the gdt is specialized into two plan groups,
    re-banded between them; the gdt's operands re-enter padded form with
    the −inf fill its staging reads as the pad marker."""
    img, seeds = _case(np.random.default_rng(42), (2, 30, 40), np.float32)

    def expr(api):
        return api.E.gdt(api.E.dilate(2, api.E.input("image")),
                         api.E.input("seeds"), lamb=LAMB, nu=NU)

    want = RA.compile(expr(RA), img.shape, np.float32, "xla")(img, seeds)
    ref_exe = RA.compile(expr(RA), img.shape, np.float32, "pallas")
    exe = TA.compile(expr(TA), img.shape, np.float32, device="cpu")
    assert np.array_equal(exe(_t(img), _t(seeds)).numpy(), np.asarray(want))
    assert [p.key for p in exe.all_plans] == [
        p.key for p in ref_exe.all_plans]
    stats, ref_stats = exe.stats(), ref_exe.stats()
    assert stats["rebands"] == 1
    assert stats.pop("backend") == "cuda" and ref_stats.pop("backend")
    assert stats == ref_stats


@pytest.mark.parametrize("dtype", (np.float32, np.float64),
                         ids=lambda d: d.__name__)
def test_raster_schedule_matches_wavefront(dtype):
    img, seeds = _case(np.random.default_rng(39), (2, 33, 27), dtype)
    wave = TGDT.gdt(_t(img), _t(seeds), lamb=LAMB, nu=NU, device="cpu")
    plan = plan_chain(33, 27, dtype, None, n_images_resident=3, n_images=2,
                      convergent=True, schedule="raster")
    exe = TA.compile(_expr(TA), img.shape, dtype, plan=plan, device="cpu")
    (raster,), conv, busy, cap = exe.run_batch_stats(_t(img), _t(seeds))
    assert torch.equal(raster, wave)
    assert np.array_equal(raster.numpy(), _oracle(img, seeds))
    assert conv.tolist() == [True, True] and busy == cap > 0


def test_lambda_zero_is_the_binary_qdt_bridge():
    """λ = 0 makes every weight exactly 1, so the gdt from the background
    of a binary image is the Chebyshev distance — the erosion counts of
    the port's binary QDT d-plane (mirrors tests/test_gdt.py)."""
    rng = np.random.default_rng(0)
    binary = (rng.random((18, 14)) < 0.6).astype(np.uint8) * 255
    f = binary.astype(np.float32)
    seeds = (binary == 0).astype(np.float32)
    assert seeds.any() and (binary > 0).any()
    nu = float(sum(binary.shape))
    out = TO.gdt(_t(f), _t(seeds), lamb=0.0, nu=nu, device="cpu").numpy()
    ys, xs = np.nonzero(seeds)
    ii, jj = np.mgrid[:binary.shape[0], :binary.shape[1]]
    cheb = np.min(np.maximum(np.abs(ii[..., None] - ys),
                             np.abs(jj[..., None] - xs)), axis=-1)
    assert np.array_equal(out, cheb.astype(np.float32))
    d = TO.qdt_planes(_t(binary), device="cpu")[0].numpy()
    assert np.array_equal(out.astype(np.int64), d.astype(np.int64))


def _scribbles(rng, shape):
    scrib = np.zeros(shape, np.float32)
    scrib[rng.random(shape) < 0.03] = 1.0
    scrib[(rng.random(shape) < 0.03) & (scrib == 0)] = 2.0
    scrib[3, 3], scrib[20, 18] = 1.0, 2.0
    return scrib


@pytest.mark.parametrize("backend", ("cuda", "torch"))
def test_seg_scribble_matches_reference(backend):
    rng = np.random.default_rng(40)
    img, _ = _case(rng, (26, 22), np.float32)
    scrib = _scribbles(rng, img.shape)
    want = np.asarray(RA.compile(ref_seg_scribble(lamb=LAMB, nu=NU),
                                 img.shape, np.float32, "xla")(img, scrib))
    d_fg = gdt_reference(img, (scrib == 1.0).astype(np.float32), lamb=LAMB,
                         nu=NU)
    d_bg = gdt_reference(img, (scrib == 2.0).astype(np.float32), lamb=LAMB,
                         nu=NU)
    assert np.array_equal(want, (d_bg - d_fg >= 0).astype(np.float32))
    exe = TA.compile(TGDT.seg_scribble_expr(lamb=LAMB, nu=NU), img.shape,
                     np.float32, backend, device="cpu")
    assert np.array_equal(exe(_t(img), _t(scrib)).numpy(), want)


@pytest.mark.parametrize("backend", ("cuda", "torch"))
def test_seg_hmin_matches_reference(backend):
    """h-minima seeding crosses a reconstruction → point bridge → gdt
    chain inside one program."""
    h = 0.75
    img, _ = _case(np.random.default_rng(41), (24, 20), np.float32)
    expr = TGDT.seg_hmin_expr(h, lamb=LAMB, nu=NU)
    kinds = [s.kind for s in TA.lower(expr).segments]
    assert "point" in kinds and kinds[-1] == "gdt"
    want = np.asarray(RA.compile(ref_seg_hmin(h, lamb=LAMB, nu=NU),
                                 img.shape, np.float32, "xla")(img))
    out = TA.compile(expr, img.shape, np.float32, backend,
                     device="cpu")(_t(img))
    assert np.array_equal(out.numpy(), want)


def test_gdt_guards():
    f, s = TA.E.input("f"), TA.E.input("s")
    with pytest.raises(ValueError, match="lamb"):
        TA.E.gdt(f, s, lamb=-1.0)
    with pytest.raises(ValueError, match="nu"):
        TA.E.gdt(f, s, nu=0.0)
    with pytest.raises(TypeError, match="float dtype"):
        TGDT.gdt(np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.uint8),
                 device="cpu")
    with pytest.raises(ValueError, match="shape"):
        TO.gdt(np.zeros((8, 8), np.float32), np.zeros((8, 9), np.float32),
               device="cpu")
    with pytest.raises(TypeError, match="float dtype"):
        TA.compile(TA.E.gdt(f, s), (16, 16), np.uint8, device="cpu")
    with pytest.raises(ValueError, match="h="):
        TGDT.seg_hmin_expr(0.0)
    assert TGDT.gdt_expr(f, s) == TA.E.gdt(f, s, lamb=1.0, nu=1e6)
