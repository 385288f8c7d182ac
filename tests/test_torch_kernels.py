"""Each kernel's plain PyTorch version against the reference's Pallas
kernel (interpret mode on the CPU), on the same seeded inputs, with
activity grids, sentinel slots and stacked images (``bands_per_image``);
and the wrappers' dispatch on CPU tensors.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as RC
from repro.kernels import erode_chain as RE
from repro.kernels import geodesic_chain as RG
from repro_torch.kernels import _build
from repro_torch.kernels import common as TC
from repro_torch.kernels import erode_chain as TE
from repro_torch.kernels import geodesic_chain as TG
from repro_torch.kernels import ref as TR

CASES = [(np.uint8, "erode"), (np.uint8, "dilate"), (np.uint16, "erode"),
         (np.uint16, "dilate"), (np.float32, "erode"),
         (np.float32, "dilate")]
IDS = [f"{d.__name__}-{op}" for d, op in CASES]

# a 3-image stack of 2 bands each, 16-row bands, K = 4, two 128-col tiles
# (the interpreted Pallas kernel's cost grows with K)
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


def _rand(rng, shape, dtype, nan=False):
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal(shape).astype(dtype)
        if nan:
            x[rng.random(shape) < 0.01] = np.nan
        return x
    return rng.integers(0, np.iinfo(dtype).max, shape,
                        endpoint=True).astype(dtype)


def _eq(ref, port):
    return np.array_equal(np.asarray(ref), port.numpy(), equal_nan=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype,op", CASES, ids=IDS)
def test_chain_step_plain_matches_pallas(dtype, op):
    x = _rand(np.random.default_rng(0), (H, W), dtype, nan=True)
    ref = RE.chain_step(jnp.asarray(x), op=op, fuse_k=K, band_h=BAND,
                        bands_per_image=BPI)
    port = TE.chain_step_plain(_t(x), op=op, fuse_k=K, band_h=BAND,
                               bands_per_image=BPI)
    assert _eq(ref, port)


@pytest.mark.parametrize("dtype,op", CASES, ids=IDS)
def test_geodesic_chain_step_plain_matches_pallas(dtype, op):
    rng = np.random.default_rng(1)
    f, m = _rand(rng, (H, W), dtype, True), _rand(rng, (H, W), dtype, True)
    act = np.array([[1], [0], [1], [1], [0], [1]], np.int32)
    rf, rc = RG.geodesic_chain_step(
        jnp.asarray(f), jnp.asarray(m), op=op, fuse_k=K, band_h=BAND,
        active=jnp.asarray(act), bands_per_image=BPI)
    pf, pc = TG.geodesic_chain_step_plain(
        _t(f), _t(m), op=op, fuse_k=K, band_h=BAND, active=_t(act),
        bands_per_image=BPI)
    assert _eq(rf, pf) and _eq(rc, pc)
    assert pc.dtype == torch.int32 and pc.shape == (6, 1)


@pytest.mark.parametrize("dtype,op", CASES, ids=IDS)
def test_geodesic_tile_step_plain_matches_pallas(dtype, op):
    rng = np.random.default_rng(2)
    f, m = _rand(rng, (H, W), dtype, True), _rand(rng, (H, W), dtype, True)
    act = rng.integers(0, 2, (H // BAND, W // TILE)).astype(np.int32)
    rf, rc = RG.geodesic_tile_step(
        jnp.asarray(f), jnp.asarray(m), op=op, fuse_k=K, band_h=BAND,
        tile_w=TILE, active=jnp.asarray(act), bands_per_image=BPI)
    pf, pc = TG.geodesic_tile_step_plain(
        _t(f), _t(m), op=op, fuse_k=K, band_h=BAND, tile_w=TILE,
        active=_t(act), bands_per_image=BPI)
    assert _eq(rf, pf) and _eq(rc, pc)


@pytest.mark.parametrize("dtype,op", CASES, ids=IDS)
def test_geodesic_compact_step_plain_matches_pallas(dtype, op):
    rng = np.random.default_rng(3)
    cap, ph, pw = 4, BAND + 2 * K, TILE + 2 * K
    fp = _rand(rng, (cap * ph, pw), dtype, True)
    mp = _rand(rng, (cap * ph, pw), dtype, True)
    valid = np.array([[1], [1], [0], [1]], np.int32)
    rf, rc = RG.geodesic_compact_step(
        jnp.asarray(fp), jnp.asarray(mp), jnp.asarray(valid), op=op,
        fuse_k=K, band_h=BAND, tile_w=TILE)
    pf, pc = TG.geodesic_compact_step_plain(
        _t(fp), _t(mp), _t(valid), op=op, fuse_k=K, band_h=BAND,
        tile_w=TILE)
    assert _eq(rf, pf) and _eq(rc, pc)


@pytest.mark.parametrize("op", ("erode", "dilate"))
def test_plain_versions_on_one_image_equal_the_oracles(op):
    """On a single image (every band one image's) one chunk of K steps
    is the K-step oracle: the halo pinning is the border clipping."""
    rng = np.random.default_rng(6)
    f = _t(_rand(rng, (H, W), np.float32))
    m = _t(_rand(rng, (H, W), np.float32))
    m = torch.maximum(f, m) if op == "dilate" else torch.minimum(f, m)
    geo = dict(op=op, fuse_k=K, band_h=BAND)
    assert torch.equal(TE.chain_step_plain(f, **geo), TR.chain(f, K, op))
    got, changed = TG.geodesic_chain_step_plain(f, m, **geo)
    assert torch.equal(got, TR.geodesic_chain(f, m, K, op))
    assert changed.all()


@pytest.mark.parametrize("dtype", (np.uint8, np.uint16, np.float32),
                         ids=lambda d: d.__name__)
def test_identities_and_accumulator_dtypes_match_reference(dtype):
    td = torch.from_numpy(np.zeros(1, dtype)).dtype
    for op in ("erode", "dilate"):
        assert TC.ident_for(op, td) == RC.ident_for(op, dtype).item()
    acc = torch.zeros(1, dtype=TC.qdt_acc_dtype(td)).numpy().dtype
    assert acc == np.dtype(RC.qdt_acc_dtype(dtype))


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(4)
    f = _t(_rand(rng, (H, W), np.uint8))
    m = _t(_rand(rng, (H, W), np.uint8))
    before = (TE.chain_step.launches, TG.geodesic_chain_step.launches,
              TG.geodesic_tile_step.launches,
              TG.geodesic_compact_step.launches)
    geo = dict(op="dilate", fuse_k=K, band_h=BAND, bands_per_image=BPI)
    assert torch.equal(TE.chain_step(f, **geo),
                       TE.chain_step_plain(f, **geo))
    for got, want in zip(TG.geodesic_chain_step(f, m, **geo),
                         TG.geodesic_chain_step_plain(f, m, **geo)):
        assert torch.equal(got, want)
    for got, want in zip(
            TG.geodesic_tile_step(f, m, tile_w=TILE, **geo),
            TG.geodesic_tile_step_plain(f, m, tile_w=TILE, **geo)):
        assert torch.equal(got, want)
    patches = f[: 2 * (BAND + 2 * K), : TILE + 2 * K].contiguous()
    cargs = dict(op="erode", fuse_k=K, band_h=BAND, tile_w=TILE)
    for got, want in zip(
            TG.geodesic_compact_step(patches, patches, None, **cargs),
            TG.geodesic_compact_step_plain(
                patches, patches, torch.ones((2, 1), dtype=torch.int32),
                **cargs)):
        assert torch.equal(got, want)
    # the launch counters move only where a CUDA kernel launches
    assert before == (TE.chain_step.launches,
                      TG.geodesic_chain_step.launches,
                      TG.geodesic_tile_step.launches,
                      TG.geodesic_compact_step.launches)


def test_wrappers_reject_bad_grids_and_flags():
    x = torch.zeros((H, W), dtype=torch.uint8)
    with pytest.raises(ValueError, match="band_h"):
        TE.chain_step(x, op="erode", fuse_k=K, band_h=20)
    with pytest.raises(ValueError, match="op must be"):
        TE.chain_step(x, op="open", fuse_k=K, band_h=BAND)
    with pytest.raises(ValueError, match="bands"):
        TE.chain_step(x, op="erode", fuse_k=K, band_h=BAND,
                      bands_per_image=4)
    with pytest.raises(ValueError, match="int32"):
        TG.geodesic_tile_step(x, x, op="erode", fuse_k=K, band_h=BAND,
                              tile_w=TILE,
                              active=torch.ones((6, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="tile_w"):
        TG.geodesic_tile_step(x, x, op="erode", fuse_k=K, band_h=BAND,
                              tile_w=96)
    with pytest.raises(ValueError, match="must agree"):
        TG.geodesic_chain_step(x, x.float(), op="erode", fuse_k=K,
                               band_h=BAND)


def test_build_is_lazy_and_named_by_source_hash():
    # importing the wrappers built nothing; the library name is a
    # function of the source text and the flags, under build/
    path = _build.library_path("morph_chain.cu")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("morph_chain_") and path.suffix == ".so"
    assert path == _build.library_path("morph_chain.cu")
    assert not _build._libs
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.dtype_code(torch.float32) == 3
    with pytest.raises(TypeError, match="CUDA kernels take"):
        _build.dtype_code(torch.bfloat16)
