"""The port on an NVIDIA GPU: each CUDA kernel against its plain PyTorch
version on the card, and ``compile()``'s ``"cuda"`` engine against its
``"torch"`` engine.  Every test is marked ``cuda`` and skips without a
GPU; the file imports neither jax nor the reference, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import compile, hmax_expr
from repro_torch.data.images import blobs
from repro_torch.kernels import erode_chain as TE
from repro_torch.kernels import geodesic_chain as TG

pytestmark = pytest.mark.cuda

CASES = [(np.uint8, "erode"), (np.uint16, "dilate"), (np.float32, "erode"),
         (np.float64, "dilate")]
IDS = [f"{d.__name__}-{op}" for d, op in CASES]

# a 3-image stack of 2 bands each, 48-row bands, K = 16, 160-col tiles:
# cells larger than, and not multiples of, a block's sub-tile
H, W, BAND, K, BPI, TILE = 288, 480, 48, 16, 2, 160


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(rng, shape, dtype):
    if np.issubdtype(dtype, np.floating):
        x = rng.standard_normal(shape).astype(dtype)
        x[rng.random(shape) < 0.01] = np.nan
        return x
    return rng.integers(0, np.iinfo(dtype).max, shape,
                        endpoint=True).astype(dtype)


def _same(got, want):
    return np.array_equal(got.cpu().numpy(), want.cpu().numpy(),
                          equal_nan=True)


@pytest.mark.parametrize("dtype,op", CASES, ids=IDS)
def test_kernels_match_plain_versions(cuda, dtype, op):
    rng = np.random.default_rng(5)
    f = torch.from_numpy(_rand(rng, (H, W), dtype)).to(cuda)
    m = torch.from_numpy(_rand(rng, (H, W), dtype)).to(cuda)
    geo = dict(op=op, fuse_k=K, band_h=BAND, bands_per_image=BPI)
    assert _same(TE.chain_step(f, **geo), TE.chain_step_plain(f, **geo))
    act = torch.from_numpy(rng.integers(0, 2, (H // BAND, 1),
                                        dtype=np.int32)).to(cuda)
    for got, want in zip(
            TG.geodesic_chain_step(f, m, active=act, **geo),
            TG.geodesic_chain_step_plain(f, m, active=act, **geo)):
        assert _same(got, want)
    act = torch.from_numpy(rng.integers(0, 2, (H // BAND, W // TILE),
                                        dtype=np.int32)).to(cuda)
    for got, want in zip(
            TG.geodesic_tile_step(f, m, tile_w=TILE, active=act, **geo),
            TG.geodesic_tile_step_plain(f, m, tile_w=TILE, active=act,
                                        **geo)):
        assert _same(got, want)
    cap = 3
    fp = f[: cap * (BAND + 2 * K), : TILE + 2 * K].contiguous()
    mp = m[: cap * (BAND + 2 * K), : TILE + 2 * K].contiguous()
    valid = torch.tensor([[1], [0], [1]], dtype=torch.int32, device=cuda)
    cargs = dict(op=op, fuse_k=K, band_h=BAND, tile_w=TILE)
    for got, want in zip(
            TG.geodesic_compact_step(fp, mp, valid, **cargs),
            TG.geodesic_compact_step_plain(fp, mp, valid, **cargs)):
        assert _same(got, want)


def test_launch_errors_raise(cuda):
    x = torch.zeros((256, 512), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        # no sub-tile with a 256-pixel halo fits shared memory
        TE.chain_step(x, op="erode", fuse_k=256, band_h=256)
    with pytest.raises(TypeError, match="CUDA kernels take"):
        TE.chain_step(x.to(torch.int16), op="erode", fuse_k=8, band_h=64)
    with pytest.raises(ValueError, match="contiguous"):
        TE.chain_step(x.t(), op="erode", fuse_k=8, band_h=64)


@pytest.mark.parametrize("dtype", (np.uint8, np.float32))
def test_compile_cuda_engine_matches_torch_engine(cuda, dtype):
    f = np.stack([blobs(200, 300, dtype, seed=s) for s in range(3)])
    x = torch.from_numpy(f).to(cuda)
    h = 40 if dtype == np.uint8 else 0.15
    before = TG.geodesic_tile_step.launches
    got = compile(hmax_expr(h), x.shape, x.dtype)(x)
    want = compile(hmax_expr(h), x.shape, x.dtype, "torch")(x)
    assert got.device.type == "cuda" and _same(got, want)
    assert TG.geodesic_tile_step.launches > before
