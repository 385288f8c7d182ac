"""The port on an NVIDIA GPU: each CUDA kernel against its plain PyTorch
version on the card, ``compile()``'s ``"cuda"`` engine against its
``"torch"`` engine, and a stream served by ``repro_torch.serve``.
Every test is marked ``cuda`` and skips without a GPU; the file imports
neither jax nor the reference, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.api import E, compile, hmax_expr, qdt_l1_expr
from repro_torch.data.images import blobs
from repro_torch.gdt import seg_scribble_expr
from repro_torch.kernels import erode_chain as TE
from repro_torch.kernels import gdt_chain as TD
from repro_torch.kernels import geodesic_chain as TG
from repro_torch.kernels import qdt_chain as TQ
from repro_torch.kernels.common import qdt_acc_dtype

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
        # no block shape covers a 256-pixel halo
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


QDT_DTYPES = (np.uint8, np.uint16, np.int32, np.float32, np.float64)


def _qdt_image(rng, shape, dtype):
    """Float NaN and the int32 extremes, where the residual wraps."""
    if dtype == np.int32:
        x = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
        x[rng.random(shape) < 0.05] = 2**31 - 1
        x[rng.random(shape) < 0.05] = -2**31
        return x.astype(np.int32)
    return _rand(rng, shape, dtype)


#: (h, w, band, K, bands per image, tile): K = 1, an odd K with bands off
#: a strip's 16 rows, tiles and patches whose width and window origin are
#: not multiples of 4 (the uint8 body's packed words), cells narrower than
#: a warp, and K = 32 at the main path's 64x128 cell; their r planes span
#: the int32 range (the uint8 body clamps r to [-1, 255]).
QDT_EDGE_GRIDS = [(10, 40, 5, 1, 2, 8), (63, 84, 21, 7, 3, 28),
                  (28, 42, 14, 7, 2, 14), (192, 96, 48, 16, 2, 32),
                  (128, 256, 64, 32, 2, 128)]


def _qdt_r(rng, shape, acc, wide):
    """r in [0, 90), or over the int32 range with -1, 256 and the
    extremes in place."""
    if not wide:
        return torch.from_numpy(rng.integers(0, 90, shape)).to(acc)
    r = rng.integers(-2**31, 2**31, shape)
    near = rng.random(shape) < 0.5
    r[near] = rng.integers(-2, 258, int(near.sum()))
    r.flat[:4] = (-2**31, 2**31 - 1, -1, 256)
    return torch.from_numpy(r).to(acc)


def _check_qdt(cuda, rng, dtype, h, w, band, k, bpi, tile, wide):
    f = torch.from_numpy(_qdt_image(rng, (h, w), dtype)).to(cuda)
    acc = qdt_acc_dtype(f.dtype)
    r = _qdt_r(rng, (h, w), acc, wide).to(cuda)
    d = torch.from_numpy(rng.integers(0, 50, (h, w), dtype=np.int32)).to(
        cuda)

    def grid(shape, hi):
        return torch.from_numpy(rng.integers(0, hi, shape,
                                             dtype=np.int32)).to(cuda)

    geo = dict(fuse_k=k, band_h=band, bands_per_image=bpi)
    rows, tiles = (h // band, 1), (h // band, w // tile)
    base, act = grid(rows, 99), grid(rows, 2)
    for got, want in zip(
            TQ.qdt_chain_step(f, r, d, base, active=act, **geo),
            TQ.qdt_chain_step_plain(f, r, d, base, active=act, **geo)):
        assert _same(got, want)
    base, act = grid(tiles, 99), grid(tiles, 2)
    for got, want in zip(
            TQ.qdt_tile_step(f, r, d, base, tile_w=tile, active=act, **geo),
            TQ.qdt_tile_step_plain(f, r, d, base, tile_w=tile, active=act,
                                   **geo)):
        assert _same(got, want)
    cap = 3
    ph, pw = band + 2 * k, tile + 2 * k
    fp = torch.from_numpy(_qdt_image(rng, (cap * ph, pw), dtype)).to(cuda)
    rm = _qdt_r(rng, (cap * band, tile), acc, wide).to(cuda)
    dm = grid((cap * band, tile), 50)
    valid = torch.tensor([[1], [0], [1]], dtype=torch.int32, device=cuda)
    base = torch.tensor([[4], [9], [31]], dtype=torch.int32, device=cuda)
    cargs = dict(fuse_k=k, band_h=band, tile_w=tile)
    for got, want in zip(
            TQ.qdt_compact_step(fp, rm, dm, valid, base, **cargs),
            TQ.qdt_compact_step_plain(fp, rm, dm, valid, base, **cargs)):
        assert _same(got, want)


@pytest.mark.parametrize("dtype", QDT_DTYPES, ids=lambda d: d.__name__)
def test_qdt_kernels_match_plain_versions(cuda, dtype):
    rng = np.random.default_rng(6)
    _check_qdt(cuda, rng, dtype, H, W, BAND, K, BPI, TILE, wide=False)
    for g in QDT_EDGE_GRIDS:
        _check_qdt(cuda, rng, dtype, *g, wide=True)


@pytest.mark.parametrize("expr", ("qdt", "qdt_l1"))
def test_compile_qdt_cuda_engine_matches_torch_engine(cuda, expr):
    f = np.stack([blobs(200, 300, np.uint8, seed=s) for s in range(3)])
    x = torch.from_numpy(f).to(cuda)
    e = E.qdt(E.input("f")) if expr == "qdt" else qdt_l1_expr()
    before = TQ.qdt_tile_step.launches
    got = compile(e, x.shape, x.dtype)(x)
    want = compile(e, x.shape, x.dtype, "torch")(x)
    got, want = (got, want) if expr == "qdt" else ((got,), (want,))
    assert all(g.device.type == "cuda" and _same(g, w)
               for g, w in zip(got, want, strict=True))
    assert TQ.qdt_tile_step.launches > before


# (rows, width, band_h, bands_per_image, tile_w, K, framed): the grid of
# the other kernels, then where the gdt body's thread strips can go
# wrong — K = 1, an odd K with bands off a strip's 16 rows, cells
# narrower than a warp's 32 columns, K = 32 beyond the register-weight
# instance — with +inf in d and NaN in i on the window borders
GDT_GRIDS = [(H, W, BAND, BPI, TILE, K, False), (10, 40, 5, 2, 8, 1, True),
             (63, 84, 21, 3, 28, 7, True), (192, 96, 48, 2, 32, 16, True),
             (128, 192, 64, 2, 64, 32, True)]


@pytest.mark.parametrize("grid", GDT_GRIDS,
                         ids=lambda g: "h{}-w{}-band{}-tile{}-k{}".format(
                             g[0], g[1], g[2], g[4], g[5]))
@pytest.mark.parametrize("lamb", (0.0, 0.37))
@pytest.mark.parametrize("dtype", (np.float32, np.float64),
                         ids=lambda d: d.__name__)
def test_gdt_kernels_match_plain_versions(cuda, dtype, lamb, grid):
    """+inf in d, NaN in i (uniform in [0, 3], where a fused
    multiply-add would show), pad cells (s = -1) inside the image; on a
    framed grid NaN in i only on the frame of every image and patch."""
    h, w, band, bpi, tile, k, framed = grid
    rng = np.random.default_rng(7)

    def planes(shape, period):
        d = rng.random(shape) * 20
        d[rng.random(shape) < 0.05] = np.inf
        i = rng.random(shape) * 3
        i[rng.random(shape) < (0.0 if framed else 0.01)] = np.nan
        s = rng.random(shape)
        s[rng.random(shape) < 0.05] = -1.0
        if framed:
            rows = np.arange(shape[0]) % period
            for x, v in ((d, np.inf), (i, np.nan)):
                x[(rows == 0) | (rows == period - 1)] = v
                x[:, [0, -1]] = v
        return [torch.from_numpy(x.astype(dtype)).to(cuda) for x in (d, i, s)]

    def grid_of(shape):
        return torch.from_numpy(rng.integers(0, 2, shape,
                                             dtype=np.int32)).to(cuda)

    d, i, s = planes((h, w), bpi * band)
    geo = dict(lamb=lamb, fuse_k=k, band_h=band, bands_per_image=bpi)
    act = grid_of((h // band, 1))
    for got, want in zip(
            TD.gdt_chain_step(d, i, s, active=act, **geo),
            TD.gdt_chain_step_plain(d, i, s, active=act, **geo)):
        assert _same(got, want)
    act = grid_of((h // band, w // tile))
    for got, want in zip(
            TD.gdt_tile_step(d, i, s, tile_w=tile, active=act, **geo),
            TD.gdt_tile_step_plain(d, i, s, tile_w=tile, active=act, **geo)):
        assert _same(got, want)
    cap = 3
    ph = band + 2 * k
    win = planes((cap * ph, tile + 2 * k), ph)
    valid = torch.tensor([[1], [0], [1]], dtype=torch.int32, device=cuda)
    cargs = dict(lamb=lamb, fuse_k=k, band_h=band, tile_w=tile)
    for got, want in zip(
            TD.gdt_compact_step(*win, valid, **cargs),
            TD.gdt_compact_step_plain(*win, valid, **cargs)):
        assert _same(got, want)


@pytest.mark.parametrize("expr", ("gdt", "seg_scribble"))
def test_compile_gdt_cuda_engine_matches_torch_engine(cuda, expr):
    f = np.stack([blobs(200, 300, np.float32, seed=s) for s in range(3)])
    rng = np.random.default_rng(8)
    marks = np.zeros(f.shape, np.float32)
    marks[rng.random(f.shape) < 2e-4] = 1.0
    if expr == "seg_scribble":
        marks[:, 0, :] = marks[:, -1, :] = 2.0
        e = seg_scribble_expr()
    else:
        e = E.gdt(E.input("image"), E.input("seeds"))
    x, m = torch.from_numpy(f).to(cuda), torch.from_numpy(marks).to(cuda)
    before = TD.gdt_tile_step.launches
    got = compile(e, x.shape, x.dtype)(x, m)
    want = compile(e, x.shape, x.dtype, "torch")(x, m)
    assert got.device.type == "cuda" and _same(got, want)
    assert TD.gdt_tile_step.launches > before


def test_served_stream_on_the_card(cuda):
    """A small mixed stream through ``repro_torch.serve.Service`` on the
    GPU at pipeline depths 1 and 2: every ticket ``ok``, every value on
    the card, equal across depths and to the ``"torch"`` engine on the
    unpadded frame."""
    from repro_torch.core import operators as OPS
    from repro_torch.serve import Service

    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 255, (96 - 8 * i, 96)).astype(np.uint8)
              for i in range(4)]
    mix = (("hmax", {"h": 40}), ("erode", {"s": 16}), ("qdt_l1", {}))
    results = []
    for depth in (1, 2):
        svc = Service(max_batch=2, max_delay_ms=1e9, pad_quantum=64,
                      pipeline_depth=depth)
        tickets = [svc.submit(op, f, params=p) for f in frames
                   for op, p in mix]
        svc.flush()
        assert all(t.outcome == "ok" for t in tickets)
        results.append([t.result() for t in tickets])
    for a, b in zip(*results):
        assert a.device.type == "cuda" and torch.equal(a, b)
    for f, (hm, er, q) in zip(frames, zip(*[iter(results[1])] * 3)):
        x = torch.from_numpy(f).to(cuda)
        assert torch.equal(hm, OPS.hmax(x, 40, backend="torch",
                                        device=cuda))
        assert torch.equal(er, compile(E.erode(16, E.input("f")), x.shape,
                                       x.dtype, "torch", device=cuda)(x))
        assert torch.equal(q, compile(qdt_l1_expr(), x.shape, x.dtype,
                                      "torch", device=cuda)(x))


def _slot_requests(kind, rng):
    """Canonical requests of one bucket: the first a slow one."""
    if kind == "reconstruct":
        reqs = []
        for i in range(5):
            f = blobs(128, 160, np.float32, seed=i)
            m = np.where(f > 0.3, f - np.float32(0.3), 0).astype(np.float32)
            reqs.append((m, f))
        snake = np.full((128, 160), 0.1, np.float32)
        snake[::2] = 0.9
        snake[1::4, -1] = snake[3::4, 0] = 0.9
        marker = np.zeros_like(snake)
        marker[0, 0] = 0.9
        reqs[0] = (marker, snake)
        return E.reconstruct(E.input("m"), E.input("f"), op="dilate"), reqs
    if kind == "qdt":
        reqs = [(blobs(128, 160, np.uint8, seed=i),) for i in range(5)]
        return E.qdt(E.input("f")), reqs
    img = blobs(128, 160, np.float32, seed=9)
    reqs = []
    for i in range(5):
        seeds = np.zeros(img.shape, np.float32)
        seeds[rng.integers(0, 128), rng.integers(0, 160)] = 1.0
        reqs.append((img, seeds))
    return E.gdt(E.input("image"), E.input("seeds")), reqs


@pytest.mark.parametrize("kind", ("reconstruct", "qdt", "gdt"))
def test_slot_session_on_the_card_equals_the_batch_path(cuda, kind):
    """A slot session on the GPU: requests admitted into slots as they
    free up, in rounds of 2 chunks, equal a solo batch of each request on
    the batch path, and the session's rounds launch the tile kernel."""
    expr, reqs = _slot_requests(kind, np.random.default_rng(4))
    dtype = reqs[0][0].dtype
    exe = compile(expr, (3, 128, 160), dtype)
    assert exe.refillable
    session = exe.slot_session(2)
    tile = {"reconstruct": TG.geodesic_tile_step, "qdt": TQ.qdt_tile_step,
            "gdt": TD.gdt_tile_step}[kind]
    before = tile.launches
    state = session.init()
    queue, slots, got = list(range(len(reqs))), [None] * 3, {}
    for _ in range(10_000):
        for slot in range(3):
            if slots[slot] is None and queue:
                i = queue.pop(0)
                state = session.admit(state, slot, *(
                    torch.from_numpy(x).to(cuda) for x in reqs[i]))
                slots[slot] = i
        if all(s is None for s in slots):
            break
        state, finished, exhausted = session.round(state)
        assert not exhausted.any()
        outs = session.extract(state)
        for slot, i in enumerate(slots):
            if i is not None and finished[slot]:
                got[i] = tuple(o[slot].clone() for o in outs)
                slots[slot] = None
    assert sorted(got) == list(range(len(reqs)))
    assert tile.launches > before
    solo = compile(expr, (1, 128, 160), dtype)
    for i, x in enumerate(reqs):
        want = solo.run_batch(*(torch.from_numpy(a)[None].to(cuda)
                                for a in x))
        for a, b in zip(want, got[i]):
            assert b.device.type == "cuda" and _same(b, a[0])


def test_continuous_service_on_the_card_equals_the_batch_path(cuda):
    """``Service(continuous=True)`` on the GPU: a straggler and fast HMAX
    frames in one bucket — refills happen, every ticket ``ok`` and equal
    to the batch path's value."""
    from repro_torch.serve import Service

    expr, reqs = _slot_requests("reconstruct", np.random.default_rng(5))
    results = {}
    for cont in (False, True):
        svc = Service(continuous=cont, refill_quantum=2, max_batch=2,
                      max_delay_ms=1e9, pad_quantum=64)
        tickets = [svc.submit("reconstruct", m, f) for m, f in reqs]
        svc.flush()
        assert all(t.outcome == "ok" for t in tickets)
        results[cont] = [t.result() for t in tickets]
        if cont:
            assert svc.stats()["counters"]["refills"] > 0
    for a, b in zip(results[False], results[True]):
        assert b.device.type == "cuda" and torch.equal(a, b)


#: launch grids for the geometry exports: (rows, width, band_h, cell_w,
#: bands_per_image) of a stack — narrow tiles (below a warp's 128 packed
#: columns), widths off 128, full-width bands — and compact caps
GEOMETRY_STACKS = [(6, 200, 200, 2), (6, 200, 40, 2), (4, 384, 192, 1),
                   (2, 130, 130, 2)]
GEOMETRY_CAPS = [(5, 40), (3, 200), (1, 128)]


def _geometry_launches(k):
    from repro_torch.analysis import indexmaps as IM

    band_h = k * max(1, 48 // k)
    for kernel, (source, layout, _) in IM.KERNELS.items():
        for dtype in IM.DTYPE_CODES:
            for lamb in ((0.0, 0.37) if source == "gdt" else (1.0,)):
                common = dict(kernel=kernel, dtype=dtype, k=k, band_h=band_h,
                              lamb=lamb)
                if layout == "patch":
                    for cap, cell_w in GEOMETRY_CAPS:
                        yield IM.Launch(rows=cap, width=cell_w + 2 * k,
                                        cell_w=cell_w, **common)
                    continue
                for bands, w, cell_w, bpi in GEOMETRY_STACKS:
                    if layout == "band":
                        cell_w = w
                    yield IM.Launch(rows=bands * band_h, width=w,
                                    cell_w=cell_w, bands_per_image=bpi,
                                    **common)


@pytest.mark.parametrize("k", (1, 2, 7, 31, 32))
def test_geometry_exports_equal_the_model(cuda, k):
    """Every source's ``*_geometry`` and ``*_windows`` exports (the
    launchers' own shape choice and ``morph::locate`` on every block)
    equal ``repro_torch.analysis.indexmaps``' model field for field,
    for every kernel, dtype and λ instance, and every feasible launch
    is proved in bounds and a partition."""
    from repro_torch.analysis import indexmaps as IM

    n_windows = 0
    for launch in _geometry_launches(k):
        finds, n = IM.compare_with_library(launch)
        assert not finds, [str(f) for f in finds]
        n_windows += n
        if IM.launch_shape(launch)[1] is not None:
            assert IM.check_launch(launch) == [], launch.label()
    assert n_windows > 0
