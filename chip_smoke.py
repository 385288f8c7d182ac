"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # every phase, one GPU

Phases, each of which makes the script exit non-zero when it fails:

1. environment: the card's name and power limit, and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together);
2. kernels: each of the ten kernels against its plain PyTorch version
   on the card — the four morphology kernels over uint8/uint16/int32/
   float32/float64 and both ops (with the lattice extremes, cells that
   do not move, and the thread-strip bodies' edges: K = 1, 2 and 4,
   odd K, tiles narrower than a warp's 128 packed uint8 columns, widths
   off 128, K = 32 on 64x256), the three QDT kernels over uint8/
   uint16/int32 (with its extremes)/float32/float64 (and the
   thread-strip bodies' edges: K = 1, odd K, widths and window origins
   off the uint8 body's 4-pixel words, narrow cells, K = 32, r over the
   int32 range), the three gdt kernels
   over float32/float64 and λ ∈ {0, 1, 0.37} (with +inf distances and
   pad cells, and the block shape's edges: K = 1, odd K, bands off the
   16-row strips, cells narrower than a warp, +inf/NaN on window
   borders) — at ragged sub-tiles, N=3 stacks, activity grids with
   zeros, ragged per-cell QDT offsets, sentinel slots, NaN inputs, and
   at the main path's shapes;
3. main path, one run per slice of the port, each with the launch
   counts set to 0 just before it and read just after; every kernel of
   the slice must have been launched in its run, and every result must
   equal the ``"torch"`` engine's on the same card.  At paper scale
   (N=8 × 1024×1024 ``blobs`` images) through ``repro_torch.api.compile``:
   the morphology slice's long chains, HMAX, opening by reconstruction,
   ASF₃, a fixed geodesic chain and a row-only reconstruction; the QDT
   slice's ``E.qdt`` (uint8, float32, and uint8 under a row-only plan)
   and ``qdt_l1_expr`` (plus small uint16 cases of both slices); the gdt
   slice's ``E.gdt`` (λ = 1 and λ = 0, and under a row-only plan), the
   scribble and h-minima segmentations, and small float64 and raster
   cases (the raster result must also equal the wavefront result);
4. trace: one profiled run of five main-path cases (the device's busy
   and idle share, and where its time goes);
5. timing: each kernel (``chain_step`` in uint8 and in float32), its
   plain version and one PyTorch yardstick call at the main path's
   shapes, beside the bound computed from the same inputs;
6. serving: a request stream through ``repro_torch.serve.Service`` on
   the card (``max_batch=8``, ``pad_quantum=64``, ``max_delay_ms=50``),
   every bucket warmed first: 48 ragged frames of about 1024x1024
   (blobs, basins, border objects) fanned out to nine operators, and
   two pinned float32 images (1024x1024, and 1000x1016 padded into the
   same bucket) serving scribble segmentations and gdt requests.  The
   launch counts are set to 0 just before the stream at
   pipeline depth 2 and read just after (every kernel of the served mix
   must have been launched); the same stream then runs at depth 1.
   Every ticket must end ``ok``, and every value must be equal across
   the depths and to the ``"torch"`` engine on the unpadded request.
   It prints the stream's frames/s, the service's totals (requests/s,
   MPx/s, occupancy, cache hit rate, busy/capacity chunks), p50/p99 per
   bucket, the launches, and the device idle share of one profiled
   pass.

The third-to-last line of standard output is the card's ``nvidia-smi``
name and power limit, the second-to-last ``{"kernels": [...]}``, and
the last ``{"ok": true, "device": {...}}``.  Everything measured also
goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 non-tensor
#: ops/s.  The fp32 rate is used for every dtype's min/max count, which
#: keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

#: Where every tensor of the run lives.
DEVICE = "cuda"

DTYPES = (torch.uint8, torch.uint16, torch.int32, torch.float32,
          torch.float64)
OPS = ("erode", "dilate")


def log(*parts):
    print(*parts, flush=True)


def smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return proc.stdout.strip().splitlines()[0] if proc.stdout else "unknown"


# ---------------------------------------------------------------------------
# comparison and timing helpers
# ---------------------------------------------------------------------------


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over positions that are NaN in neither."""
    a64, b64 = a.double(), b.double()
    ok = ~(torch.isnan(a64) | torch.isnan(b64))
    if not bool(ok.any()):
        return 0.0
    return float((a64[ok] - b64[ok]).abs().max())


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-level agreement: torch.equal, NaN positions as positions."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        na, nb = torch.isnan(a), torch.isnan(b)
        return (torch.equal(na, nb)
                and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0)))
    if a.dtype == torch.uint16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def rand(shape, dtype, gen, nan_frac=0.0):
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=gen, device=DEVICE, dtype=dtype)
        if nan_frac:
            x[torch.rand(shape, generator=gen, device=DEVICE) < nan_frac] = (
                float("nan"))
        return x
    hi = torch.iinfo(dtype).max
    x = torch.randint(0, hi + 1, shape, generator=gen, device=DEVICE,
                      dtype=torch.int64)
    if dtype == torch.uint16:  # through the int16 bit view
        return x.to(torch.int16).view(torch.uint16)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------


class Checks:
    """Kernel-vs-plain comparisons; remembers each kernel's worst error."""

    def __init__(self):
        self.err: dict = {}
        self.count = 0

    def record(self, name, got, want, what):
        for g, w in zip(got, want):
            if not same(g, w):
                raise AssertionError(
                    f"{name} disagrees with its plain version ({what}): "
                    f"max_abs_err={max_abs_err(g, w)}")
            if g.dtype != torch.int32:
                self.err[name] = max(self.err.get(name, 0.0),
                                     max_abs_err(g, w))
        self.count += 1


def morph_image(shape, dtype, gen):
    """A morphology check input: NaN in float images, and the lattice
    extremes (the pins of the erosion and the dilation) in integer
    ones."""
    x = rand(shape, dtype, gen, 0.01 if dtype.is_floating_point else 0.0)
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        for v in (info.min, info.max):
            hit = torch.rand(shape, generator=gen, device=DEVICE) < 0.05
            if dtype == torch.uint16:  # through the int16 bit view
                x.view(torch.int16)[hit] = torch.tensor(
                    v, dtype=torch.int32).to(torch.int16).item()
            else:
                x[hit] = v
    return x


#: Morphology grids where the thread-strip bodies can go wrong, beside
#: the grids above: K = 1, 2 and 4 (a fixed chain's remainder runs at
#: powers of two below fuse_k), odd K (7) with bands off a strip's 16
#: rows, tiles of 8, 14, 16, 28, 32 and 48 columns (narrower than a
#: warp's 128 packed uint8 columns, and off the 4-pixel words), widths
#: that are not a multiple of 128, and K = 32 on 64x256.  The marker
#: equals the mask on the top half of each plane, so cells there keep
#: their flag at 0.
MORPH_EDGE_GRIDS = [(1, 2, 5, 40, 8, 1), (1, 3, 21, 84, 28, 7),
                    (1, 2, 14, 42, 14, 7), (2, 2, 48, 96, 32, 16),
                    (1, 2, 32, 200, 40, 8), (1, 2, 64, 256, 128, 32),
                    (1, 2, 16, 80, 16, 2), (2, 2, 32, 192, 48, 4)]


def check_kernels(checks: Checks) -> None:
    from repro_torch.kernels import erode_chain as EC
    from repro_torch.kernels import geodesic_chain as GC

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    # (n_images, bands_per_image, band_h, width, tile_w, fuse_k): ragged
    # sub-tiles (cells larger than, and not multiples of, a block's
    # sub-tile), an N=3 stack, and small cells
    grids = [(3, 2, 160, 480, 160, 16), (3, 3, 32, 256, 128, 8),
             (1, 2, 64, 384, 128, 32)]
    cases = ([(g, False) for g in grids]
             + [(g, True) for g in MORPH_EDGE_GRIDS])
    for dtype in DTYPES:
        for op in OPS:
            for (n, bpi, bh, w, tw, k), edge in cases:
                h = n * bpi * bh
                what = (f"{dtype} {op} h={h} w={w} band={bh} tile={tw} k={k}"
                        f"{' edge' if edge else ''}")
                x = morph_image((h, w), dtype, gen)
                m = morph_image((h, w), dtype, gen)
                if edge:
                    x[:h // 2] = m[:h // 2]
                args = dict(op=op, fuse_k=k, band_h=bh, bands_per_image=bpi)
                checks.record("chain_step",
                              [EC.chain_step(x, **args)],
                              [EC.chain_step_plain(x, **args)], what)
                act = (torch.rand((h // bh, 1), generator=gen,
                                  device=DEVICE) < 0.6).to(torch.int32)
                checks.record(
                    "geodesic_chain_step",
                    GC.geodesic_chain_step(x, m, active=act, **args),
                    GC.geodesic_chain_step_plain(x, m, active=act, **args),
                    what)
                act = (torch.rand((h // bh, w // tw), generator=gen,
                                  device=DEVICE) < 0.6).to(torch.int32)
                checks.record(
                    "geodesic_tile_step",
                    GC.geodesic_tile_step(x, m, tile_w=tw, active=act,
                                          **args),
                    GC.geodesic_tile_step_plain(x, m, tile_w=tw, active=act,
                                                **args), what)
                cap, ph = 5, bh + 2 * k
                fp = morph_image((cap * ph, tw + 2 * k), dtype, gen)
                mp = morph_image((cap * ph, tw + 2 * k), dtype, gen)
                if edge:
                    fp[:2 * ph] = mp[:2 * ph]
                valid = torch.tensor([[1], [0], [1], [1], [0]],
                                     dtype=torch.int32, device=DEVICE)
                cargs = dict(op=op, fuse_k=k, band_h=bh, tile_w=tw)
                checks.record(
                    "geodesic_compact_step",
                    GC.geodesic_compact_step(fp, mp, valid, **cargs),
                    GC.geodesic_compact_step_plain(fp, mp, valid, **cargs),
                    what)
    sync()


def qdt_image(shape, dtype, gen):
    """A QDT check input: NaN in float images, and the int32 extremes,
    where the residual wraps."""
    x = rand(shape, dtype, gen, 0.01 if dtype.is_floating_point else 0.0)
    if dtype == torch.int32:
        x = torch.randint(-2**31, 2**31, shape, generator=gen, device=DEVICE,
                          dtype=torch.int64).to(torch.int32)
        for v in (2**31 - 1, -2**31):
            x[torch.rand(shape, generator=gen, device=DEVICE) < 0.05] = v
    return x


#: QDT grids where the thread-strip bodies can go wrong, beside the grids
#: of the other kernels: K = 1, an odd K with bands off a strip's 16
#: rows, tiles and compact patches whose width and window origin are not
#: multiples of 4 (the uint8 body's packed words), cells narrower than a
#: warp, and K = 32 at the main path's 64x128 cell.  Their r planes span
#: the int32 range, with -1, 256 and the extremes (the uint8 body clamps
#: r to [-1, 255]).
QDT_EDGE_GRIDS = [(1, 2, 5, 40, 8, 1), (1, 3, 21, 84, 28, 7),
                  (1, 2, 14, 42, 14, 7), (2, 2, 48, 96, 32, 16),
                  (1, 2, 64, 256, 128, 32)]


def check_qdt_kernels(checks: Checks) -> None:
    from repro_torch.kernels import qdt_chain as QC
    from repro_torch.kernels.common import qdt_acc_dtype

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    grids = [(3, 2, 160, 480, 160, 16), (3, 3, 32, 256, 128, 8),
             (1, 2, 64, 384, 128, 32)]
    cases = ([(g, False) for g in grids]
             + [(g, True) for g in QDT_EDGE_GRIDS])

    def ints(shape, hi, lo=0):
        return torch.randint(lo, hi, shape, generator=gen, device=DEVICE,
                             dtype=torch.int32)

    for dtype in (torch.uint8, torch.uint16, torch.int32, torch.float32,
                  torch.float64):
        acc = qdt_acc_dtype(dtype)

        def planes(shape, wide):
            """Mid-flight r (NaN in float ones) and d planes; ``wide``
            draws r over the int32 range, half of it in [-2, 258), with
            the extremes, -1 and 256 in place."""
            if not wide:
                r = (rand(shape, acc, gen, 0.01) if acc.is_floating_point
                     else ints(shape, 200))
                return r, ints(shape, 50)
            r = torch.randint(-2**31, 2**31, shape, generator=gen,
                              device=DEVICE, dtype=torch.int64)
            near = torch.rand(shape, generator=gen, device=DEVICE) < 0.5
            r = torch.where(near, ints(shape, 258, -2).long(), r)
            r.view(-1)[:4] = torch.tensor([-2**31, 2**31 - 1, -1, 256])
            r = r.to(acc)
            if acc.is_floating_point:
                r[torch.rand(shape, generator=gen, device=DEVICE)
                  < 0.01] = float("nan")
            return r, ints(shape, 50)

        for (n, bpi, bh, w, tw, k), wide in cases:
            h = n * bpi * bh
            what = (f"{dtype} h={h} w={w} band={bh} tile={tw} k={k}"
                    f"{' wide r' if wide else ''}")
            f = qdt_image((h, w), dtype, gen)
            r, d = planes((h, w), wide)
            args = dict(fuse_k=k, band_h=bh, bands_per_image=bpi)
            for name, grid, extra in (
                    ("qdt_chain_step", (h // bh, 1), {}),
                    ("qdt_tile_step", (h // bh, w // tw), {"tile_w": tw})):
                base, act = ints(grid, 500), ints(grid, 2)
                kern, plain = getattr(QC, name), getattr(QC, name + "_plain")
                checks.record(
                    name, kern(f, r, d, base, active=act, **args, **extra),
                    plain(f, r, d, base, active=act, **args, **extra), what)
            cap = 5
            fp = qdt_image((cap * (bh + 2 * k), tw + 2 * k), dtype, gen)
            rm, dm = planes((cap * bh, tw), wide)
            valid = torch.tensor([[1], [0], [1], [1], [0]],
                                 dtype=torch.int32, device=DEVICE)
            base = ints((cap, 1), 500)
            cargs = dict(fuse_k=k, band_h=bh, tile_w=tw)
            checks.record(
                "qdt_compact_step",
                QC.qdt_compact_step(fp, rm, dm, valid, base, **cargs),
                QC.qdt_compact_step_plain(fp, rm, dm, valid, base, **cargs),
                what)
    sync()


def gdt_planes(shape, dtype, gen, nan=0.01, frame=None):
    """gdt check planes: d in [0, 20) with +inf, i uniform in [0, 3]
    (where a contracted weight would round differently) with NaN, and s
    in [0, 1) with pad cells (-1) inside the image.  With ``frame`` (a
    row period: an image's or a patch's height), d is +inf and i NaN on
    the first and last row of every period and the first and last
    column, where a window's border lies."""
    def u(scale=1.0):
        return torch.rand(shape, generator=gen, device=DEVICE,
                          dtype=dtype) * scale

    def where(frac):
        return torch.rand(shape, generator=gen, device=DEVICE) < frac

    d, i, s = u(20.0), u(3.0), u()
    d[where(0.05)] = float("inf")
    i[where(nan)] = float("nan")
    s[where(0.05)] = -1.0
    if frame is not None:
        rows = torch.arange(shape[0], device=DEVICE) % frame
        edge = (rows == 0) | (rows == frame - 1)
        for x, v in ((d, float("inf")), (i, float("nan"))):
            x[edge] = v
            x[:, 0] = x[:, -1] = v
    return d, i, s


#: gdt grids where the thread-strip body can go wrong, beside the grids
#: of the other kernels: K = 1, an odd K with bands that are not a
#: multiple of a strip's 16 rows, cells narrower than a warp's 32
#: columns, and K = 32, beyond the register-weight instance.
GDT_EDGE_GRIDS = [(1, 2, 5, 40, 8, 1), (1, 3, 21, 84, 28, 7),
                  (2, 2, 48, 96, 32, 16), (1, 2, 64, 192, 64, 32)]


def check_gdt_kernels(checks: Checks) -> None:
    from repro_torch.kernels import gdt_chain as GD

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    grids = [(3, 2, 160, 480, 160, 16), (3, 3, 32, 256, 128, 8),
             (1, 2, 64, 384, 128, 32)]
    # the edge grids frame their planes, with NaN in i only on the frames
    # (elsewhere it would turn most of the output NaN within K steps)
    cases = ([(g, False) for g in grids]
             + [(g, True) for g in GDT_EDGE_GRIDS])
    for dtype in GD.DTYPES:
        for lamb in (0.0, 1.0, 0.37):
            for (n, bpi, bh, w, tw, k), framed in cases:
                h = n * bpi * bh
                what = (f"{dtype} lamb={lamb} h={h} w={w} band={bh} "
                        f"tile={tw} k={k}{' framed' if framed else ''}")

                def planes(shape, period):
                    if framed:
                        return gdt_planes(shape, dtype, gen, nan=0.0,
                                          frame=period)
                    return gdt_planes(shape, dtype, gen)

                d, i, s = planes((h, w), bpi * bh)
                args = dict(lamb=lamb, fuse_k=k, band_h=bh,
                            bands_per_image=bpi)
                for name, grid, extra in (
                        ("gdt_chain_step", (h // bh, 1), {}),
                        ("gdt_tile_step", (h // bh, w // tw),
                         {"tile_w": tw})):
                    act = (torch.rand(grid, generator=gen, device=DEVICE)
                           < 0.6).to(torch.int32)
                    kern, plain = (getattr(GD, name),
                                   getattr(GD, name + "_plain"))
                    checks.record(
                        name, kern(d, i, s, active=act, **args, **extra),
                        plain(d, i, s, active=act, **args, **extra), what)
                cap = 5
                ph = bh + 2 * k
                win = planes((cap * ph, tw + 2 * k), ph)
                valid = torch.tensor([[1], [0], [1], [1], [0]],
                                     dtype=torch.int32, device=DEVICE)
                cargs = dict(lamb=lamb, fuse_k=k, band_h=bh, tile_w=tw)
                checks.record(
                    "gdt_compact_step",
                    GD.gdt_compact_step(*win, valid, **cargs),
                    GD.gdt_compact_step_plain(*win, valid, **cargs), what)
    sync()


# ---------------------------------------------------------------------------
# phase 3: the main path at paper scale, through compile()
# ---------------------------------------------------------------------------

N, SIZE = 8, 1024
#: the fixed chain of the paper's Fig. 7 workload
CHAIN = 1500


def kernel_modules():
    from repro_torch.kernels import erode_chain as EC
    from repro_torch.kernels import geodesic_chain as GC
    from repro_torch.kernels import gdt_chain as GD
    from repro_torch.kernels import qdt_chain as QC

    return {"chain_step": EC.chain_step,
            "geodesic_chain_step": GC.geodesic_chain_step,
            "geodesic_tile_step": GC.geodesic_tile_step,
            "geodesic_compact_step": GC.geodesic_compact_step,
            "qdt_chain_step": QC.qdt_chain_step,
            "qdt_tile_step": QC.qdt_tile_step,
            "qdt_compact_step": QC.qdt_compact_step,
            "gdt_chain_step": GD.gdt_chain_step,
            "gdt_tile_step": GD.gdt_tile_step,
            "gdt_compact_step": GD.gdt_compact_step}


#: Each slice of the port: the kernels its main path must launch.
SLICES = {
    "morphology": ("chain_step", "geodesic_chain_step",
                   "geodesic_tile_step", "geodesic_compact_step"),
    "qdt": ("qdt_chain_step", "qdt_tile_step", "qdt_compact_step"),
    "gdt": ("gdt_chain_step", "gdt_tile_step", "gdt_compact_step"),
}

#: Main-path cases whose sparse tail must reach a compact kernel.
MUST_COMPACT = {"hmax40/uint8": "geodesic_compact_step",
                "qdt/uint8": "qdt_compact_step",
                "gdt/float32": "gdt_compact_step"}

#: Main-path cases that must also equal another case's result.
SAME_AS = {"gdt-raster/float32-2x256": "gdt/float32-2x256"}

#: Seeds per image of the gdt cases.
GDT_SEEDS = 16


def stack(dtype, n=None, size=None, seed0=0):
    from repro_torch.data.images import blobs

    n, size = n or N, size or SIZE
    x = np.stack([blobs(size, size, dtype, seed=seed0 + i) for i in range(n)])
    return torch.from_numpy(x).to(DEVICE)


def gdt_seeds(shape, seed=0) -> torch.Tensor:
    """GDT_SEEDS single-pixel seeds per image (1.0), else 0.0."""
    rng = np.random.default_rng(seed)
    n, h, w = shape
    seeds = np.zeros(shape, np.float32)
    for img in seeds:
        img[rng.integers(0, h, GDT_SEEDS), rng.integers(0, w, GDT_SEEDS)] = 1
    return torch.from_numpy(seeds).to(DEVICE)


def scribbles(shape, seed=1) -> torch.Tensor:
    """Label 1 on eight 5×5 squares per image, label 2 on the one-pixel
    frame: the two seed sets a scribble-annotation tool sends."""
    rng = np.random.default_rng(seed)
    n, h, w = shape
    marks = np.zeros(shape, np.float32)
    marks[:, 0, :] = marks[:, -1, :] = marks[:, :, 0] = marks[:, :, -1] = 2
    for img in marks:
        ys, xs = rng.integers(8, h - 13, 8), rng.integers(8, w - 13, 8)
        for y, x in zip(ys, xs):
            img[y:y + 5, x:x + 5] = 1
    return torch.from_numpy(marks).to(DEVICE)


def main_cases(images) -> dict:
    """Slice → (name, expr, inputs, plan) of each of its main-path
    cases."""
    from repro_torch.api import E, asf_expr, hmax_expr, qdt_l1_expr
    from repro_torch.api import opening_by_reconstruction_expr as obr
    from repro_torch.core.chain import plan_chain
    from repro_torch.gdt import gdt_expr, seg_hmin_expr, seg_scribble_expr

    f = E.input("f")
    u8, f32, u16 = images["uint8"], images["float32"], images["uint16"]
    f32_marker = f32 - 0.15
    row_plan = plan_chain(SIZE, SIZE, torch.float32, None,
                          n_images_resident=2, n_images=N, convergent=True,
                          tile_w=0)
    qdt_rows = plan_chain(SIZE, SIZE, torch.uint8, None,
                          n_images_resident=3, n_images=N, convergent=True,
                          tile_w=0)
    rec = E.reconstruct(E.input("marker"), E.input("mask"), op="dilate")
    seeds, marks = gdt_seeds(f32.shape), scribbles(f32.shape)
    gdt_rows = plan_chain(SIZE, SIZE, torch.float32, None,
                          n_images_resident=3, n_images=N, convergent=True,
                          tile_w=0)
    raster = plan_chain(256, 256, torch.float32, None, n_images_resident=3,
                        n_images=2, convergent=True, schedule="raster")

    def gdt(lamb):
        return gdt_expr(E.input("image"), E.input("seeds"), lamb=lamb,
                        nu=1e6)

    def small(dtype):
        image = stack(np.float32, n=2, size=256).to(dtype)
        return image, gdt_seeds(image.shape, seed=2).to(dtype)

    return {
        "morphology": [
            ("erode1500/uint8", E.erode(CHAIN, f), (u8,), None),
            ("erode1500/float32", E.erode(CHAIN, f), (f32,), None),
            ("hmax40/uint8", hmax_expr(40), (u8,), None),
            ("obr8/uint8", obr(8), (u8,), None),
            ("asf3/uint8", asf_expr(3), (u8,), None),
            ("geodesic64/uint8",
             E.geodesic(E.sat_sub(f, 30), f, 64, op="dilate"), (u8,),
             None),
            ("reconstruct-rows/float32", rec, (f32_marker, f32), row_plan),
            ("hmax40/uint16-2x256", hmax_expr(40), (u16,), None),
        ],
        "qdt": [
            ("qdt/uint8", E.qdt(f), (u8,), None),
            ("qdt_l1/uint8", qdt_l1_expr(), (u8,), None),
            ("qdt/float32", E.qdt(f), (f32,), None),
            ("qdt-rows/uint8", E.qdt(f), (u8,), qdt_rows),
            ("qdt/uint16-2x256", E.qdt(f), (u16,), None),
        ],
        "gdt": [
            ("gdt/float32", gdt(1.0), (f32, seeds), None),
            ("gdt-l0/float32", gdt(0.0), (f32, seeds), None),
            ("seg_scribble/float32", seg_scribble_expr(), (f32, marks),
             None),
            ("seg_hmin/float32", seg_hmin_expr(0.1), (f32,), None),
            ("gdt-rows/float32", gdt(1.0), (f32, seeds), gdt_rows),
            ("gdt/float64-2x256", gdt(1.0), small(torch.float64), None),
            ("gdt/float32-2x256", gdt(1.0), small(torch.float32), None),
            ("gdt-raster/float32-2x256", gdt(1.0), small(torch.float32),
             raster),
        ],
    }


def run_main_path(cases, counters) -> list:
    """Run every case on both engines; returns per-case rows.  Fails
    unless each "cuda" result equals the "torch" engine's."""
    from repro_torch.api import compile

    rows, results = [], {}
    for name, expr, inputs, plan in cases:
        shape, dtype = tuple(inputs[0].shape), inputs[0].dtype
        exe = compile(expr, shape, dtype, "cuda", plan=plan,
                      device=DEVICE)
        oracle = compile(expr, shape, dtype, "torch", device=DEVICE)
        before = {k: fn.launches for k, fn in counters.items()}
        sync()
        t0 = time.perf_counter()
        out = exe(*inputs)
        sync()
        first_s = time.perf_counter() - t0
        launched = {k: fn.launches - before[k] for k, fn in counters.items()}
        t0 = time.perf_counter()
        want = oracle(*inputs)
        sync()
        oracle_s = time.perf_counter() - t0
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        for o, w in zip(outs, wants, strict=True):
            if not same(o, w):
                raise AssertionError(
                    f"main path {name}: cuda engine != torch engine "
                    f"(max_abs_err={max_abs_err(o, w)})")
        if name in MUST_COMPACT and not launched[MUST_COMPACT[name]]:
            raise AssertionError(f"{name} never reached the compact kernel")
        results[name] = outs
        if name in SAME_AS and not all(
                same(o, w) for o, w in zip(outs, results[SAME_AS[name]],
                                           strict=True)):
            raise AssertionError(f"main path {name} != {SAME_AS[name]}")
        rows.append(dict(case=name, shape=list(shape),
                         dtype=str(dtype).removeprefix("torch."),
                         plans=[list(p.key) for p in exe.all_plans],
                         launches=launched, first_run_s=first_s,
                         torch_engine_s=oracle_s,
                         run=lambda e=exe, x=inputs: e(*x)))
        log(f"main path {name}: equal to the torch engine; launches "
            f"{ {k: v for k, v in launched.items() if v} }; first run "
            f"{first_s * 1e3:.1f} ms, torch engine {oracle_s * 1e3:.1f} ms")
    return rows


def time_main_path(rows, card: str) -> None:
    """Steady-state time per run of each case on the cuda engine."""
    for row in rows:
        reps = 3
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            row["run"]()
        sync()
        ms = (time.perf_counter() - t0) / reps * 1e3
        row["ms_per_run"] = ms
        row["images_per_s"] = row["shape"][0] / (ms / 1e3)
        log(f"time {row['case']}: {ms:.2f} ms/run, "
            f"{row['images_per_s']:.1f} images/s ({card})")


TRACED = ("erode1500/uint8", "hmax40/uint8", "reconstruct-rows/float32",
          "qdt/uint8", "gdt/float32")

#: Name parts of the port's own kernels in a trace.
PORT_KERNELS = ("morph_u8_kernel", "morph_pixel_kernel", "qdt_pixel_kernel",
                "qdt_u8_kernel", "gdt_kernel")


def profile_run(case: str, fn, card: str) -> dict:
    """One profiled run of ``fn`` after one unprofiled run: the
    device's busy and idle share of the run's wall time, split into the
    port's kernels (``PORT_KERNELS``), other device work (oracle tails,
    padding, gathers, scatters, flags) and copies."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    split = {"kernels": 0.0, "other": 0.0, "copies": 0.0}
    top: dict = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        key = ("kernels" if any(k in ev.name for k in PORT_KERNELS) else
               "copies" if "memcpy" in ev.name.lower() else "other")
        split[key] += us
        short = ev.name.replace("(anonymous namespace)::", "")
        short = short.split("(")[0][:60]
        top[short] = top.get(short, 0.0) + us
    busy = sum(split.values())
    if not busy:
        raise AssertionError(f"trace of {case}: no device time")
    rec = dict(case=case, wall_ms=wall_us / 1e3,
               busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
               split_ms={k: v / 1e3 for k, v in split.items()},
               top_ms=dict(sorted(((k, v / 1e3) for k, v in top.items()),
                                  key=lambda kv: -kv[1])[:6]))
    log(f"trace {rec['case']}: wall {rec['wall_ms']:.2f} ms, device "
        f"busy {rec['busy_ms']:.2f} ms (idle share "
        f"{rec['idle_share']:.3f}); split {json.dumps(rec['split_ms'])}; "
        f"top {json.dumps(rec['top_ms'])} ({card})")
    return rec


def trace_main_path(rows, card: str) -> list:
    """One profiled run of each ``TRACED`` main-path case."""
    return [profile_run(row["case"], row["run"], card) for row in rows
            if row["case"] in TRACED]


# ---------------------------------------------------------------------------
# phase 4: each kernel at the main path's shapes
# ---------------------------------------------------------------------------

_MORPH_CU = "src/repro_torch/kernels/csrc/morph_chain.cu"
_QDT_CU = "src/repro_torch/kernels/csrc/qdt_chain.cu"
_GDT_CU = "src/repro_torch/kernels/csrc/gdt_chain.cu"

#: kernel → (the TPU kernel it replaces, its source)
KERNEL_META = {
    "chain_step": ("src/repro/kernels/erode_chain.py:60", _MORPH_CU),
    "geodesic_chain_step": ("src/repro/kernels/geodesic_chain.py:99",
                            _MORPH_CU),
    "geodesic_tile_step": ("src/repro/kernels/geodesic_chain.py:189",
                           _MORPH_CU),
    "geodesic_compact_step": ("src/repro/kernels/geodesic_chain.py:269",
                              _MORPH_CU),
    "qdt_chain_step": ("src/repro/kernels/qdt_chain.py:96", _QDT_CU),
    "qdt_tile_step": ("src/repro/kernels/qdt_chain.py:192", _QDT_CU),
    "qdt_compact_step": ("src/repro/kernels/qdt_chain.py:281", _QDT_CU),
    "gdt_chain_step": ("src/repro/kernels/gdt_chain.py:150", _GDT_CU),
    "gdt_tile_step": ("src/repro/kernels/gdt_chain.py:236", _GDT_CU),
    "gdt_compact_step": ("src/repro/kernels/gdt_chain.py:312", _GDT_CU),
}


def bound(bytes_moved: float, ops: float):
    """The least time for the work: ``bytes_moved`` (each input read
    once, each output written once) at the HBM rate, or ``ops`` (4 min/max
    per pixel per step, 5 with the mask clamp, 6 with the QDT's subtract
    and compare, over the pixels the function needs — a tiling's halo
    recompute is not its work) at the peak rate, whichever is longer;
    with the name of the limit."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_chain(xf: torch.Tensor, k: int, mask=None):
    """K × -max_pool2d(-x) in float32 (and the mask clamp): one PyTorch
    yardstick for the same function, never used by the port."""
    import torch.nn.functional as F

    y = xf
    for _ in range(k):
        y = F.max_pool2d(y, 3, 1, 1)       # dilation, -inf padding
        if mask is not None:
            y = torch.minimum(y, mask)
    return y


def library_qdt(xf: torch.Tensor, k: int, r, d, centre=(Ellipsis,)):
    """K × -max_pool2d(-x) in float32 with the residual over ``centre``
    and the two ``torch.where`` masked stores per step: one PyTorch
    yardstick for a QDT chunk, never used by the port."""
    import torch.nn.functional as F

    y = xf
    for step in range(1, k + 1):
        nxt = -F.max_pool2d(-y, 3, 1, 1)   # erosion, +inf padding
        res = (y - nxt)[centre]
        upd = res > r
        r = torch.where(upd, res, r)
        d = torch.where(upd, step, d)
        y = nxt
    return y, r, d


def time_qdt_kernels(checks: Checks, images) -> dict:
    """The QDT kernels at the main path's shapes: the first chunk of
    ``E.qdt`` on the uint8 stack (r = d = 0, every cell active), and a
    full compact workspace; each held against its plain version there."""
    from repro_torch.core.chain import plan_chain
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import qdt_chain as QC

    u8 = images["uint8"]
    esize, out = u8.element_size(), {}
    plans = {"qdt_tile_step": plan_chain(SIZE, SIZE, torch.uint8, None,
                                         n_images_resident=3, n_images=N,
                                         convergent=True),
             "qdt_chain_step": plan_chain(SIZE, SIZE, torch.uint8, None,
                                          n_images_resident=3, n_images=N,
                                          convergent=True, tile_w=0)}
    for name, plan in plans.items():
        k, bh = plan.fuse_k, plan.band_h
        x = K._stacked(K._pad(u8, plan, 255))
        r = torch.zeros(x.shape, dtype=torch.int32, device=DEVICE)
        d = torch.zeros_like(r)
        grid = (plan.total_bands, plan.n_tiles)
        base = torch.zeros(grid, dtype=torch.int32, device=DEVICE)
        act = torch.ones(grid, dtype=torch.int32, device=DEVICE)
        args = dict(fuse_k=k, band_h=bh, active=act,
                    bands_per_image=plan.n_bands)
        if plan.n_tiles > 1:
            args["tile_w"] = plan.tile_w
        kern, plain = getattr(QC, name), getattr(QC, name + "_plain")
        checks.record(name, kern(x, r, d, base, **args),
                      plain(x, r, d, base, **args), "main-path shape")
        shape4 = (N, 1, plan.height_pad, plan.width_pad)
        xf = x.float().reshape(shape4)
        rf, df = r.float().reshape(shape4), d.reshape(shape4)
        b_ms, b_by = bound(2 * x.numel() * (esize + 4 + 4),
                           6 * k * x.numel())
        out[name] = dict(
            ms=cuda_ms(lambda: kern(x, r, d, base, **args)),
            plain_ms=cuda_ms(lambda: plain(x, r, d, base, **args), reps=3),
            library_ms=cuda_ms(lambda: library_qdt(xf, k, rf, df), reps=3),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"({x.shape[0]}, {x.shape[1]}) uint8 K={k} cells "
                  f"{bh}x{plan.tile_w or plan.width_pad}, "
                  f"{plan.total_tiles} active")

    plan = plans["qdt_tile_step"]
    k, bh, tw = plan.fuse_k, plan.band_h, plan.tile_w
    cap = plan.compact_capacity
    x = K._stacked(K._pad(u8, plan, 255))
    r = torch.zeros(x.shape, dtype=torch.int32, device=DEVICE)
    idx = torch.arange(cap, dtype=torch.int32, device=DEVICE) * 2
    fp = K._gather_patches(x, idx, plan, 255)
    rm, dm = K._gather_mid(r, idx, plan), K._gather_mid(r, idx, plan)
    valid = torch.ones((cap, 1), dtype=torch.int32, device=DEVICE)
    base = torch.zeros((cap, 1), dtype=torch.int32, device=DEVICE)
    cargs = dict(fuse_k=k, band_h=bh, tile_w=tw)
    checks.record("qdt_compact_step",
                  QC.qdt_compact_step(fp, rm, dm, valid, base, **cargs),
                  QC.qdt_compact_step_plain(fp, rm, dm, valid, base,
                                            **cargs),
                  "main-path shape")
    ph, pw = bh + 2 * k, tw + 2 * k
    fpf = fp.float().reshape(cap, 1, ph, pw)
    rmf, dmf = (rm.float().reshape(cap, 1, bh, tw),
                dm.reshape(cap, 1, bh, tw))
    centre = (Ellipsis, slice(k, k + bh), slice(k, k + tw))
    # step s of K needs the centre and K - s pixels around it
    region = sum((bh + 2 * j) * (tw + 2 * j) for j in range(k))
    n_valid = int(valid.sum())
    b_ms, b_by = bound(cap * ph * pw * esize + cap * bh * tw * esize
                       + 2 * rm.numel() * (4 + 4),
                       (4 * region + 2 * k * bh * tw) * n_valid)
    out["qdt_compact_step"] = dict(
        ms=cuda_ms(lambda: QC.qdt_compact_step(fp, rm, dm, valid, base,
                                               **cargs)),
        plain_ms=cuda_ms(lambda: QC.qdt_compact_step_plain(
            fp, rm, dm, valid, base, **cargs), reps=3),
        library_ms=cuda_ms(lambda: library_qdt(fpf, k, rmf, dmf, centre),
                           reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{cap} patches of ({ph}, {pw}) uint8 K={k}, all valid")
    sync()
    return out


def library_gdt(d, weights, pad, k: int):
    """K steps of F.pad with +inf, the 8 shifted candidates with
    precomputed ``weights``, ``torch.minimum`` and the pad clamp's
    ``torch.where``: one PyTorch yardstick for a gdt chunk, never used
    by the port."""
    import torch.nn.functional as F

    from repro_torch.kernels.gdt_chain import OFFSETS

    h, w = d.shape[-2:]
    for _ in range(k):
        p = F.pad(d, (1, 1, 1, 1), value=float("inf"))
        best = d
        for (dy, dx), wt in zip(OFFSETS, weights):
            best = torch.minimum(
                best, p[..., 1 - dy:1 - dy + h, 1 - dx:1 - dx + w] + wt)
        d = torch.where(pad, float("inf"), best)
    return d


def gdt_ops(pixels: int, k: int, weighted: bool) -> int:
    """Operations of one gdt chunk over ``pixels`` needed pixels: the
    weights once (8 × subtract, abs, multiply, add), then 8 adds, 8 mins
    and the clamp per pixel per step."""
    return pixels * ((32 if weighted else 0) + 17 * k)


def time_gdt_kernels(checks: Checks, images) -> dict:
    """The gdt kernels at the main path's shapes: the first chunk of
    ``gdt/float32`` (λ = 1, every cell active) on the tile and row
    plans, and a full compact workspace; each held against its plain
    version there."""
    from repro_torch.core.chain import plan_chain
    from repro_torch.kernels import gdt_chain as GD
    from repro_torch.kernels import ops as K

    f32 = images["float32"]
    lamb, out = 1.0, {}
    plans = {"gdt_tile_step": plan_chain(SIZE, SIZE, torch.float32, None,
                                         n_images_resident=3, n_images=N,
                                         convergent=True),
             "gdt_chain_step": plan_chain(SIZE, SIZE, torch.float32, None,
                                          n_images_resident=3, n_images=N,
                                          convergent=True, tile_w=0)}

    def staged(plan):
        bottom = float("-inf")
        return K.gdt_stage(K._stacked(K._pad(f32, plan, bottom)),
                           K._stacked(K._pad(gdt_seeds(f32.shape), plan,
                                             bottom)), 1e6)

    def yardstick(d, i, s, k, shape4):
        d4, i4 = d.reshape(shape4), i.reshape(shape4)
        return (d4, GD.gdt_weights(i4, lamb), s.reshape(shape4) < 0, k)

    for name, plan in plans.items():
        k, bh = plan.fuse_k, plan.band_h
        d, i, s = staged(plan)
        act = torch.ones((plan.total_bands, plan.n_tiles), dtype=torch.int32,
                         device=DEVICE)
        args = dict(lamb=lamb, fuse_k=k, band_h=bh, active=act,
                    bands_per_image=plan.n_bands)
        if plan.n_tiles > 1:
            args["tile_w"] = plan.tile_w
        kern, plain = getattr(GD, name), getattr(GD, name + "_plain")
        checks.record(name, kern(d, i, s, **args), plain(d, i, s, **args),
                      "main-path shape")
        lib = yardstick(d, i, s, k, (N, 1, plan.height_pad, plan.width_pad))
        b_ms, b_by = bound(4 * d.numel() * d.element_size(),
                           gdt_ops(d.numel(), k, True))
        out[name] = dict(
            ms=cuda_ms(lambda: kern(d, i, s, **args)),
            plain_ms=cuda_ms(lambda: plain(d, i, s, **args), reps=3),
            library_ms=cuda_ms(lambda: library_gdt(*lib), reps=3),
            bound_ms=b_ms, bound_by=b_by,
            shape=f"({d.shape[0]}, {d.shape[1]}) float32 K={k} lamb={lamb} "
                  f"cells {bh}x{plan.tile_w or plan.width_pad}, "
                  f"{plan.total_tiles} active")

    plan = plans["gdt_tile_step"]
    k, bh, tw = plan.fuse_k, plan.band_h, plan.tile_w
    cap = plan.compact_capacity
    d, i, s = staged(plan)
    idx = torch.arange(cap, dtype=torch.int32, device=DEVICE) * 2
    win = [K._gather_patches(x, idx, plan, ident) for x, ident in
           ((d, GD.D_IDENT), (i, GD.I_IDENT), (s, GD.S_IDENT))]
    valid = torch.ones((cap, 1), dtype=torch.int32, device=DEVICE)
    cargs = dict(lamb=lamb, fuse_k=k, band_h=bh, tile_w=tw)
    checks.record("gdt_compact_step",
                  GD.gdt_compact_step(*win, valid, **cargs),
                  GD.gdt_compact_step_plain(*win, valid, **cargs),
                  "main-path shape")
    ph, pw = bh + 2 * k, tw + 2 * k
    lib = yardstick(*win, k, (cap, 1, ph, pw))
    # step s of K needs the centre and K - s pixels around it; the
    # weights are needed where step 1 is
    n_valid = int(valid.sum())
    region = sum((bh + 2 * j) * (tw + 2 * j) for j in range(k))
    ops = (32 * (bh + 2 * k - 2) * (tw + 2 * k - 2) + 17 * region) * n_valid
    esize = d.element_size()
    b_ms, b_by = bound((3 * cap * ph * pw + cap * bh * tw) * esize, ops)
    out["gdt_compact_step"] = dict(
        ms=cuda_ms(lambda: GD.gdt_compact_step(*win, valid, **cargs)),
        plain_ms=cuda_ms(lambda: GD.gdt_compact_step_plain(*win, valid,
                                                           **cargs), reps=3),
        library_ms=cuda_ms(lambda: library_gdt(*lib), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{cap} patches of ({ph}, {pw}) float32 K={k} lamb={lamb}, "
              f"all valid")
    sync()
    return out


def time_kernels(checks: Checks, images) -> dict:
    """Kernel, plain version and yardstick at the main path's shapes;
    each kernel is also held against its plain version there."""
    from repro_torch.core.chain import plan_chain
    from repro_torch.kernels import erode_chain as EC
    from repro_torch.kernels import geodesic_chain as GC
    from repro_torch.kernels import ops as K

    u8 = images["uint8"]
    out = {}
    esize = u8.element_size()

    # kernel 1: fixed chains (uint8 plan of E.erode(1500))
    plan = plan_chain(SIZE, SIZE, torch.uint8, CHAIN, n_images=N)
    k, bh = plan.fuse_k, plan.band_h
    x = K._stacked(K._pad(u8, plan, 0))
    args = dict(op="dilate", fuse_k=k, band_h=bh, bands_per_image=plan.n_bands)
    checks.record("chain_step", [EC.chain_step(x, **args)],
                  [EC.chain_step_plain(x, **args)], "main-path shape")
    xf = x.float().reshape(N, 1, plan.height_pad, plan.width_pad)
    b_ms, b_by = bound(2 * x.numel() * esize, 4 * k * x.numel())
    out["chain_step"] = dict(
        ms=cuda_ms(lambda: EC.chain_step(x, **args)),
        plain_ms=cuda_ms(lambda: EC.chain_step_plain(x, **args), reps=3),
        library_ms=cuda_ms(lambda: library_chain(xf, k), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"({x.shape[0]}, {x.shape[1]}) uint8 K={k} band_h={bh}")

    # kernel 1 in float32 (the float32 plan of E.erode(1500)): the pixel
    # body, timed alone
    fplan = plan_chain(SIZE, SIZE, torch.float32, CHAIN, n_images=N)
    k, bh = fplan.fuse_k, fplan.band_h
    x32 = K._stacked(K._pad(images["float32"], fplan, float("-inf")))
    args = dict(op="dilate", fuse_k=k, band_h=bh,
                bands_per_image=fplan.n_bands)
    checks.record("chain_step", [EC.chain_step(x32, **args)],
                  [EC.chain_step_plain(x32, **args)], "main-path shape")
    x4 = x32.reshape(N, 1, fplan.height_pad, fplan.width_pad)
    b_ms, b_by = bound(2 * x32.numel() * x32.element_size(),
                       4 * k * x32.numel())
    out["chain_step/float32"] = dict(
        ms=cuda_ms(lambda: EC.chain_step(x32, **args)),
        plain_ms=cuda_ms(lambda: EC.chain_step_plain(x32, **args), reps=3),
        library_ms=cuda_ms(lambda: library_chain(x4, k), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"({x32.shape[0]}, {x32.shape[1]}) float32 K={k} "
              f"band_h={bh}")

    # kernels 2-4: geodesic marker/mask from HMAX_40
    mask = K._stacked(K._pad(u8, plan, 0))
    marker = torch.where(mask > 40, mask - 40, 0).to(torch.uint8)
    maskf = mask.float().reshape(xf.shape)
    markf = marker.float().reshape(xf.shape)
    gplan = plan_chain(SIZE, SIZE, torch.uint8, 64, n_images_resident=2,
                       n_images=N)
    k, bh = gplan.fuse_k, gplan.band_h
    gargs = dict(op="dilate", fuse_k=k, band_h=bh,
                 bands_per_image=gplan.n_bands)
    checks.record("geodesic_chain_step",
                  GC.geodesic_chain_step(marker, mask, **gargs),
                  GC.geodesic_chain_step_plain(marker, mask, **gargs),
                  "main-path shape")
    b_ms, b_by = bound(3 * mask.numel() * esize, 5 * k * mask.numel())
    out["geodesic_chain_step"] = dict(
        ms=cuda_ms(lambda: GC.geodesic_chain_step(marker, mask, **gargs)),
        plain_ms=cuda_ms(lambda: GC.geodesic_chain_step_plain(
            marker, mask, **gargs), reps=3),
        library_ms=cuda_ms(lambda: library_chain(markf, k, maskf), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"({marker.shape[0]}, {marker.shape[1]}) uint8 K={k} "
              f"band_h={bh}")

    rplan = plan_chain(SIZE, SIZE, torch.uint8, None, n_images_resident=2,
                       n_images=N, convergent=True)
    k, bh, tw = rplan.fuse_k, rplan.band_h, rplan.tile_w
    targs = dict(op="dilate", fuse_k=k, band_h=bh, tile_w=tw,
                 bands_per_image=rplan.n_bands)
    checks.record("geodesic_tile_step",
                  GC.geodesic_tile_step(marker, mask, **targs),
                  GC.geodesic_tile_step_plain(marker, mask, **targs),
                  "main-path shape")
    b_ms, b_by = bound(3 * mask.numel() * esize, 5 * k * mask.numel())
    out["geodesic_tile_step"] = dict(
        ms=cuda_ms(lambda: GC.geodesic_tile_step(marker, mask, **targs)),
        plain_ms=cuda_ms(lambda: GC.geodesic_tile_step_plain(
            marker, mask, **targs), reps=3),
        library_ms=cuda_ms(lambda: library_chain(markf, k, maskf), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"({marker.shape[0]}, {marker.shape[1]}) uint8 K={k} "
              f"cells {bh}x{tw}, {rplan.total_tiles} active")

    cap = rplan.compact_capacity
    idx = torch.arange(cap, dtype=torch.int32, device=DEVICE) * 2
    valid = torch.ones((cap, 1), dtype=torch.int32, device=DEVICE)
    fp = K._gather_patches(marker, idx, rplan, 0)
    mp = K._gather_patches(mask, idx, rplan, 0)
    cargs = dict(op="dilate", fuse_k=k, band_h=bh, tile_w=tw)
    checks.record("geodesic_compact_step",
                  GC.geodesic_compact_step(fp, mp, valid, **cargs),
                  GC.geodesic_compact_step_plain(fp, mp, valid, **cargs),
                  "main-path shape")
    ph, pw = bh + 2 * k, tw + 2 * k
    fpf = fp.float().reshape(cap, 1, ph, pw)
    mpf = mp.float().reshape(cap, 1, ph, pw)
    # step s of K needs the centre and K - s pixels around it
    region = sum((bh + 2 * j) * (tw + 2 * j) for j in range(k))
    b_ms, b_by = bound((2 * cap * ph * pw + cap * bh * tw) * esize,
                       5 * region * int(valid.sum()))
    out["geodesic_compact_step"] = dict(
        ms=cuda_ms(lambda: GC.geodesic_compact_step(fp, mp, valid, **cargs)),
        plain_ms=cuda_ms(lambda: GC.geodesic_compact_step_plain(
            fp, mp, valid, **cargs), reps=3),
        library_ms=cuda_ms(lambda: library_chain(fpf, k, mpf), reps=3),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"{cap} patches of ({ph}, {pw}) uint8 K={k}, all valid")
    sync()
    return out


# ---------------------------------------------------------------------------
# phase 6: a served request stream (repro_torch.serve) at the paper's size
# ---------------------------------------------------------------------------

#: The served mix: the serving example's (``examples/serve_geodesic.py``,
#: ``SERVICE``), a 64-step geodesic dilation and the L1 QDT.
SERVICE = (("hmax", {"h": 40}), ("dome", {"h": 40}), ("hfill", {}),
           ("raobj", {}), ("open_rec", {"s": 8}), ("erode", {"s": 16}),
           ("asf", {"s": 3}), ("geodesic", {"n": 64, "op": "dilate"}),
           ("qdt_l1", {}))
#: Frames of the stream, and the pinned image's requests of each gdt op.
FRAMES, PINNED = 48, 8
#: The pinned images (name: shape): one that fills its bucket and one
#: padded into the same 1024x1024 bucket with its -inf fill.
PINNED_SHAPES = {"pinned": (SIZE, SIZE), "ragged": (SIZE - 24, SIZE - 8)}
#: The wrappers the served mix must launch (the row-only kernels
#: ``qdt_chain_step`` and ``gdt_chain_step`` run on no served plan).
SERVE_KERNELS = ("chain_step", "geodesic_chain_step", "geodesic_tile_step",
                 "geodesic_compact_step", "qdt_tile_step",
                 "qdt_compact_step", "gdt_tile_step", "gdt_compact_step")


def serve_frames() -> list:
    """The example's frames at the paper's size: blobs, basins and
    border objects in turn, ragged (1024 - 16 (i mod 3)) x (1024 - 8 (i
    mod 5)), uint8, made in threads (NumPy releases the interpreter lock
    in its array loops)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.data.images import basins, blobs, border_objects

    kinds = (blobs, basins, border_objects)

    def frame(i):
        return kinds[i % 3](SIZE - 16 * (i % 3), SIZE - 8 * (i % 5),
                            np.uint8, seed=i)

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(frame, range(FRAMES)))


def serve_requests(frames) -> list:
    """(op, images, params) of the stream: each frame fans out to the
    mix (the geodesic marker is the frame - 40, saturating), then each
    pinned float32 image serves ``PINNED`` scribble segmentations and
    ``PINNED`` gdt requests with the gdt phase's scribbles and seeds."""
    reqs = []
    for f in frames:
        for op, params in SERVICE:
            images = ((np.where(f > 40, f - 40, 0).astype(np.uint8), f)
                      if op == "geodesic" else (f,))
            reqs.append((op, images, params))
    for name, hw in PINNED_SHAPES.items():
        shape = (PINNED, *hw)
        marks = scribbles(shape).cpu().numpy()
        seeds = gdt_seeds(shape).cpu().numpy()
        for k in range(PINNED):
            reqs.append(("seg_scribble", (name, marks[k]), {}))
            reqs.append(("gdt", (name, seeds[k]), {}))
    return reqs


def pinned_images() -> dict:
    """The pinned float32 images, by name."""
    from repro_torch.data.images import blobs

    return {name: blobs(h, w, np.float32, seed=FRAMES + i)
            for i, (name, (h, w)) in enumerate(PINNED_SHAPES.items())}


def make_service(depth: int, requests, pinned):
    """A service on the card (``device=None``), every bucket of the
    stream warmed at every canonical batch size."""
    from repro_torch.serve import Service

    svc = Service(backend="cuda", max_batch=8, pad_quantum=64,
                  max_delay_ms=50, pipeline_depth=depth,
                  cache_capacity=512)
    for name, image in pinned.items():
        svc.pin(name, image)
    seen = set()
    for op, images, params in requests:
        image = (pinned[images[0]] if isinstance(images[0], str)
                 else images[0])
        key = (op, image.shape, image.dtype)
        if key not in seen:
            seen.add(key)
            svc.warmup({"op": op, "params": params, "shape": image.shape,
                        "dtype": image.dtype, "batch": b}
                       for b in (1, 2, 4, 8))
    sync()
    return svc


def serve_pass(svc, requests) -> tuple:
    """Submit the whole stream, flush, and wait: (tickets, wall s)."""
    sync()
    t0 = time.perf_counter()
    tickets = [svc.submit(op, *images, params=params)
               for op, images, params in requests]
    svc.flush()
    sync()
    return tickets, time.perf_counter() - t0


def torch_engine_value(op, images, params, pinned):
    """The port's ``"torch"`` engine on the unpadded request, on the
    card: the registry's expression for ``op``, compiled unpadded."""
    from repro_torch.api import compile
    from repro_torch.serve import registry

    spec = registry.get(op)
    expr = spec.build_expr(spec.canonical_params(params))
    xs = [torch.from_numpy(pinned[im] if isinstance(im, str) else im)
          .to(DEVICE) for im in images]
    return compile(expr, tuple(xs[0].shape), xs[0].dtype, "torch",
                   device=DEVICE)(*xs)


def serve_stages(svc, requests) -> dict:
    """Host seconds by stage over one more pass: the prepare stage
    (``OpSpec.prepare_inputs``), staging and upload (``_stage``), the
    bucket programs (``Executor._call_entry``: a convergent one returns
    only when converged), waiting on the batches' events
    (``drain_one`` less the demux) and the demux (crops, finalize);
    ``other`` is the rest of the pass (admission, bucketing, timers)."""
    from repro_torch.serve import registry

    spent: collections.Counter = collections.Counter()

    def timed(name, fn):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return wrapper

    prepare = registry.OpSpec.prepare_inputs
    registry.OpSpec.prepare_inputs = timed("prepare", prepare)
    svc._stage = timed("stage", svc._stage)
    ex = svc.executor
    ex._call_entry = timed("program", ex._call_entry)
    ex._deliver = timed("demux", ex._deliver)
    ex.drain_one = timed("drain", ex.drain_one)
    try:
        _, wall = serve_pass(svc, requests)
    finally:
        registry.OpSpec.prepare_inputs = prepare
        for obj, name in ((svc, "_stage"), (ex, "_call_entry"),
                          (ex, "_deliver"), (ex, "drain_one")):
            delattr(obj, name)
    out = dict(spent, wall=wall)
    out["event_wait"] = out.pop("drain", 0.0) - out.get("demux", 0.0)
    out["other"] = wall - sum(v for k, v in out.items() if k != "wall")
    return out


def run_serving(counters, card: str) -> dict:
    """The served stream at pipeline depth 2 (counted, timed) and 1,
    then again at 1 and 2; every value equal across depths and to the
    ``"torch"`` engine, no ticket with an error or degraded, every
    kernel of the mix launched; then a pass split into host stages and
    one profiled pass.  Fails on any of these."""
    t0 = time.perf_counter()
    frames = serve_frames()
    pinned = pinned_images()
    requests = serve_requests(frames)
    svc2 = make_service(2, requests, pinned)
    svc1 = make_service(1, requests, pinned)
    log(f"serve: {len(frames)} frames, {len(requests)} requests, "
        f"services warmed ({time.perf_counter() - t0:.1f} s)")

    for fn in counters.values():
        fn.launches = 0
    tickets2, wall2 = serve_pass(svc2, requests)
    launched = {k: fn.launches for k, fn in counters.items()}
    stats = svc2.stats()
    busy = sum(b.busy_chunks for b in svc2.metrics._buckets.values())
    cap = sum(b.cap_chunks for b in svc2.metrics._buckets.values())
    tickets1, wall1 = serve_pass(svc1, requests)
    # the two depths again in the other order, for order and spread
    walls = {"depth2": [wall2, None], "depth1": [wall1, None]}
    walls["depth1"][1] = serve_pass(svc1, requests)[1]
    walls["depth2"][1] = serve_pass(svc2, requests)[1]
    missing = [k for k in SERVE_KERNELS if not launched[k]]
    if missing:
        raise AssertionError(f"the served stream never launched {missing}")

    t0 = time.perf_counter()
    for (op, images, params), t2, t1 in zip(requests, tickets2, tickets1,
                                            strict=True):
        for t in (t2, t1):
            if t.outcome != "ok":
                raise AssertionError(
                    f"served {op} ended {t.outcome}: {t.error!r}")
        got2 = t2.value if isinstance(t2.value, tuple) else (t2.value,)
        got1 = t1.value if isinstance(t1.value, tuple) else (t1.value,)
        want = torch_engine_value(op, images, params, pinned)
        want = want if isinstance(want, tuple) else (want,)
        for a, b, w in zip(got2, got1, want, strict=True):
            if a.device.type != torch.device(DEVICE).type or not same(a, b):
                raise AssertionError(f"served {op}: depth 2 != depth 1")
            if not same(a, w):
                raise AssertionError(
                    f"served {op} != the torch engine "
                    f"(max_abs_err={max_abs_err(a, w)})")
    check_s = time.perf_counter() - t0

    tot, cache = stats["totals"], stats["cache"]
    out = dict(frames=FRAMES, requests=len(requests), wall_s=walls,
               frames_per_s={k: [FRAMES / w for w in v]
                             for k, v in walls.items()},
               requests_per_s=tot["fps"], mpx_per_s=tot["mpx_per_s"],
               batch_occupancy=tot["batch_occupancy"],
               work_occupancy=tot["work_occupancy"], busy_chunks=busy,
               cap_chunks=cap, batches=tot["batches"],
               cache_hit_rate=cache["hit_rate"], cache=cache,
               counters=stats["counters"],
               launches={k: launched[k] for k in counters if launched[k]},
               buckets={label: dict(requests=b["requests"],
                                    batches=b["batches"],
                                    occupancy=b["batch_occupancy"],
                                    p50_ms=b["latency"]["p50_ms"],
                                    p99_ms=b["latency"]["p99_ms"])
                        for label, b in stats["buckets"].items()},
               check_s=check_s)
    log(f"serve: {len(requests)} requests of {FRAMES} frames equal to the "
        f"torch engine and across depths ({check_s:.1f} s)")
    log(f"serve totals: depth 2, 1, 1, 2: "
        f"{wall2:.3f} / {wall1:.3f} / {walls['depth1'][1]:.3f} / "
        f"{walls['depth2'][1]:.3f} s a pass ({FRAMES / wall2:.2f} / "
        f"{FRAMES / wall1:.2f} / {FRAMES / walls['depth1'][1]:.2f} / "
        f"{FRAMES / walls['depth2'][1]:.2f} frames/s); "
        f"metrics (the first depth-2 pass): {tot['fps']:.1f} requests/s, "
        f"{tot['mpx_per_s']:.1f} MPx/s, occupancy "
        f"{tot['batch_occupancy']:.3f}, work occupancy "
        f"{tot['work_occupancy']:.3f} (busy {busy} / cap {cap} chunks), "
        f"{tot['batches']} batches, cache hit rate {cache['hit_rate']:.3f} "
        f"({card})")
    for label, b in out["buckets"].items():
        log(f"serve bucket {label}: {b['requests']} requests in "
            f"{b['batches']} batches, occupancy {b['occupancy']:.3f}, "
            f"p50 {b['p50_ms']:.1f} ms, p99 {b['p99_ms']:.1f} ms ({card})")
    log(f"serve launches: {json.dumps(out['launches'])} ({card})")
    out["stages_s"] = serve_stages(svc2, requests)
    log(f"serve host stages (s, depth 2): "
        f"{json.dumps(out['stages_s'])} ({card})")
    out["trace"] = profile_run("serve/depth2",
                               lambda: serve_pass(svc2, requests), card)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"device: {name} | nvidia-smi: {smi} | kernel build "
        f"{build_s:.1f} s ({', '.join(p.name for p in libs)}) | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    checks = Checks()
    t0 = time.perf_counter()
    check_kernels(checks)
    check_qdt_kernels(checks)
    check_gdt_kernels(checks)
    log(f"kernels: {checks.count} kernel-vs-plain checks equal "
        f"({time.perf_counter() - t0:.1f} s)")

    counters = kernel_modules()
    t0 = time.perf_counter()
    images = {"uint8": stack(np.uint8), "float32": stack(np.float32),
              "uint16": stack(np.uint16, n=2, size=256)}
    cases = main_cases(images)
    log(f"main path: inputs ready ({time.perf_counter() - t0:.1f} s)")
    rows, launches = [], {}
    for slice_name, kernels in SLICES.items():
        for fn in counters.values():
            fn.launches = 0
        rows += run_main_path(cases[slice_name], counters)
        launches.update({k: counters[k].launches for k in kernels})
        missing = [k for k in kernels if not launches[k]]
        if missing:
            raise AssertionError(
                f"main path of the {slice_name} slice never launched "
                f"{missing}")
        log(f"main path ({slice_name}): launches "
            f"{ {k: launches[k] for k in kernels} }")
    time_main_path(rows, smi)
    traces = trace_main_path(rows, smi)

    timing = time_kernels(checks, images)
    timing.update(time_qdt_kernels(checks, images))
    timing.update(time_gdt_kernels(checks, images))
    for kname, t in timing.items():
        log(f"kernel {kname} [{t['shape']}]: {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({smi})")
    log(f"kernels: {checks.count} kernel-vs-plain checks equal in all")
    serving = run_serving(counters, smi)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "build_s": build_s,
         "checks": checks.count,
         "main_path": [{k: v for k, v in r.items() if k != "run"}
                       for r in rows],
         "traces": traces, "kernels": timing, "serving": serving},
        indent=1))
    log(smi)
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNEL_META[k][1],
             replaces=KERNEL_META[k][0], launches=launches[k],
             max_abs_err=checks.err[k],
             **{f: timing[k][f] for f in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        for k in KERNEL_META
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
