"""The CUDA launchers' geometry (check class e, ``index-map``): the port's
counterpart of ``repro.analysis.indexmaps``.

The reference proves its Pallas ``BlockSpec`` index maps by evaluating
them on every grid step.  The port's address arithmetic is C++: each
launcher (``kernels/csrc/{morph,qdt,gdt}_chain.cu``) picks a block shape
(``pick_shape``, one per source, with its own strip rows, thread limit
and tie-break), counts the sub-tiles of a cell (``morph::sub_tiles``)
and every block finds its window (``morph::locate``,
``kernels/csrc/morph_common.cuh``).  This module is a model of that
arithmetic in Python, exact to the integer, and proves three facts over
every window of a launch:

* **feasibility** — a block shape exists (otherwise the launcher
  returns ``cudaErrorInvalidValue``), the grid has at most 65535
  sub-tiles a cell, a block at most the launcher's threads, and its
  shared memory at most 227 KB;
* **bounds** — each window is its sub-tile and ``K`` pixels around it
  and fits the block; every source row and column it reads without
  pinning lies inside the array; the rows it pins are exactly those
  outside the cell's image (a stack's ``rows_per_image``, a compact
  patch's own rows), so nothing leaks between stacked images;
* **partition** — the sub-tiles' outputs lie inside their cells and
  cover every output pixel of the launch exactly once.

The launches themselves are the scheduler's (``kernels/ops.py``): a
fixed chain runs ``chain_step`` (or ``geodesic_chain_step``) on
band × full-width cells at every ``K`` of ``ops.chain_chunks``; a
convergent segment runs the row-band kernel (row-only plans) or the
band × ``tile_w`` kernel, and the compact kernel on ``cap`` stacked
``(band_h + 2K) × (tile_w + 2K)`` patches when the plan compacts.

The model is held against the library: every source exports its
geometry (``*_geometry``: the launchers' own ``shape_of``) and the
windows of a whole launch (``*_windows``: ``morph::locate`` on every
block), and :func:`compare_with_library` requires them equal field for
field (``chip_smoke.py`` on the card, ``tests/test_torch_cuda.py``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np

from repro_torch.analysis.findings import ERROR, WARN, Finding

__all__ = ["Launch", "Geo", "Shape", "Use", "KERNELS", "launch_shape",
           "locate", "windows", "check_feasibility", "check_windows",
           "check_partition", "check_launch", "plan_launches",
           "check_plan_index_maps", "executable_launches",
           "check_executable_launches", "compare_with_library"]

#: Shared memory a block may have (``cudaFuncAttributeMaxDynamic...``).
MAX_SMEM = 227 * 1024
#: Sub-tiles a cell may have: the grid's y dimension.
MAX_GRID_Y = 65535
#: Cells a launch may have: the grid's x dimension.
MAX_GRID_X = 2 ** 31 - 1

#: The launchers' dtype codes (``kernels/_build.py:DTYPE_CODES``).
DTYPE_CODES = {"uint8": 0, "uint16": 1, "int32": 2, "float32": 3,
               "float64": 4}
_ESIZE = {0: 1, 1: 2, 2: 4, 3: 4, 4: 8}

#: The QDT's packed uint8 body takes K < kSteps (``qdt_chain.cu``).
QDT_STEPS = 128

#: kernel wrapper → (source, cell layout, geodesic clamp)
KERNELS = {
    "chain_step": ("morph", "band", False),
    "geodesic_chain_step": ("morph", "band", True),
    "geodesic_tile_step": ("morph", "tile", True),
    "geodesic_compact_step": ("morph", "patch", True),
    "qdt_chain_step": ("qdt", "band", False),
    "qdt_tile_step": ("qdt", "tile", False),
    "qdt_compact_step": ("qdt", "patch", False),
    "gdt_chain_step": ("gdt", "band", False),
    "gdt_tile_step": ("gdt", "tile", False),
    "gdt_compact_step": ("gdt", "patch", False),
}

#: The fields of one window, in ``morph::Window``'s order.
WINDOW_FIELDS = ("tb", "tw", "WH", "WW", "wr", "wc", "rlo", "rhi", "orow",
                 "ocol")


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launcher call as the scheduler makes it.  For a band or tile
    kernel, ``rows`` × ``width`` is the stacked array (``N·H_pad`` ×
    ``W_pad``) cut into ``band_h`` × ``cell_w`` cells; for a compact
    kernel, ``rows`` is the workspace's patch count ``cap`` and each
    patch is ``(band_h + 2K) × (cell_w + 2K)``."""

    kernel: str
    dtype: str            # NumPy name
    k: int
    rows: int
    width: int
    band_h: int
    cell_w: int
    bands_per_image: int = 1
    lamb: float = 1.0     # the gdt's λ (0 takes the kUnit instance)

    @property
    def source(self) -> str:
        return KERNELS[self.kernel][0]

    @property
    def compact(self) -> bool:
        return KERNELS[self.kernel][1] == "patch"

    @property
    def n_cells(self) -> int:
        if self.compact:
            return self.rows
        return (self.rows // self.band_h) * (self.width // self.cell_w)

    @property
    def src_shape(self) -> tuple:
        if self.compact:
            return (self.rows * (self.band_h + 2 * self.k),
                    self.cell_w + 2 * self.k)
        return (self.rows, self.width)

    @property
    def out_shape(self) -> tuple:
        if self.compact:
            return (self.rows * self.band_h, self.cell_w)
        return (self.rows, self.width)

    def label(self) -> str:
        lay = (f"{self.rows} patches" if self.compact
               else f"{self.rows}x{self.width}")
        lam = f", lamb={self.lamb:g}" if self.source == "gdt" else ""
        return (f"{self.kernel}[{self.dtype}, K={self.k}, {lay}, cells "
                f"{self.band_h}x{self.cell_w}{lam}]")


@dataclasses.dataclass(frozen=True)
class Geo:
    """The geometry fields of ``morph::Geo`` for one launch (the
    pointers aside)."""

    src_w: int
    out_w: int
    k: int
    cell_h: int
    cell_w: int
    n_tiles: int
    rows_per_image: int
    compact: bool
    tb: int = 0
    tw: int = 0
    n_sub_c: int = 0


@dataclasses.dataclass(frozen=True)
class Shape:
    """A launch's block: the body (``mode``), ``ncol`` warps across and
    ``nstrip`` strips down, its shared memory, the sub-tiles a cell
    (``gridDim.y``) and what the body allows."""

    mode: int
    body: str
    ncol: int
    nstrip: int
    smem: int
    n_sub: int
    block_rows: int       # window rows the block's strips own
    block_cols: int       # window columns its warps own
    max_threads: int

    @property
    def threads(self) -> int:
        return 32 * self.ncol * self.nstrip


class Use(NamedTuple):
    """A kernel a plan launches, at ``k`` fused steps (``None``: the
    plan's ``fuse_k``) and, for the gdt, at ``lamb``."""

    kernel: str
    k: int | None = None
    lamb: float = 1.0


class _Body(NamedTuple):
    mode: int
    name: str
    rows: int        # strip rows a thread owns
    cols: int        # window columns a warp owns
    ring: int        # plane columns beyond them
    esize: int       # plane bytes a pixel
    max_threads: int
    planes: int
    more_blocks: bool  # tie-break at equal warps: more blocks, or fewer


# ---------------------------------------------------------------------------
# the launchers' arithmetic
# ---------------------------------------------------------------------------


def _stack_geo(w, band_h, cell_w, k, bands_per_image) -> Geo:
    """``morph::stack_geo``."""
    return Geo(src_w=w, out_w=w, k=k, cell_h=band_h, cell_w=cell_w,
               n_tiles=w // cell_w, rows_per_image=bands_per_image * band_h,
               compact=False)


def _patch_geo(band_h, tile_w, k) -> Geo:
    """``morph::patch_geo``."""
    return Geo(src_w=tile_w + 2 * k, out_w=tile_w, k=k, cell_h=band_h,
               cell_w=tile_w, n_tiles=1, rows_per_image=band_h + 2 * k,
               compact=True)


def launch_geo(launch: Launch) -> Geo:
    """The Geo a launcher builds for ``launch``."""
    if launch.compact:
        return _patch_geo(launch.band_h, launch.cell_w, launch.k)
    return _stack_geo(launch.width, launch.band_h, launch.cell_w, launch.k,
                      launch.bands_per_image)


def _pick_shape(g: Geo, b: _Body):
    """``pick_shape`` of the body's source: the (ncol, nstrip) that
    launches the fewest warps for the whole cell, ties broken by the
    block count (more for the morphology and QDT sources, fewer for the
    gdt) and then the widest sub-tile.  Returns ``(tb, tw, ncol,
    nstrip, smem)`` or None when nothing fits the threads and 227 KB."""
    warps_max = b.max_threads // 32
    best = None
    best_warps, best_blocks, best_tw = -1, 0, 0
    for ncol in range(1, warps_max + 1):
        for nstrip in range(1, warps_max // ncol + 1):
            tw = min(g.cell_w, b.cols * ncol - 2 * g.k)
            tb = min(g.cell_h, b.rows * nstrip - 2 * g.k)
            if tw < 1 or tb < 1:
                continue
            smem = (b.planes * (b.rows * nstrip + 2)
                    * (b.cols * ncol + b.ring) * b.esize)
            if smem > MAX_SMEM:
                continue
            blocks = (-(-g.cell_h // tb)) * (-(-g.cell_w // tw))
            warps = blocks * ncol * nstrip
            tie = (blocks > best_blocks if b.more_blocks
                   else blocks < best_blocks)
            if (best_warps < 0 or warps < best_warps
                    or (warps == best_warps
                        and (tie or (blocks == best_blocks
                                     and tw > best_tw)))):
                best_warps, best_blocks, best_tw = warps, blocks, tw
                best = (tb, tw, ncol, nstrip, smem)
    return best


def _bodies(launch: Launch, code: int) -> list:
    """The bodies the launcher tries for ``launch``, in order (the gdt
    probes ``kReg`` before ``kIwin``); empty when none takes it."""
    esize = _ESIZE[code]
    src = launch.source
    if src == "morph":
        rows = 16 if KERNELS[launch.kernel][2] else 32
        if code == 0:
            return [_Body(0, "morph_u8_kernel", rows, 128, 8, 1, 512, 2,
                          True)]
        return [_Body(1, "morph_pixel_kernel", rows, 32, 2, esize, 512, 2,
                      True)]
    if src == "qdt":
        if code == 0 and launch.k < QDT_STEPS:
            return [_Body(0, "qdt_u8_kernel", 16, 128, 8, 1, 512, 2, True)]
        return [_Body(1, "qdt_pixel_kernel", 16, 32, 2, esize, 512, 2,
                      True)]
    if code not in (3, 4):  # the gdt takes float planes only
        return []
    if launch.lamb == 0.0:
        return [_Body(0, "gdt_kernel<kUnit>", 16, 32, 2, esize, 512, 2,
                      False)]
    iwin = _Body(2, "gdt_kernel<kIwin>", 16, 32, 2, esize, 512, 3, False)
    if esize == 4:
        return [_Body(1, "gdt_kernel<kReg>", 16, 32, 2, esize, 384, 2,
                      False), iwin]
    return [iwin]


def sub_tiles(g: Geo) -> tuple:
    """``morph::sub_tiles``: ``(n_sub_c, n_sub)``, ``n_sub`` -1 past the
    grid's y dimension."""
    n_sub_c = -(-g.cell_w // g.tw)
    n_sub = -(-g.cell_h // g.tb) * n_sub_c
    return n_sub_c, (-1 if n_sub > MAX_GRID_Y else n_sub)


def launch_shape(launch: Launch):
    """The launcher's geometry for ``launch``: ``(Geo, Shape)`` with
    ``tb``/``tw``/``n_sub_c`` set, or ``(Geo, None)`` when the launcher
    returns an error (no body takes the dtype, K or the cell is
    degenerate, no shape fits, or too many sub-tiles a cell).
    ``Shape.n_sub`` is what ``morph::sub_tiles`` returned."""
    g = launch_geo(launch)
    code = DTYPE_CODES.get(launch.dtype)
    if code is None or g.k < 1 or g.cell_h < 1 or g.cell_w < 1:
        return g, None
    for b in _bodies(launch, code):
        picked = _pick_shape(g, b)
        if picked is None:
            continue
        tb, tw, ncol, nstrip, smem = picked
        g = dataclasses.replace(g, tb=tb, tw=tw)
        n_sub_c, n_sub = sub_tiles(g)
        g = dataclasses.replace(g, n_sub_c=n_sub_c)
        if n_sub < 0:
            return g, None
        return g, Shape(mode=b.mode, body=b.name, ncol=ncol, nstrip=nstrip,
                        smem=smem, n_sub=n_sub, block_rows=b.rows * nstrip,
                        block_cols=b.cols * ncol, max_threads=b.max_threads)
    return g, None


def geometry_tuple(g: Geo, sh: Shape) -> tuple:
    """What a source's ``*_geometry`` export returns:
    ``(mode, tb, tw, ncol, nstrip, smem, n_sub)``."""
    return (sh.mode, g.tb, g.tw, sh.ncol, sh.nstrip, sh.smem, sh.n_sub)


def locate(g: Geo, cell, sub):
    """``morph::locate`` for block ``(cell, sub)`` — on integers or on
    NumPy arrays of them.  Returns the window's fields in
    :data:`WINDOW_FIELDS` order."""
    k = g.k
    sr, sc = sub // g.n_sub_c, sub % g.n_sub_c
    tb = np.minimum(g.tb, g.cell_h - sr * g.tb)
    tw = np.minimum(g.tw, g.cell_w - sc * g.tw)
    if g.compact:
        pr = cell * (g.cell_h + 2 * k)
        wr = pr + sr * g.tb
        wc = sc * g.tw
        rlo, rhi = pr, pr + g.cell_h + 2 * k
        orow = cell * g.cell_h + sr * g.tb
        ocol = wc
    else:
        bi, tj = cell // g.n_tiles, cell % g.n_tiles
        band0 = bi * g.cell_h
        orow = band0 + sr * g.tb
        ocol = tj * g.cell_w + sc * g.tw
        wr, wc = orow - k, ocol - k
        rlo = band0 - band0 % g.rows_per_image
        rhi = rlo + g.rows_per_image
    return (tb, tw, tb + 2 * k, tw + 2 * k, wr, wc, rlo, rhi, orow, ocol)


def windows(g: Geo, n_cells: int, n_sub: int, locate=locate) -> np.ndarray:
    """Every window of a launch, cell-major: ``(n_cells · n_sub, 10)``
    int64, row ``cell · n_sub + sub`` — the layout of the sources'
    ``*_windows`` exports.  ``locate`` is injectable so the self-tests
    can seed a broken one."""
    cell = np.repeat(np.arange(n_cells, dtype=np.int64), n_sub)
    sub = np.tile(np.arange(n_sub, dtype=np.int64), n_cells)
    fields = locate(g, cell, sub)
    return np.stack([np.broadcast_to(np.asarray(f, np.int64), cell.shape)
                     for f in fields], axis=1)


# ---------------------------------------------------------------------------
# the three facts
# ---------------------------------------------------------------------------


def check_feasibility(launch: Launch, g: Geo, sh: Shape | None) -> list:
    """The launch runs at all: a shape exists, and it fits the grid, the
    block's threads and 227 KB."""
    subject = launch.label()
    out = []

    def err(msg):
        out.append(Finding("index-map", ERROR, subject, msg))

    if sh is None:
        code = DTYPE_CODES.get(launch.dtype)
        if code is None:
            err(f"no launcher takes {launch.dtype} (dtype codes "
                f"{sorted(DTYPE_CODES)}) — the wrapper raises TypeError "
                "on the card")
        elif not _bodies(launch, code):
            err(f"no body of {launch.source}_chain.cu takes "
                f"{launch.dtype} — the launcher returns "
                "cudaErrorInvalidValue")
        else:
            err(f"no block shape for K={g.k} on {g.cell_h}x{g.cell_w} "
                "cells fits the threads and 227 KB, or a cell needs more "
                f"than {MAX_GRID_Y} sub-tiles — the launcher returns "
                "cudaErrorInvalidValue")
        return out
    if launch.n_cells > MAX_GRID_X:
        err(f"{launch.n_cells} cells exceed the grid's x dimension")
    if not 1 <= sh.n_sub <= MAX_GRID_Y:
        err(f"{sh.n_sub} sub-tiles a cell: the grid's y dimension takes "
            f"1..{MAX_GRID_Y}")
    if sh.threads > sh.max_threads:
        err(f"{sh.threads} threads a block exceed {sh.body}'s "
            f"{sh.max_threads}")
    if sh.smem > MAX_SMEM:
        err(f"{sh.smem} bytes of shared memory exceed the {MAX_SMEM} a "
            "block may have — the launch is refused")
    return out


def _src_of_out(launch: Launch, cell, orow, ocol):
    """The source pixel of output pixel (orow, ocol) of ``cell``."""
    if launch.compact:
        k = launch.k
        return (cell * (launch.band_h + 2 * k) + orow
                - cell * launch.band_h + k, ocol + k)
    return orow, ocol


def _cell_rect(launch: Launch, cell):
    """(r0, r1, c0, c1) of ``cell``'s output pixels."""
    if launch.compact:
        r0 = cell * launch.band_h
        c0 = np.zeros_like(cell)
        return r0, r0 + launch.band_h, c0, c0 + launch.cell_w
    n_tiles = launch.width // launch.cell_w
    r0 = (cell // n_tiles) * launch.band_h
    c0 = (cell % n_tiles) * launch.cell_w
    return r0, r0 + launch.band_h, c0, c0 + launch.cell_w


def _image_rows(launch: Launch, cell):
    """The source rows of ``cell``'s image: the stacked image it lies in,
    or its own patch."""
    if launch.compact:
        lo = cell * (launch.band_h + 2 * launch.k)
        return lo, lo + launch.band_h + 2 * launch.k
    rpi = launch.bands_per_image * launch.band_h
    n_tiles = launch.width // launch.cell_w
    lo = ((cell // n_tiles) * launch.band_h // rpi) * rpi
    return lo, lo + rpi


def _first(mask, n_sub: int) -> str:
    i = int(np.flatnonzero(mask)[0])
    return f"block (cell {i // n_sub}, sub-tile {i % n_sub})"


def check_windows(launch: Launch, g: Geo, sh: Shape, wins=None,
                  locate=locate) -> list:
    """Bounds proof over every window of ``launch``: each is its
    sub-tile's K-neighbourhood and fits the block, reads unpinned rows
    and columns only inside the source array, and pins exactly the rows
    outside its cell's image."""
    if wins is None:
        wins = windows(g, launch.n_cells, sh.n_sub, locate)
    subject = launch.label()
    out = []
    n_sub = sh.n_sub
    cell = np.arange(len(wins), dtype=np.int64) // max(n_sub, 1)
    tb, tw, wh, ww, wr, wc, rlo, rhi, orow, ocol = wins.T
    k = launch.k
    src_h, src_w = launch.src_shape

    def err(mask, msg):
        if mask.any():
            out.append(Finding(
                "index-map", ERROR, subject,
                f"{int(mask.sum())} window(s), e.g. {_first(mask, n_sub)}: "
                f"{msg}"))

    sr, sc = _src_of_out(launch, cell, orow, ocol)
    err((wh != tb + 2 * k) | (ww != tw + 2 * k) | (wr + k != sr)
        | (wc + k != sc),
        f"the window is not the sub-tile and its {k}-pixel halo — the "
        "centre would be computed from the wrong neighbourhood")
    err((wh > sh.block_rows) | (ww > sh.block_cols),
        f"the window outgrows the block's {sh.block_rows}x"
        f"{sh.block_cols} pixels — part of it is never computed")
    if g.src_w != src_w:
        out.append(Finding("index-map", ERROR, subject,
                           f"row stride {g.src_w} != the source width "
                           f"{src_w}"))
    # unpinned rows: the window's rows inside [rlo, rhi)
    ulo, uhi = np.maximum(wr, rlo), np.minimum(wr + wh, rhi)
    err((ulo < uhi) & ((ulo < 0) | (uhi > src_h)),
        f"reads unpinned rows outside the source's {src_h} rows")
    # the kernel pins columns outside [0, src_w) itself; what it reads
    # must be a real column of the array
    clo, chi = np.maximum(wc, 0), np.minimum(wc + ww, g.src_w)
    err((clo < chi) & (chi > src_w),
        f"reads columns past the source's {src_w}")
    # pinned rows: exactly the window's rows outside the cell's image
    ilo, ihi = _image_rows(launch, cell)
    vlo, vhi = np.maximum(wr, ilo), np.minimum(wr + wh, ihi)
    same = ((ulo >= uhi) & (vlo >= vhi)) | ((ulo == vlo) & (uhi == vhi))
    err(~same,
        "pins other rows than those outside the cell's image "
        f"(rows_per_image={g.rows_per_image}) — values would leak "
        "between images, or image rows would read as identity")
    return out


def _coverage(r0, r1, c0, c1, h: int, w: int):
    """How often each pixel of an (h, w) output is written by the
    rectangles [r0, r1) × [c0, c1): over a grid compressed to the
    rectangles' edges.  Returns (counts, row edges, column edges)."""
    keep = (r1 > r0) & (c1 > c0)
    r0, r1, c0, c1 = r0[keep], r1[keep], c0[keep], c1[keep]
    re = np.unique(np.concatenate([r0, r1, [0, h]]))
    ce = np.unique(np.concatenate([c0, c1, [0, w]]))
    diff = np.zeros((len(re), len(ce)), np.int64)
    i0, i1 = np.searchsorted(re, r0), np.searchsorted(re, r1)
    j0, j1 = np.searchsorted(ce, c0), np.searchsorted(ce, c1)
    np.add.at(diff, (i0, j0), 1)
    np.add.at(diff, (i0, j1), -1)
    np.add.at(diff, (i1, j0), -1)
    np.add.at(diff, (i1, j1), 1)
    return diff.cumsum(0).cumsum(1)[:-1, :-1], re, ce


def check_partition(launch: Launch, g: Geo, sh: Shape, wins=None,
                    locate=locate) -> list:
    """Partition proof: every sub-tile writes inside its cell, and the
    sub-tiles of the launch write every output pixel exactly once."""
    if wins is None:
        wins = windows(g, launch.n_cells, sh.n_sub, locate)
    subject = launch.label()
    out = []
    n_sub = max(sh.n_sub, 1)
    cell = np.arange(len(wins), dtype=np.int64) // n_sub
    tb, tw, orow, ocol = wins[:, 0], wins[:, 1], wins[:, 8], wins[:, 9]
    r0, r1 = orow, orow + np.maximum(tb, 0)
    c0, c1 = ocol, ocol + np.maximum(tw, 0)
    x0, x1, y0, y1 = _cell_rect(launch, cell)
    spill = (tb > 0) & (tw > 0) & ((r0 < x0) | (r1 > x1) | (c0 < y0)
                                   | (c1 > y1))
    if spill.any():
        out.append(Finding(
            "index-map", ERROR, subject,
            f"{int(spill.sum())} sub-tile(s), e.g. "
            f"{_first(spill, n_sub)}, write outside their cell — another "
            "cell's pixels (or the array's end) are overwritten"))
    h, w = launch.out_shape
    counts, re, ce = _coverage(r0, r1, c0, c1, h, w)
    inside = ((re[:-1, None] < h) & (re[:-1, None] >= 0)
              & (ce[None, :-1] < w) & (ce[None, :-1] >= 0))
    for mask, what in ((inside & (counts > 1), "written more than once "
                        "— blocks race on them"),
                       (inside & (counts == 0), "never written — those "
                        "outputs are never produced"),
                       (~inside & (counts > 0), "outside the output "
                        f"array ({h}x{w}) written")):
        if mask.any():
            i, j = np.argwhere(mask)[0]
            n_px = int(((re[1:] - re[:-1])[:, None]
                        * (ce[1:] - ce[:-1])[None, :])[mask].sum())
            out.append(Finding(
                "index-map", ERROR, subject,
                f"{n_px} output pixel(s) {what} (e.g. ({int(re[i])}, "
                f"{int(ce[j])}))"))
    return out


def check_launch(launch: Launch, locate=locate) -> list:
    """All three facts for one launch, on the model's own geometry."""
    g, sh = launch_shape(launch)
    out = check_feasibility(launch, g, sh)
    if sh is None or out:
        return out
    wins = windows(g, launch.n_cells, sh.n_sub, locate)
    return (out + check_windows(launch, g, sh, wins)
            + check_partition(launch, g, sh, wins))


# ---------------------------------------------------------------------------
# the launches of a plan and of an executable
# ---------------------------------------------------------------------------


def _degenerate(plan) -> bool:
    return (plan.fuse_k < 1 or plan.band_h < plan.fuse_k
            or plan.band_h % plan.fuse_k or plan.height_pad % plan.band_h
            or plan.width_pad < 1 or plan.n_images < 1
            or (plan.tile_w and (plan.tile_w % plan.fuse_k
                                 or plan.width_pad % plan.tile_w)))


def plan_launches(plan, dtype, kinds) -> list:
    """The :class:`Launch` of each kernel in ``kinds`` (wrapper names or
    :class:`Use`) under ``plan``, as the scheduler lays it out: band
    kernels on band × full-width cells, tile kernels on band ×
    ``tile_w`` cells (none without ``tile_w``), compact kernels on
    ``compact_capacity`` patches of the cell width (``tile_w``, or the
    full width of a row-only plan)."""
    from repro_torch.core.backend import as_dtype, numpy_dtype

    name = numpy_dtype(as_dtype(dtype)).name
    rows = plan.n_images * plan.height_pad
    out = []
    for use in kinds:
        use = Use(use) if isinstance(use, str) else Use(*use)
        k = plan.fuse_k if use.k is None else use.k
        layout = KERNELS[use.kernel][1]
        common = dict(kernel=use.kernel, dtype=name, k=k,
                      band_h=plan.band_h, lamb=use.lamb)
        if layout == "band":
            out.append(Launch(rows=rows, width=plan.width_pad,
                              cell_w=plan.width_pad,
                              bands_per_image=plan.n_bands, **common))
        elif layout == "tile":
            if plan.tile_w:
                out.append(Launch(rows=rows, width=plan.width_pad,
                                  cell_w=plan.tile_w,
                                  bands_per_image=plan.n_bands, **common))
        else:
            cw = plan.tile_w or plan.width_pad
            out.append(Launch(rows=plan.compact_capacity,
                              width=cw + 2 * k, cell_w=cw, **common))
    return out


def check_plan_index_maps(plan, dtype, kinds) -> list:
    """Feasibility, bounds and partition of every launch of ``kinds``
    under ``plan`` in ``dtype`` (the reference's name; its BlockSpec
    enumeration becomes the launch model).  Degenerate plans (reported
    by ``repro_torch.analysis.plans``) are skipped."""
    if _degenerate(plan):
        return []
    out = []
    for launch in plan_launches(plan, dtype, kinds):
        out += check_launch(launch)
    return out


def _plan_uses(segs, plan) -> list:
    """The kernels ``segs`` launch under ``plan`` (``kernels/ops.py``'s
    choices: ``chain_chunks`` for fixed chains; the tile kernel when the
    plan has column tiles, else the row-band kernel; the compact kernel
    when the plan compacts; no kernel for the raster gdt)."""
    from repro_torch.kernels.ops import chain_chunks, compacts

    uses = []
    for seg in segs:
        if seg.kind in ("chain", "geodesic"):
            name = ("chain_step" if seg.kind == "chain"
                    else "geodesic_chain_step")
            uses += [Use(name, k) for k in
                     sorted(set(chain_chunks(seg.param("n"), plan)))]
            continue
        if seg.kind not in ("reconstruct", "qdt", "gdt"):
            continue
        if seg.kind == "gdt" and plan.schedule == "raster":
            continue
        pre = {"reconstruct": "geodesic", "qdt": "qdt", "gdt": "gdt"}[
            seg.kind]
        lamb = seg.param("lamb") if seg.kind == "gdt" else 1.0
        full = "tile" if plan.n_tiles > 1 else "chain"
        uses.append(Use(f"{pre}_{full}_step", plan.fuse_k, lamb))
        if compacts(plan):
            uses.append(Use(f"{pre}_compact_step", plan.fuse_k, lamb))
    return list(dict.fromkeys(uses))


def executable_launches(exe) -> list:
    """Every distinct :class:`Launch` the ``"cuda"`` engine makes for
    ``exe`` (none for the ``"torch"`` engine)."""
    if exe.backend != "cuda" or exe.plan is None:
        return []
    segs = exe.program.segments
    groups = (exe.seg_plans if exe.seg_plans is not None
              else ((tuple(range(len(segs))), exe.plan),))
    out = []
    for idxs, plan in groups:
        if _degenerate(plan):
            continue
        out += plan_launches(plan, exe.dtype,
                             _plan_uses([segs[i] for i in idxs], plan))
    return list(dict.fromkeys(out))


def check_executable_launches(exe) -> list:
    """The three facts for every launch of ``exe``.  A dtype no launcher
    takes fails on the card (ERROR for a CUDA executable); on the CPU
    the kernel wrappers run their plain versions (WARN)."""
    launches = executable_launches(exe)
    if not launches:
        return []
    name = launches[0].dtype
    if name not in DTYPE_CODES:
        on_card = exe.device.type == "cuda"
        return [Finding(
            "index-map", ERROR if on_card else WARN, f"dtype {name}",
            f"no CUDA launcher takes {name} (dtype codes "
            f"{sorted(DTYPE_CODES)}): the kernels raise TypeError on the "
            "card" + ("" if on_card else
                      "; this CPU executable runs the plain versions"))]
    out = []
    for launch in launches:
        out += check_launch(launch)
    return out


# ---------------------------------------------------------------------------
# the model against the library's own geometry
# ---------------------------------------------------------------------------


def _library_args(launch: Launch) -> list:
    code = DTYPE_CODES[launch.dtype]
    args = [code]
    if launch.source == "morph":
        args.append(int(KERNELS[launch.kernel][2]))
    args += [int(launch.compact), launch.rows, launch.width, launch.band_h,
             launch.cell_w, launch.k, launch.bands_per_image]
    if launch.source == "gdt":
        args.append(float(launch.lamb))
    return args


def library_geometry(launch: Launch):
    """The library's geometry of ``launch`` (``*_geometry`` and
    ``*_windows`` of its source, built on first use): ``(tuple, windows
    array)``, or ``(error code, None)`` when the launcher would fail."""
    from repro_torch.kernels import _build

    args = _library_args(launch)
    shape = (ctypes.c_longlong * 7)()
    code = _build.launcher(f"{launch.source}_geometry")(*args, shape)
    if code:
        return code, None
    geo = tuple(int(v) for v in shape)
    wins = np.zeros((launch.n_cells * geo[6], len(WINDOW_FIELDS)), np.int64)
    code = _build.launcher(f"{launch.source}_windows")(
        *args, wins.ctypes.data_as(ctypes.c_void_p))
    if code:
        return code, None
    return geo, wins


def compare_with_library(launch: Launch) -> tuple:
    """Hold the model against the library on ``launch``: the geometry
    tuple and every window must be equal field for field.  Returns
    ``(findings, windows compared)``."""
    g, sh = launch_shape(launch)
    got, lib_wins = library_geometry(launch)
    subject = launch.label()
    if sh is None or lib_wins is None:
        if sh is None and lib_wins is None:
            return [], 0
        return [Finding("index-map", ERROR, subject,
                        f"model {'fails' if sh is None else 'launches'} "
                        f"but the library "
                        f"{'launches' if sh is None else f'fails ({got})'}"
                        )], 0
    want = geometry_tuple(g, sh)
    if got != want:
        return [Finding("index-map", ERROR, subject,
                        f"geometry (mode, tb, tw, ncol, nstrip, smem, "
                        f"n_sub): library {got} != model {want}")], 0
    model = windows(g, launch.n_cells, sh.n_sub)
    bad = (model != lib_wins).any(axis=1)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        return [Finding("index-map", ERROR, subject,
                        f"{int(bad.sum())} of {len(model)} windows differ, "
                        f"e.g. block {i}: library "
                        f"{dict(zip(WINDOW_FIELDS, lib_wins[i].tolist()))} "
                        f"!= model "
                        f"{dict(zip(WINDOW_FIELDS, model[i].tolist()))}")
                ], len(model)
    return [], len(model)
