"""Fusion planner: the reference's ``ChainPlan``/``plan_chain``, with
the same fields, validation and decisions.

In the reference the plan fixes a Pallas kernel's VMEM block.  In this
port it fixes the *scheduling grid*: the row bands and column tiles
the requeue scheduler tracks, its activity flags and its compaction
capacity — and therefore ``ReconstructStats``.  It does not fix the
CUDA kernels' shared-memory tile: each kernel sub-tiles a cell into
blocks that fit one SM (``kernels/csrc/morph_chain.cu``), which is
exact because after K steps a centre pixel depends only on its
K-neighbourhood.  Keeping the planner identical keeps the scheduler
statistics comparable with the reference under the same inputs; the
constants below (``LANES``, ``SUBLANES``, ``DEFAULT_VMEM_BUDGET``) are
the reference's TPU numbers for that reason.  Retuning the plan for
Hopper is a later change.

Bandwidth model (per K-chunk, per band of TH rows, width W, dtype b):
    traffic       = (TH + 2K)·W·b read + TH·W·b write      (once)
    vs. unfused   = K · 2·TH·W·b                            (K round trips)
Redundant compute fraction = 2K / (TH + 2K).

Convergence-driven chains carry the scheduling policy fields
``requeue_halo``, ``tile_w`` and ``compact_threshold``; see the
reference module for their contract.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.backend import as_dtype

#: Working-set budget the reference planner sizes a band against.
DEFAULT_VMEM_BUDGET = 8 * 1024 * 1024

#: Width multiple of the padded working arrays.
LANES = 128
#: Row multiples of ``fuse_k`` per dtype size.
SUBLANES = {4: 8, 2: 16, 1: 32, 8: 8}

#: Bands per image the planner aims for on convergence-driven chains.
CONVERGENT_TARGET_BANDS = 16

#: Column tiles per band row the planner caps itself at.
CONVERGENT_TARGET_TILES = 16

#: Scheduling policies for convergence-driven chains.
SCHEDULES = ("wavefront", "raster")


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A schedule for a chain of S elementary filters over a vertical
    stack of ``n_images`` images; ``n_bands`` is *per image*."""

    band_h: int          # TH: rows of useful output per band
    fuse_k: int          # K: elementary filters fused per kernel launch
    width_pad: int       # W rounded up to a lane multiple
    height_pad: int      # H rounded up to a band multiple (per image)
    n_bands: int         # bands per image
    n_chunks: int        # ceil(S / K) kernel launches for a fixed chain
    n_images: int = 1    # images stacked vertically in the working array
    requeue_halo: int = 1        # tiles re-activated around a changed tile
    compact_threshold: float = 0.0   # active fraction below which to compact
    tile_w: int = 0      # column-tile width; 0 = full-width row bands
    schedule: str = "wavefront"  # "wavefront" (requeue) | "raster" (sweeps)

    def __post_init__(self):
        if self.band_h % self.fuse_k:
            raise ValueError(
                f"band_h={self.band_h} must be a multiple of "
                f"fuse_k={self.fuse_k}"
            )
        if self.height_pad % self.band_h:
            raise ValueError(
                f"height_pad={self.height_pad} must be a multiple of "
                f"band_h={self.band_h}"
            )
        if self.requeue_halo < 1:
            raise ValueError("requeue_halo must be >= 1 (neighbour influence)")
        if not 0.0 <= self.compact_threshold <= 1.0:
            raise ValueError("compact_threshold must be in [0, 1]")
        if self.tile_w < 0:
            raise ValueError(f"tile_w={self.tile_w} must be >= 0")
        if self.tile_w:
            if self.tile_w % self.fuse_k:
                raise ValueError(
                    f"tile_w={self.tile_w} must be a multiple of "
                    f"fuse_k={self.fuse_k} (or 0 for row-only bands)"
                )
            if self.width_pad % self.tile_w:
                raise ValueError(
                    f"width_pad={self.width_pad} must be a multiple of "
                    f"tile_w={self.tile_w}"
                )
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"schedule={self.schedule!r} must be one of {SCHEDULES}"
            )

    @property
    def key(self) -> tuple:
        """Hashable compact identity: exactly the fields that determine
        the schedule, in field order (``plan_from_key`` inverts it)."""
        return (self.band_h, self.fuse_k, self.width_pad, self.height_pad,
                self.n_bands, self.n_chunks, self.n_images,
                self.requeue_halo, self.compact_threshold, self.tile_w,
                self.schedule)

    @property
    def total_bands(self) -> int:
        """Vertical grid size for the stacked (n_images · height_pad) array."""
        return self.n_bands * self.n_images

    @property
    def n_tiles(self) -> int:
        """Column tiles per band row (1 when ``tile_w == 0``)."""
        return self.width_pad // self.tile_w if self.tile_w else 1

    @property
    def total_tiles(self) -> int:
        """Scheduling cells in the activity grid
        (``total_bands × n_tiles``)."""
        return self.total_bands * self.n_tiles

    @property
    def compact_capacity(self) -> int:
        """Static workspace size (cells) for the compacted grid."""
        return max(1, math.ceil(self.compact_threshold * self.total_tiles))

    @property
    def redundant_compute_fraction(self) -> float:
        return 2 * self.fuse_k / (self.band_h + 2 * self.fuse_k)

    @property
    def bandwidth_amplification(self) -> float:
        th, k = self.band_h, self.fuse_k
        return (2 * k * th) / (2 * th + 2 * k)


def plan_from_key(key: tuple) -> ChainPlan:
    """Rebuild a plan from ``ChainPlan.key`` — also from the reference's
    ``repro.core.chain.ChainPlan.key``, which has the same fields in the
    same order.  This is how a reference schedule is carried across to
    the port (e.g. to compare scheduler statistics)."""
    return ChainPlan(*key)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=as_dtype(dtype)).element_size()


def plan_chain(
    height: int,
    width: int,
    dtype,
    chain_len: int | None = None,
    *,
    vmem_budget: int = DEFAULT_VMEM_BUDGET,
    n_images_resident: int = 1,
    fuse_k: int | None = None,
    band_h: int | None = None,
    n_images: int = 1,
    convergent: bool = False,
    requeue_halo: int = 1,
    compact_threshold: float | None = None,
    tile_w: int | None = None,
    schedule: str = "wavefront",
) -> ChainPlan:
    """Choose (TH, K) exactly as ``repro.core.chain.plan_chain`` does."""
    b = _itemsize(dtype)
    w_pad = max(LANES, math.ceil(width / LANES) * LANES)
    sub = SUBLANES.get(b, 8)

    if fuse_k is None:
        fuse_k = 16 if b >= 4 else 32
    if chain_len is not None:
        fuse_k = min(fuse_k, max(1, chain_len))
    fuse_k = max(sub, math.ceil(fuse_k / sub) * sub)

    if band_h is None:
        per_row = (2 + n_images_resident) * w_pad * b
        band_h = max(fuse_k, (vmem_budget - 2 * fuse_k * per_row) // per_row)
        band_h = max(fuse_k, (band_h // fuse_k) * fuse_k)
        band_h = min(band_h, 512)
        if convergent:
            target = math.ceil(height / CONVERGENT_TARGET_BANDS)
            target = max(fuse_k, math.ceil(target / fuse_k) * fuse_k)
            band_h = min(band_h, target)

    if compact_threshold is None:
        compact_threshold = 0.5 if convergent else 0.0

    if tile_w is None:
        tile_w = _auto_tile_w(w_pad, fuse_k) if convergent else 0
    elif tile_w > 0:
        if tile_w < fuse_k:
            tile_w = 0
        else:
            tile_w = math.ceil(tile_w / fuse_k) * fuse_k
            if tile_w >= w_pad or w_pad % tile_w:
                tile_w = 0

    h_pad = math.ceil(height / band_h) * band_h
    n_bands = h_pad // band_h
    n_chunks = math.ceil((chain_len or fuse_k) / fuse_k)
    return ChainPlan(
        band_h, fuse_k, w_pad, h_pad, n_bands, n_chunks,
        n_images=n_images,
        requeue_halo=requeue_halo,
        compact_threshold=compact_threshold,
        tile_w=tile_w,
        schedule=schedule,
    )


def _auto_tile_w(w_pad: int, fuse_k: int) -> int:
    """Column-tile width for convergent plans (the reference's rule):
    the smallest lane-aligned ``fuse_k``-multiple dividing ``w_pad``
    with at most ``CONVERGENT_TARGET_TILES`` tiles, else the coarsest
    divisor; 0 when no divisor yields at least two tiles."""
    base = math.lcm(LANES, fuse_k)
    divisors = [k * base for k in range(1, w_pad // (2 * base) + 1)
                if w_pad % (k * base) == 0]
    for tile_w in divisors:
        if w_pad // tile_w <= CONVERGENT_TARGET_TILES:
            return tile_w
    return divisors[-1] if divisors else 0
