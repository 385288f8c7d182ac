"""ChainPlan constraint checking (check class c; port of
``repro.analysis.plans``).

Re-derives the planner/kernel contract from first principles and
checks a plan against it — deliberately *not* by calling
``ChainPlan.__post_init__`` (mutation tests forge plans past it with
``object.__new__``, which is also what a deserialized or hand-built
plan could do):

* band decomposition: ``band_h % fuse_k == 0`` (the kernel runs
  ``fuse_k`` elementary steps on a ``band_h + 2·fuse_k`` stack),
  ``height_pad % band_h == 0``, ``n_bands·band_h == height_pad``;
* ragged-width fallback: ``tile_w`` is 0 (row-only) or tiles the padded
  width in ``fuse_k`` multiples — a ragged column tile would leave the
  scheduler's cells off the launch grid;
* requeue exactness: influence propagates at most ``fuse_k`` px per
  chunk (Chebyshev), so ``fuse_k ≤ requeue_halo · band_h`` and, when
  column-tiled, ``fuse_k ≤ requeue_halo · tile_w`` — otherwise a
  wavefront outruns the re-activated neighbourhood and convergence is
  detected too early;
* compaction capacity within the activity grid.

The reference's Mosaic-readiness diagnostics (the TPU compiler's lane
and sublane rules) have no counterpart: no Hopper launch obeys them.
What a CUDA launch must satisfy (a block shape, the grid's sub-tile
limit, threads, 227 KB of shared memory) is proved per launch by
``repro_torch.analysis.indexmaps``.
"""
from __future__ import annotations

from repro_torch.analysis.findings import ERROR, Finding

__all__ = ["check_plan"]


def check_plan(plan, shape3=None) -> list:
    """Structural constraints of one :class:`ChainPlan`."""
    out = []

    def err(msg):
        out.append(Finding("plan", ERROR, "plan", msg))

    if plan.fuse_k < 1:
        err(f"fuse_k={plan.fuse_k} < 1")
        return out
    if plan.band_h < plan.fuse_k:
        err(f"band_h={plan.band_h} < fuse_k={plan.fuse_k}: the band "
            "cannot carry one launch's halo")
    if plan.band_h % plan.fuse_k:
        err(f"band_h={plan.band_h} not a multiple of fuse_k="
            f"{plan.fuse_k}: halo blocks would straddle band borders")
    if plan.height_pad < 1 or plan.height_pad % plan.band_h:
        err(f"height_pad={plan.height_pad} not a positive multiple of "
            f"band_h={plan.band_h}")
    elif plan.n_bands != plan.height_pad // plan.band_h:
        err(f"n_bands={plan.n_bands} != height_pad/band_h="
            f"{plan.height_pad // plan.band_h}")
    if plan.width_pad < 1:
        err(f"width_pad={plan.width_pad} < 1")
    if plan.n_images < 1:
        err(f"n_images={plan.n_images} < 1")
    if plan.n_chunks < 1:
        err(f"n_chunks={plan.n_chunks} < 1")
    # re-derived from core.chain.SCHEDULES by value, not by import, so
    # a forged plan with a typo'd schedule is caught here too
    if getattr(plan, "schedule", "wavefront") not in ("wavefront",
                                                      "raster"):
        err(f"schedule={plan.schedule!r} is not a known schedule "
            "('wavefront' | 'raster') — the executable would fall "
            "through to the wavefront path silently")

    if plan.tile_w < 0:
        err(f"tile_w={plan.tile_w} < 0")
    elif plan.tile_w:
        if plan.tile_w % plan.fuse_k:
            err(f"tile_w={plan.tile_w} not a multiple of fuse_k="
                f"{plan.fuse_k} (ragged-width plans must fall back to "
                "tile_w=0 row bands)")
        if plan.width_pad % plan.tile_w:
            err(f"width_pad={plan.width_pad} not a multiple of tile_w="
                f"{plan.tile_w} (ragged last tile; the fallback "
                "contract is tile_w=0)")

    if plan.requeue_halo < 1:
        err(f"requeue_halo={plan.requeue_halo} < 1: changed cells "
            "would not re-activate their neighbours")
    else:
        reach = plan.fuse_k  # Chebyshev influence per K-chunk
        if reach > plan.requeue_halo * plan.band_h:
            err(f"fuse_k={plan.fuse_k} exceeds requeue_halo·band_h="
                f"{plan.requeue_halo * plan.band_h}: per-chunk influence "
                "outruns the re-activated rows — convergence would be "
                "detected early")
        if plan.tile_w and reach > plan.requeue_halo * plan.tile_w:
            err(f"fuse_k={plan.fuse_k} exceeds requeue_halo·tile_w="
                f"{plan.requeue_halo * plan.tile_w}: per-chunk influence "
                "outruns the re-activated columns")

    if not 0.0 <= plan.compact_threshold <= 1.0:
        err(f"compact_threshold={plan.compact_threshold} outside [0, 1]")
    elif plan.compact_threshold and plan.band_h and plan.width_pad:
        try:
            cap = plan.compact_capacity
        except Exception:  # degenerate fields above already reported
            cap = None
        if cap is not None and not 1 <= cap <= max(1, plan.total_tiles):
            err(f"compact_capacity={cap} outside [1, total_tiles="
                f"{plan.total_tiles}]")

    if shape3 is not None:
        n, h, w = shape3
        if plan.n_images != n:
            out.append(Finding("plan", ERROR, "plan/shape",
                               f"n_images={plan.n_images} != batch {n}"))
        if plan.height_pad < h:
            out.append(Finding("plan", ERROR, "plan/shape",
                               f"height_pad={plan.height_pad} < image "
                               f"height {h}"))
        if plan.width_pad < w:
            out.append(Finding("plan", ERROR, "plan/shape",
                               f"width_pad={plan.width_pad} < image "
                               f"width {w}"))
    return out

