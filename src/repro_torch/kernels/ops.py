"""Scheduler engine over the fused kernels (port of ``repro.kernels.ops``,
main-path part).

This module owns the *engine*: padding/stacking layout helpers, the
fixed-chain drivers (``morph_chain``, ``geodesic_chain``), the
active-cell requeue scheduler (``_drive_scheduler`` and the
``_scheduled_reconstruct`` / ``_scheduled_qdt`` / ``_scheduled_gdt``
step bundles) and the gdt's raster sweeps (``_raster_gdt``) and Jacobi
oracle (``gdt_fixpoint``) that ``repro_torch.api``'s executables drive.
The operator sugar (``erode``/``dilate``/``opening``/``closing``/
``reconstruct``/``qdt_planes``/``gdt``) builds an expression and routes
through ``repro_torch.api.compile``.

Every entry point runs on ``device`` (``None`` is the GPU, which raises
without one; the CPU must be asked for with ``device="cpu"``) and moves
its inputs there.  The kernel wrappers underneath follow the tensors
they are given.

``backend``:
  * ``"cuda"`` (``None``) — the padded engine on the fused kernels: the
    hand-written CUDA kernels on CUDA tensors, their plain PyTorch
    versions on CPU tensors.
  * ``"torch"`` — the ``core.morphology`` oracle bodies, unpadded.

Batching: every entry point accepts an (H, W) image or an (N, H, W)
stack, laid out vertically as one (N·H_pad, W_pad) working array; halo
pinning at image edges (``bands_per_image``) keeps the images
independent.

Active-cell requeue scheduling (the paper's Alg. 4, extended to 2-D)
follows the reference exactly: cells are row bands (``plan.tile_w ==
0``) or band × column tiles; a cell is requeued for the next K-chunk
iff it or a Chebyshev neighbour changed; inactive cells are skipped by
the kernel; below ``plan.compact_threshold`` activity the driver
gathers the active cells' (band_h+2K, tile_w+2K) patches into a
workspace of fixed capacity ``plan.compact_capacity`` and scatters the
centres back.  The reference loop runs on the device
(``lax.while_loop``); here it is a host loop that reads the activity
grid back once per chunk — one synchronisation per chunk — and decides
from that copy whether to continue, whether to compact, and whether
the cached mask patches still match the active set.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import morphology as M
from repro_torch.core.backend import canonicalize_backend, resolve_device
from repro_torch.core.chain import ChainPlan, plan_chain
from repro_torch.kernels.common import (as_bits, bits_value, cell_view,
                                        cells_to_plane, from_bits,
                                        gather_windows, ident_for,
                                        qdt_acc_dtype)
from repro_torch.kernels.erode_chain import chain_step
from repro_torch.kernels.gdt_chain import (D_IDENT, I_IDENT, S_IDENT,
                                           gdt_chain_step, gdt_compact_step,
                                           gdt_tile_step, gdt_weights, relax,
                                           shift2)
from repro_torch.kernels.geodesic_chain import (geodesic_chain_step,
                                                geodesic_compact_step,
                                                geodesic_tile_step)
from repro_torch.kernels.qdt_chain import (qdt_chain_step, qdt_compact_step,
                                           qdt_tile_step)


def _api():
    from repro_torch import api  # lazy: repro_torch.api builds on this

    return api


class ReconstructStats(NamedTuple):
    """Per-run scheduling statistics (the paper's Table 5 chain lengths,
    extended with the requeue scheduler's cell-level accounting).

    The unit is one *scheduling cell*: a full-width row band for
    row-only plans, a band × column tile for tiled plans; for tiled
    plans ``total_bands`` reports ``plan.total_tiles``.  ``converged``
    is True iff every image's active set emptied within the chunk
    budget.  Fields are CPU tensors (int32 counts, a bool verdict)."""

    chunks: torch.Tensor           # K-chunk iterations executed
    active_band_sum: torch.Tensor  # Σ scheduled cells over all chunks
    total_bands: torch.Tensor      # cells in the padded stack
    active_per_chunk: torch.Tensor  # int32[max_chunks], 0 past ``chunks``
    converged: torch.Tensor = torch.tensor(True)


# ---------------------------------------------------------------------------
# layout helpers: batch promotion, padding, vertical stacking
# ---------------------------------------------------------------------------


def _as_stack(f: torch.Tensor):
    """Promote (H, W) to (1, H, W); pass (N, H, W) through."""
    if f.ndim == 2:
        return f[None], True
    if f.ndim == 3:
        return f, False
    raise ValueError(f"expected (H, W) or (N, H, W), got shape "
                     f"{tuple(f.shape)}")


def _pad(f3: torch.Tensor, plan: ChainPlan, fill) -> torch.Tensor:
    _, h, w = f3.shape
    padded = F.pad(as_bits(f3), (0, plan.width_pad - w, 0,
                                 plan.height_pad - h),
                   value=bits_value(fill, f3.dtype))
    return from_bits(padded, f3.dtype)


def _crop(f3: torch.Tensor, shape, was_2d: bool) -> torch.Tensor:
    out = f3[:, : shape[-2], : shape[-1]]
    return out[0] if was_2d else out


def _crop3(x2: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(N·H_pad, W_pad) stacked working array → unpadded (N, H, W)."""
    return _unstacked(x2, n)[:, :h, :w]


def _reband(x2: torch.Tensor, n: int, h: int, w: int, plan: ChainPlan,
            fill) -> torch.Tensor:
    """Move a stacked working array into ``plan``'s band layout: crop
    the real image region and re-pad it with ``fill``."""
    return _stacked(_pad(_crop3(x2, n, h, w), plan, fill))


def _stacked(x3: torch.Tensor) -> torch.Tensor:
    """(N, H_pad, W_pad) → (N·H_pad, W_pad)."""
    return x3.reshape(x3.shape[0] * x3.shape[1], x3.shape[2])


def _unstacked(x2: torch.Tensor, n: int) -> torch.Tensor:
    return x2.reshape(n, x2.shape[0] // n, x2.shape[1])


def _on_device(device, *tensors):
    """``tensors`` moved to ``device`` (``None`` is the GPU)."""
    device = resolve_device(device)
    return tuple(torch.as_tensor(t, device=device) for t in tensors)


def _plan_for(f3: torch.Tensor, plan: ChainPlan | None) -> None:
    """Validate an explicitly supplied plan against the input stack."""
    if plan is None:
        return
    n, h, w = f3.shape
    if plan.n_images != n:
        raise ValueError(f"plan.n_images={plan.n_images} != batch size {n}")
    if plan.height_pad < h or plan.width_pad < w:
        raise ValueError(
            f"plan pads ({plan.height_pad}, {plan.width_pad}) smaller than "
            f"image ({h}, {w})"
        )


# ---------------------------------------------------------------------------
# active-cell bookkeeping (cell = row band × column tile; n_tiles may be 1)
# ---------------------------------------------------------------------------


def _cell_tile_w(plan: ChainPlan) -> int:
    """Pixel width of one scheduling cell (full width for row-only)."""
    return plan.tile_w or plan.width_pad


def _dilate_active(flags: torch.Tensor, plan: ChainPlan) -> torch.Tensor:
    """Requeue set from changed flags: a cell is active next chunk iff it
    or a Chebyshev neighbour within its image changed (separable
    row-then-column max = the 3×3 dilation)."""
    a = flags.reshape(plan.n_images, plan.n_bands, plan.n_tiles)
    for _ in range(plan.requeue_halo):
        up = F.pad(a[:, 1:], (0, 0, 0, 1))
        dn = F.pad(a[:, :-1], (0, 0, 1, 0))
        a = torch.maximum(a, torch.maximum(up, dn))
        if plan.n_tiles > 1:
            lf = F.pad(a[:, :, 1:], (0, 1))
            rt = F.pad(a[:, :, :-1], (1, 0))
            a = torch.maximum(a, torch.maximum(lf, rt))
    return a.reshape(plan.total_bands, plan.n_tiles)


def _gather_patches(x2: torch.Tensor, idx: torch.Tensor, plan: ChainPlan,
                    ident) -> torch.Tensor:
    """Gather (band_h+2K, tile_w+2K) halo patches for flat cell indices
    ``idx`` → (C·(band_h+2K), tile_w+2K), pinned at image and array
    edges; sentinel slots (idx == total_tiles) come back all-``ident``."""
    tw, k = _cell_tile_w(plan), plan.fuse_k
    win = gather_windows(x2, idx, band_h=plan.band_h, tile_w=tw, fuse_k=k,
                         n_tiles=plan.n_tiles,
                         bands_per_image=plan.n_bands, ident=ident)
    return win.reshape(-1, tw + 2 * k)


def _cell_view(x2: torch.Tensor, plan: ChainPlan) -> torch.Tensor:
    """(TOTAL_H, W) → (total_tiles, band_h, tile_w) cell-major copy."""
    return cell_view(x2, plan.band_h, _cell_tile_w(plan))


def _gather_mid(x2: torch.Tensor, idx: torch.Tensor,
                plan: ChainPlan) -> torch.Tensor:
    """Gather the centre windows of cells ``idx`` → (C·band_h, tile_w);
    sentinel indices clip to the last cell."""
    cells = as_bits(_cell_view(x2, plan))
    got = cells[idx.long().clamp(max=plan.total_tiles - 1)]
    return from_bits(got, x2.dtype).reshape(-1, _cell_tile_w(plan))


def _scatter_mid(x2: torch.Tensor, idx: torch.Tensor, new_mid: torch.Tensor,
                 plan: ChainPlan) -> torch.Tensor:
    """Scatter workspace centre windows back into a new array.  Sentinel
    slots (idx == total_tiles) land in one extra scratch cell that is
    cut off afterwards — torch's scatter has no drop mode."""
    bh, tw = plan.band_h, _cell_tile_w(plan)
    cells = as_bits(_cell_view(x2, plan))
    cells = torch.cat([cells, cells.new_empty((1, bh, tw))])
    cells[idx.long()] = as_bits(new_mid).reshape(-1, bh, tw)
    return from_bits(cells_to_plane(cells[:-1], plan.n_tiles), x2.dtype)


def _scatter_flags(ch: torch.Tensor, idx: torch.Tensor, plan: ChainPlan):
    """Workspace-slot changed flags → full (total_bands, n_tiles) grid;
    sentinel slots write into a scratch entry that is cut off."""
    flat = torch.zeros((plan.total_tiles + 1,), dtype=torch.int32,
                       device=ch.device)
    flat[idx.long()] = ch.reshape(-1)
    return flat[:-1].reshape(plan.total_bands, plan.n_tiles)


def _active_indices(active: torch.Tensor, plan: ChainPlan):
    """Dense slot → flat cell index map for the compact workspace: the
    active cells in ascending order, then the sentinel ``total_tiles``,
    ``plan.compact_capacity`` slots in all (a fixed size, as
    ``jnp.nonzero(size=cap, fill_value=total)`` gives; the stable sort
    needs no host read-back)."""
    total, cap = plan.total_tiles, plan.compact_capacity
    flat = active.reshape(-1) > 0
    order = torch.sort((~flat).to(torch.int32), stable=True).indices[:cap]
    ok = flat[order]
    idx = torch.where(ok, order, total).to(torch.int32)
    return idx, ok.to(torch.int32)[:, None]


# ---------------------------------------------------------------------------
# fixed-length chains: ε_s / δ_s (paper Fig. 7 workload)
# ---------------------------------------------------------------------------


def chain_chunks(n: int, plan: ChainPlan) -> list:
    """The K of each kernel call of an ``n``-step fixed chain: ``n //
    fuse_k`` calls of ``fuse_k``, then the remainder as powers of two
    that divide ``band_h`` (largest first), so the whole chain runs on
    the fused kernels (the reference runs the remainder on its oracle;
    the outputs are equal, as the kernels pin each image's halo)."""
    ks = [plan.fuse_k] * (n // plan.fuse_k)
    rem = n % plan.fuse_k
    k = 1 << max(rem.bit_length() - 1, 0)
    while rem:
        if k <= rem and plan.band_h % k == 0:
            ks.append(k)
            rem -= k
        else:
            k //= 2
    return ks


def morph_chain(f: torch.Tensor, n: int, op: str = "erode",
                backend: str | None = None,
                plan: ChainPlan | None = None, device=None) -> torch.Tensor:
    """Apply n elementary 3×3 erosions/dilations with K-step fusion on
    ``device`` (``None`` is the GPU).  Accepts (H, W) or a batched
    (N, H, W) stack."""
    backend = canonicalize_backend(backend)
    (f,) = _on_device(device, f)
    if backend == "torch":
        return M.erode(f, n) if op == "erode" else M.dilate(f, n)

    f3, was_2d = _as_stack(f)
    _plan_for(f3, plan)
    if plan is None:
        plan = plan_chain(f3.shape[1], f3.shape[2], f.dtype, n,
                          n_images=f3.shape[0])
    x2 = _stacked(_pad(f3, plan, ident_for(op, f.dtype)))
    for k in chain_chunks(n, plan):
        x2 = chain_step(x2, op=op, fuse_k=k, band_h=plan.band_h,
                        bands_per_image=plan.n_bands)
    return _crop(_unstacked(x2, f3.shape[0]), f.shape, was_2d)


def _compile_unary(build, f: torch.Tensor, backend, device):
    api = _api()
    exe = api.compile(build(api.E.input("f")), f.shape, f.dtype, backend,
                      device=device)
    return exe(f)


def erode(f: torch.Tensor, s: int, backend: str | None = None,
          device=None):
    """ε_s via a chain of s elementary erosions (Eq. 4 decomposition)."""
    return _compile_unary(lambda x: _api().E.erode(s, x), f, backend,
                          device)


def dilate(f: torch.Tensor, s: int, backend: str | None = None,
           device=None):
    return _compile_unary(lambda x: _api().E.dilate(s, x), f, backend,
                          device)


def opening(f: torch.Tensor, s: int, backend: str | None = None,
            device=None):
    """γ_s = δ_s ∘ ε_s — compiled as one two-segment padded program."""
    return _compile_unary(lambda x: _api().E.opening(s, x), f, backend,
                          device)


def closing(f: torch.Tensor, s: int, backend: str | None = None,
            device=None):
    return _compile_unary(lambda x: _api().E.closing(s, x), f, backend,
                          device)


# ---------------------------------------------------------------------------
# geodesic chains + reconstruction (Alg. 4)
# ---------------------------------------------------------------------------


def geodesic_chain(f: torch.Tensor, m: torch.Tensor, n: int,
                   op: str = "erode", backend: str | None = None,
                   plan: ChainPlan | None = None,
                   device=None) -> torch.Tensor:
    """n elementary geodesic steps (fixed length, Eq. 4) on ``device``
    (``None`` is the GPU).  Accepts (H, W) or a batched (N, H, W)
    marker/mask stack."""
    backend = canonicalize_backend(backend)
    f, m = _on_device(device, f, m)
    if backend == "torch":
        step = M.geodesic_erode if op == "erode" else M.geodesic_dilate
        return step(f, m, n)

    f3, was_2d = _as_stack(f)
    m3, _ = _as_stack(m)
    if f3.shape != m3.shape:
        raise ValueError(f"marker shape {tuple(f.shape)} != mask shape "
                         f"{tuple(m.shape)}")
    _plan_for(f3, plan)
    if plan is None:
        plan = plan_chain(f3.shape[1], f3.shape[2], f.dtype, n,
                          n_images_resident=2, n_images=f3.shape[0])
    ident = ident_for(op, f.dtype)
    # mask pinning: pad the mask with the identity so pad rows absorb
    fp = _stacked(_pad(f3, plan, ident))
    mp = _stacked(_pad(m3, plan, ident))
    for k in chain_chunks(n, plan):
        fp, _ = geodesic_chain_step(fp, mp, op=op, fuse_k=k,
                                    band_h=plan.band_h,
                                    bands_per_image=plan.n_bands)
    return _crop(_unstacked(fp, f3.shape[0]), f.shape, was_2d)


def scheduler_state0(plan: ChainPlan, device) -> tuple:
    """Fresh scheduler state: ``(active, img_chunks)`` with every cell
    active (an int32 (total_bands, n_tiles) grid on ``device``) and no
    chunks applied (a host (n_images,) counter)."""
    return (torch.ones((plan.total_bands, plan.n_tiles), dtype=torch.int32,
                       device=device),
            np.zeros((plan.n_images,), np.int32))


def _drive_scheduler(plan: ChainPlan, data, device, *, full_step,
                     compact_step=None, gather_const=None, max_chunks: int,
                     with_stats: bool = False):
    """Active-cell requeue driver loop (the paper's Alg. 4 work queue),
    for the chain whose state ``data`` lives on ``device``.

    ``full_step(data, active, base) -> (data, flags)`` runs one K-chunk
    over the full grid; ``compact_step(data, idx, valid, const, base) ->
    (data, flags)`` one K-chunk on the compacted workspace of cells
    ``idx``; ``gather_const(idx)`` gathers the chunk-invariant compact
    operands (the mask patches), cached while the active set is
    unchanged.  ``base`` is a host (total_bands, 1) int32 array: the
    elementary filters already applied to each band's *image* (its
    chunk count times K), which advances only while the image has
    active cells — the QDT's distance offset; reconstruction ignores
    it.  ``flags`` come back as a (total_bands, n_tiles) int32 grid.

    Returns (data, chunks, active_cell_sum, active_per_chunk,
    img_converged, (active, img_chunks)); ``img_converged`` is True
    where an image's cells all went inactive within ``max_chunks``.
    The loop makes the reference's decisions from a host copy of the
    activity grid, read once per chunk.
    """
    total = plan.total_tiles
    cap = plan.compact_capacity
    use_compact = (compact_step is not None and plan.compact_threshold > 0.0
                   and cap < total)
    with_cache = use_compact and gather_const is not None
    active, img_chunks = scheduler_state0(plan, device)
    active_h = np.ones((total,), np.int32)
    per_chunk = np.zeros((max_chunks if with_stats else 0,), np.int32)
    ckey = cval = None
    it = asum = 0
    while active_h.any() and it < max_chunks:
        count = int(active_h.sum())
        base = np.repeat(img_chunks * plan.fuse_k,
                         plan.n_bands)[:, None].astype(np.int32)
        if use_compact and count <= cap:
            idx, valid = _active_indices(active, plan)
            key = active_h > 0
            if with_cache and (ckey is None or not np.array_equal(key, ckey)):
                cval, ckey = gather_const(idx), key
            data, flags = compact_step(data, idx, valid, cval, base)
        else:
            data, flags = full_step(data, active, base)
        if with_stats:
            per_chunk[it] = count
        img_chunks = img_chunks + active_h.reshape(plan.n_images, -1).any(1)
        active = _dilate_active(flags, plan)
        active_h = active.reshape(-1).cpu().numpy()  # the chunk's one sync
        asum += count
        it += 1
    img_converged = ~active_h.reshape(plan.n_images, -1).any(1)
    return (data, it, asum, torch.from_numpy(per_chunk),
            torch.from_numpy(img_converged), (active, img_chunks))


def _scheduled_reconstruct(fp, mp, plan: ChainPlan, op: str,
                           max_chunks: int, with_stats: bool):
    """Reconstruction's step functions for :func:`_drive_scheduler`.

    ``fp``/``mp`` are stacked (TOTAL_H, W_pad) arrays.  Tiled plans run
    the 2-D grid kernel for full chunks, row-only plans the row-band
    kernel; compaction is patch-based either way, and the mask's
    patches go through the driver's ``gather_const`` cache.
    """
    ident = ident_for(op, fp.dtype)
    geo = dict(op=op, fuse_k=plan.fuse_k, band_h=plan.band_h)

    def full_step(x, active, _base):
        if plan.n_tiles > 1:
            return geodesic_tile_step(x, mp, tile_w=plan.tile_w,
                                      active=active,
                                      bands_per_image=plan.n_bands, **geo)
        return geodesic_chain_step(x, mp, active=active,
                                   bands_per_image=plan.n_bands, **geo)

    def gather_const(idx):
        return _gather_patches(mp, idx, plan, ident)

    def compact_step(x, idx, valid, mask_patch, _base):
        f_patch = _gather_patches(x, idx, plan, ident)
        new_mid, ch = geodesic_compact_step(
            f_patch, mask_patch, valid, tile_w=_cell_tile_w(plan), **geo)
        return (_scatter_mid(x, idx, new_mid, plan),
                _scatter_flags(ch, idx, plan))

    return _drive_scheduler(
        plan, fp, fp.device, full_step=full_step, compact_step=compact_step,
        gather_const=gather_const, max_chunks=max_chunks,
        with_stats=with_stats,
    )


def _reconstruct_impl(f, m, op, max_chunks, plan, with_stats=False):
    f3, was_2d = _as_stack(f)
    m3, _ = _as_stack(m)
    if f3.shape != m3.shape:
        raise ValueError(f"marker shape {tuple(f.shape)} != mask shape "
                         f"{tuple(m.shape)}")
    _plan_for(f3, plan)
    if plan is None:
        plan = plan_chain(f3.shape[1], f3.shape[2], f.dtype, None,
                          n_images_resident=2, n_images=f3.shape[0],
                          convergent=True)
    if max_chunks is None:
        # geodesic paths are bounded by the pixel count; the loop exits
        # as soon as the active set empties, so the cap costs nothing
        max_chunks = (f3.shape[1] * f3.shape[2]) // plan.fuse_k + 2
    ident = ident_for(op, f.dtype)
    fp = _stacked(_pad(f3, plan, ident))
    mp = _stacked(_pad(m3, plan, ident))
    out, chunks, asum, per_chunk, img_conv, _ = _scheduled_reconstruct(
        fp, mp, plan, op, max_chunks, with_stats)
    stats = ReconstructStats(
        chunks=torch.tensor(chunks, dtype=torch.int32),
        active_band_sum=torch.tensor(asum, dtype=torch.int32),
        total_bands=torch.tensor(plan.total_tiles, dtype=torch.int32),
        active_per_chunk=per_chunk,
        converged=img_conv.all(),
    )
    return _crop(_unstacked(out, f3.shape[0]), f.shape, was_2d), stats


def reconstruct(f: torch.Tensor, m: torch.Tensor, op: str = "erode",
                backend: str | None = None, max_chunks: int | None = None,
                plan: ChainPlan | None = None,
                device=None) -> torch.Tensor:
    """ε_rec / δ_rec with kernel-fused convergence detection (Alg. 4),
    through ``repro_torch.api.compile`` on ``device`` (``None`` is the
    GPU).  Accepts (H, W) or (N, H, W); each image converges
    independently."""
    if f.shape != m.shape:
        raise ValueError(f"marker shape {tuple(f.shape)} != mask shape "
                         f"{tuple(m.shape)}")
    api = _api()
    expr = api.E.reconstruct(api.E.input("marker"), api.E.input("mask"),
                             op=op)
    exe = api.compile(expr, f.shape, f.dtype, backend, plan=plan,
                      max_chunks=max_chunks, device=device)
    return exe(f, m)


def reconstruct_with_stats(f: torch.Tensor, m: torch.Tensor,
                           op: str = "erode", backend: str | None = None,
                           max_chunks: int | None = None,
                           plan: ChainPlan | None = None, device=None):
    """Like ``reconstruct`` but also returns :class:`ReconstructStats`
    (chunk count and cell-level requeue accounting), on ``device``
    (``None`` is the GPU).  Engine entry point:
    ``backend``/``max_chunks``/``plan`` are first-class here."""
    backend = canonicalize_backend(backend)
    f, m = _on_device(device, f, m)
    if backend == "torch":
        iter_cap = (max_chunks if max_chunks is not None
                    else f.shape[-1] * f.shape[-2])
        rec = (M.erode_reconstruct_with_iters if op == "erode"
               else M.dilate_reconstruct_with_iters)
        out, iters = rec(f, m, iter_cap)
        return out, ReconstructStats(
            chunks=iters, active_band_sum=iters,
            total_bands=torch.tensor(1, dtype=torch.int32),
            active_per_chunk=torch.zeros((0,), dtype=torch.int32),
            # the oracle loop exits early iff a fixpoint was reached
            converged=iters < iter_cap,
        )
    return _reconstruct_impl(f, m, op, max_chunks, plan, with_stats=True)


# ---------------------------------------------------------------------------
# quasi-distance transform (Alg. 5)
# ---------------------------------------------------------------------------


def _scheduled_qdt(fp, plan: ChainPlan, max_chunks: int):
    """QDT's step functions for :func:`_drive_scheduler`.

    ``fp`` is the stacked (TOTAL_H, W_pad) image, padded with the
    erosion identity.  Returns the final (eroded, residual, distance)
    stacked planes, the per-image convergence vector and the scheduler
    state; the residual plane is ``qdt_acc_dtype`` (float32 for float
    images, int32 otherwise).  Each chunk copies the host ``base`` to
    the device: broadcast over a band's tiles for the tile kernel, one
    entry per workspace slot for the compact kernel.
    """
    k = plan.fuse_k
    ident = ident_for("erode", fp.dtype)
    rp = torch.zeros(fp.shape, dtype=qdt_acc_dtype(fp.dtype),
                     device=fp.device)
    dp = torch.zeros(fp.shape, dtype=torch.int32, device=fp.device)

    def full_step(data, active, base):
        x, r, d = data
        base = torch.from_numpy(base).to(x.device)
        if plan.n_tiles > 1:
            x, r, d, ch = qdt_tile_step(
                x, r, d,
                base.expand(plan.total_bands, plan.n_tiles).contiguous(),
                fuse_k=k, band_h=plan.band_h, tile_w=plan.tile_w,
                active=active, bands_per_image=plan.n_bands)
        else:
            x, r, d, ch = qdt_chain_step(
                x, r, d, base, fuse_k=k, band_h=plan.band_h, active=active,
                bands_per_image=plan.n_bands)
        return (x, r, d), ch

    def compact_step(data, idx, valid, _const, base):
        x, r, d = data
        f_patch = _gather_patches(x, idx, plan, ident)
        rm = _gather_mid(r, idx, plan)
        dm = _gather_mid(d, idx, plan)
        # each slot carries its image's erosion count; the sentinel
        # index clamps to the last band (its slot is dropped anyway)
        band = (idx.long() // plan.n_tiles).clamp(max=plan.total_bands - 1)
        base_slots = torch.from_numpy(base).to(x.device)[band]
        f2, r2, d2, ch = qdt_compact_step(
            f_patch, rm, dm, valid, base_slots, fuse_k=k,
            band_h=plan.band_h, tile_w=_cell_tile_w(plan))
        return ((_scatter_mid(x, idx, f2, plan),
                 _scatter_mid(r, idx, r2, plan),
                 _scatter_mid(d, idx, d2, plan)),
                _scatter_flags(ch, idx, plan))

    (x, r, d), _, _, _, img_conv, state = _drive_scheduler(
        plan, (fp, rp, dp), fp.device, full_step=full_step,
        compact_step=compact_step, max_chunks=max_chunks)
    return x, r, d, img_conv, state


def qdt_planes(f: torch.Tensor, backend: str | None = None,
               max_chunks: int | None = None,
               plan: ChainPlan | None = None, device=None):
    """d(f), r(f) of Eq. 13 with the fused masked-store kernels, through
    ``repro_torch.api.compile`` on ``device`` (``None`` is the GPU).
    Accepts (H, W) or (N, H, W); runs the same active-cell requeue
    scheduler as ``reconstruct``.  Returns (d, r)."""
    api = _api()
    exe = api.compile(api.E.qdt(api.E.input("f")), f.shape, f.dtype,
                      backend, plan=plan, max_chunks=max_chunks,
                      device=device)
    return exe(f)


# ---------------------------------------------------------------------------
# generalised geodesic distance transform (grey-weighted, FastGeodis-style)
# ---------------------------------------------------------------------------


def gdt_stage(ip: torch.Tensor, sp: torch.Tensor, nu: float):
    """Derive the kernels' three resident planes from the *padded*
    image/seed operands (both arrive with the float lattice bottom,
    −inf, as their pad fill).

    Returns ``(d0, i, s)``: the initial distance plane ``d0 = nu·(1−S)``
    (+inf on pads), the sanitized image (0 on pads, so the weight never
    computes ``|−inf − (−inf)|``) and the seed/pad-marker plane (clipped
    to [0, 1] in the real region, −1 on pads — the value the kernels
    re-clamp ``d = +inf`` on after every step).  This is the one place
    that sanitizes: the kernels and the raster sweeps assume the planes
    are in this form.
    """
    in_pad = torch.isneginf(sp)
    sc = torch.clamp(sp, 0.0, 1.0)  # clamp(−inf) → 0; NaN stays NaN
    d0 = torch.where(in_pad, D_IDENT, nu * (1.0 - sc))
    i = torch.where(in_pad, I_IDENT, ip)
    s = torch.where(in_pad, S_IDENT, sc)
    return d0, i, s


def _scheduled_gdt(dp, ip, sp, plan: ChainPlan, lamb: float,
                   max_chunks: int):
    """gdt's step functions for :func:`_drive_scheduler` (the wavefront
    schedule).

    ``dp``/``ip``/``sp`` are stacked (TOTAL_H, W_pad) planes from
    :func:`gdt_stage`.  Only the distance plane evolves; the image and
    seed planes are chunk-invariant, so their compact-workspace patches
    go through the driver's ``gather_const`` cache as one pair.  Returns
    (d, img_converged, state).
    """
    geo = dict(lamb=lamb, fuse_k=plan.fuse_k, band_h=plan.band_h)

    def full_step(d, active, _base):
        if plan.n_tiles > 1:
            return gdt_tile_step(d, ip, sp, tile_w=plan.tile_w,
                                 active=active,
                                 bands_per_image=plan.n_bands, **geo)
        return gdt_chain_step(d, ip, sp, active=active,
                              bands_per_image=plan.n_bands, **geo)

    def gather_const(idx):
        return (_gather_patches(ip, idx, plan, I_IDENT),
                _gather_patches(sp, idx, plan, S_IDENT))

    def compact_step(d, idx, valid, const, _base):
        i_patch, s_patch = const
        d_patch = _gather_patches(d, idx, plan, D_IDENT)
        new_mid, ch = gdt_compact_step(d_patch, i_patch, s_patch, valid,
                                       tile_w=_cell_tile_w(plan), **geo)
        return (_scatter_mid(d, idx, new_mid, plan),
                _scatter_flags(ch, idx, plan))

    d, _, _, _, img_conv, state = _drive_scheduler(
        plan, dp, dp.device, full_step=full_step, compact_step=compact_step,
        gather_const=gather_const, max_chunks=max_chunks)
    return d, img_conv, state


def _shift_row(x: torch.Tensor, dx: int, fill) -> torch.Tensor:
    """(N, W) row batch translated along W with ``fill`` at the border."""
    if dx == 0:
        return x
    return shift2(x, 0, dx, fill)


def _gdt_sweep(d3, i3, s3, lamb: float, reverse: bool):
    """One directional raster pass over (N, H, W) planes: a loop over the
    rows (axis 1) carrying the *updated* previous row, relaxing each row
    against its three upper (``reverse=False``) or lower
    (``reverse=True``) neighbours.  The left/right passes run this on the
    H↔W transposed planes; across the four directions the candidate sets
    cover the 8-neighbourhood, so rounds iterated to a fixpoint land on
    the same bits as the wavefront scheduler.  Each operation rounds on
    its own, as in :func:`~repro_torch.kernels.gdt_chain.gdt_weights`."""
    n, h, w = d3.shape
    out = torch.empty_like(d3)
    prev_d = torch.full((n, w), D_IDENT, dtype=d3.dtype, device=d3.device)
    prev_i = torch.zeros((n, w), dtype=d3.dtype, device=d3.device)
    for r in (range(h - 1, -1, -1) if reverse else range(h)):
        d_row, i_row = d3[:, r], i3[:, r]
        best = d_row
        for dx in (-1, 0, 1):
            dq = _shift_row(prev_d, dx, D_IDENT)
            if lamb == 0.0:
                cand = dq + 1.0
            else:
                iq = _shift_row(prev_i, dx, I_IDENT)
                cand = dq + (1.0 + torch.abs(lamb * torch.abs(i_row - iq)))
            best = torch.minimum(best, cand)
        prev_d = torch.where(s3[:, r] < 0, D_IDENT, best)
        prev_i = i_row
        out[:, r] = prev_d
    return out


def _raster_gdt(dp, ip, sp, plan: ChainPlan, lamb: float, max_rounds: int):
    """The raster-scan schedule: FastGeodis-style down/up/left/right
    sweeps iterated to a fixpoint (``plan.schedule == "raster"``), in
    plain PyTorch on the tensors' device.

    Runs on the *unstacked* (N, H_pad, W_pad) view: the sweeps walk rows
    and columns of each image separately, so batched images never leak
    into each other.  One host read of the per-image ``changed`` vector
    per round.  Returns ``(d, rounds, img_converged)`` with ``d``
    re-stacked; an image unchanged by the last full round is at its
    fixpoint, so the convergence vector is exact even when the round
    budget truncates the others.
    """
    n = plan.n_images
    d3, i3, s3 = (_unstacked(x, n) for x in (dp, ip, sp))
    i3t, s3t = i3.transpose(1, 2), s3.transpose(1, 2)
    changed = np.ones((n,), bool)
    rounds = 0
    while changed.any() and rounds < max_rounds:
        new = _gdt_sweep(d3, i3, s3, lamb, reverse=False)
        new = _gdt_sweep(new, i3, s3, lamb, reverse=True)
        new_t = _gdt_sweep(new.transpose(1, 2), i3t, s3t, lamb, reverse=False)
        new_t = _gdt_sweep(new_t, i3t, s3t, lamb, reverse=True)
        new = new_t.transpose(1, 2).contiguous()
        changed = M.not_equal(new, d3).flatten(1).any(1).cpu().numpy()
        d3 = new
        rounds += 1
    return _stacked(d3), rounds, torch.from_numpy(~changed)


def gdt_fixpoint(img: torch.Tensor, seeds: torch.Tensor, lamb: float,
                 nu: float, max_iters: int) -> torch.Tensor:
    """The ``"torch"`` engine's gdt: Jacobi iteration of the relaxation
    on unpadded (..., H, W) tensors to its fixpoint (the reference's
    ``gdt_fixpoint_xla``), bit-exact with ``repro_torch.gdt.reference``.
    One host read per iteration decides whether to go on."""
    sc = torch.clamp(seeds.to(img.dtype), 0.0, 1.0)
    d = nu * (1.0 - sc)
    weights = gdt_weights(img, lamb)
    for _ in range(max_iters):
        cand = relax(d, weights)
        if not bool(M.not_equal(cand, d).any()):
            break
        d = cand
    return d


def gdt(image, seeds, lamb: float = 1.0, nu: float = 1e6,
        backend: str | None = None, max_chunks: int | None = None,
        plan: ChainPlan | None = None, device=None) -> torch.Tensor:
    """Generalised geodesic distance transform (see ``E.gdt``), through
    ``repro_torch.api.compile`` on ``device`` (``None`` is the GPU).

    Accepts (H, W) or (N, H, W) image/seed stacks of one float dtype;
    pass a ``plan`` with ``schedule="raster"`` for the sweep schedule.
    """
    image, seeds = torch.as_tensor(image), torch.as_tensor(seeds)
    if not image.dtype.is_floating_point:
        raise TypeError(
            f"gdt: image must be a float dtype, got {image.dtype} (the "
            "distance plane is a float lattice)")
    if image.shape != seeds.shape:
        raise ValueError(f"image shape {tuple(image.shape)} != seeds shape "
                         f"{tuple(seeds.shape)}")
    api = _api()
    expr = api.E.gdt(api.E.input("image"), api.E.input("seeds"), lamb=lamb,
                     nu=nu)
    exe = api.compile(expr, image.shape, image.dtype, backend, plan=plan,
                      max_chunks=max_chunks, device=device)
    return exe(image, seeds)


# ---------------------------------------------------------------------------
# serving registry hooks
# ---------------------------------------------------------------------------

#: Registry hooks for ``repro_torch.serve`` (the reference's
#: ``SERVE_OPS``, name for name): every public kernel op declared as
#: data next to its implementation — a string name, a param schema and
#: an *expression builder*.  ``repro_torch.serve.registry`` lowers the
#: expression and derives the pipeline stages, pad fills and bucket
#: identity from the lowered program.
SERVE_OPS = (
    dict(name="erode",
         expr=lambda p: _api().E.erode(p["s"], _api().E.input("f")),
         params={"s": dict(type="int", required=True, min=1)}),
    dict(name="dilate",
         expr=lambda p: _api().E.dilate(p["s"], _api().E.input("f")),
         params={"s": dict(type="int", required=True, min=1)}),
    dict(name="opening",
         expr=lambda p: _api().E.opening(p["s"], _api().E.input("f")),
         params={"s": dict(type="int", required=True, min=1)}),
    dict(name="closing",
         expr=lambda p: _api().E.closing(p["s"], _api().E.input("f")),
         params={"s": dict(type="int", required=True, min=1)}),
    dict(name="reconstruct",
         expr=lambda p: _api().E.reconstruct(_api().E.input("marker"),
                                             _api().E.input("mask"),
                                             op=p["op"]),
         params={"op": dict(type="str", default="dilate",
                            choices=("erode", "dilate"))}),
    dict(name="geodesic",
         expr=lambda p: _api().E.geodesic(_api().E.input("marker"),
                                          _api().E.input("mask"),
                                          p["n"], p["op"]),
         params={"n": dict(type="int", required=True, min=1),
                 "op": dict(type="str", default="erode",
                            choices=("erode", "dilate"))}),
    dict(name="qdt",
         expr=lambda p: _api().E.qdt(_api().E.input("f")),
         params={}),
)
