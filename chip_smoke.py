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
   pass;
7. continuous: the same stream through ``Service(continuous=True,
   refill_quantum=4)`` (the rest as in 6), every bucket and slot session
   warmed first.  The launch counts are set to 0 just before the counted
   pass and read just after: the slot rounds' kernels (tile and compact
   steps of the reconstruction, the QDT and the gdt) must all have been
   launched.  Every ticket must end ``ok`` and every value equal the
   batch path's (depth 1) and the ``"torch"`` engine's.  Then the batch
   and the continuous service serve the stream in turn (batch,
   continuous, continuous, batch), and a straggler burst — one
   serpentine 1024x1024 reconstruction (hundreds of chunks) and 15 HMAX
   frames in one bucket — must refill slots and equal the batch path.
   It prints frames/s of both, each bucket's rounds, refills, batch and
   work occupancy and p50/p99, the burst's chunks on both paths, and the
   device idle share of one profiled continuous pass;
8. verifier: ``python -m repro_torch.analysis.lint``'s sweep at "full"
   on the card, then every executable the earlier phases compiled (the
   main path, every served bucket, the slot sessions') at "full" — no
   ERROR anywhere — and, for every launch they make, the launch model's
   block shape and every window against the library's geometry exports
   (``*_geometry``, ``*_windows``), field for field.  It prints the
   counts and the mean ms of a "fast" verification per compile;
9. baselines: van Herk/Gil-Werman erosion (``repro_torch.baselines``)
   at s = 1 … 91 beside the ``"cuda"`` engine's chain of s steps, at
   N=8 × 1024² in uint8 and float64 — every result equal — and the
   naive per-filter chain at n = 64 beside the fused one.  It prints
   where each is faster; no gain is claimed;
10. distributed: ``repro_torch.core.distributed`` at 1024² — a 64-step
   erosion chain in uint8 and float32 and the HMAX reconstruction
   (marker f - 40, mask f) — (a) as one rank of an NCCL group on a 1×1
   grid in this process, (b) as a 2×2 grid of four spawned gloo ranks
   on the one card (512² blocks: the K-deep halos cross ranks through
   host buffers; NCCL cannot put two ranks on one card).  Every result
   must equal the ``"torch"`` engine's, (b) must equal (a), and each
   counted run (every rank's) must launch ``chain_step`` and
   ``geodesic_chain_step``.  It prints each case's wall ms, K, chunks
   and halo bytes a chunk; no speed-up is claimed;
11. language-model serving (``repro_torch.models``,
   ``repro_torch.launch.serve``; no Pallas kernel lies on this path):
   gemma-2b (a) at full width cut to 2 layers, float32 activations,
   weights drawn on the CPU from a seed: prefill and 4 greedy decode
   steps on the card against the CPU within 1e-4 of max |logits|, the
   same tokens; (b) at full width and depth, weights drawn on the card:
   batch 4, a 128-token prompt, 32 greedy decode steps — the last
   step's logits against ``forward`` over the whole sequence within
   2e-3 in float32, the bfloat16 error reported, every logit finite;
   (c) the served bfloat16 model's prefill ms and decode ms/token (CUDA
   events), tok/s and peak memory beside their bounds, and one profiled
   prefill and decode pass (device busy and idle share);
12. MoE serving (``repro_torch.models.moe``; no Pallas kernel lies on
   this path either), after phase 11 has freed its model:
   deepseek-moe-16b (a) at full width cut to 2 layers, float32, weights
   drawn on the CPU: prefill and 4 greedy steps on the card against the
   CPU within 1e-4 of max |logits|, the same tokens and the same
   experts for every token in every layer; (b) at ``capacity_factor``
   E/K (nothing drops, so ``forward`` routes as prefill and decode do):
   decode against ``forward`` within 2e-3 in float32 at 14 layers (28
   float32 layers are 67.5 GB), and in bfloat16 at full depth
   (reported), every logit finite; (c) the served bfloat16 model at
   full depth, configuration as written: phase 11's timings and trace,
   the served prefill's dropped assignments, and the decode bound
   counted from the experts the run's routing chose (beside the read of
   every expert the dense products make); (d) arctic-480b at full
   width, one layer, bfloat16 (35 layers fit no single card): 8 decode
   steps, every logit finite, decode against ``forward`` reported;
13. the recurrent layer kinds (``repro_torch.models.ssm``,
   ``repro_torch.models.xlstm``; no Pallas kernel lies on this path
   either), after phase 12 has freed its models: (a) float32, weights
   drawn on the CPU, 4 greedy steps on the card against the CPU within
   1e-4 of max |logits|, the same tokens: zamba2-7b at full width cut to
   7 layers (one group of 6 Mamba2 layers, the shared attention block,
   one tail layer) with a 256-token prompt (two scan chunks), xlstm-350m
   at full width and depth with a 4-token prompt (its sLSTM is chaotic
   under the reference's initialiser: ``XLSTM_CHECK_PROMPT``), and its
   first mLSTM layer alone over 256 tokens (output and state); (b)
   zamba2-7b at full width and depth, batch 4, a 256-token prompt, 128
   greedy steps: decode against ``forward`` (384 tokens, three chunks)
   within 2e-3 in float32, bfloat16 reported, every logit finite; (c)
   both served bfloat16 models: phase 11's timings and trace, the
   launches of a prefill and of a decode step, beside bounds counted
   from the stack (the shared block's weights read at each of its 13
   uses, the states read and written a step);
14. the encoder–decoder (``Model.encoder``, the decoder layers' cross
   blocks, the ``ck``/``cv``/``enc_out`` cache; no Pallas kernel lies on
   this path either), after phase 13 has freed its models:
   seamless-m4t-large-v2 (a) at full width cut to 2 encoder + 2 decoder
   layers, float32, weights drawn on the CPU, batch 2, a 32-token
   prompt over 200 encoder frames (padded non-causal tiles): prefill and
   4 greedy steps on the card against the CPU within 1e-4 of max
   |logits|, the same tokens; (b) at full width and depth (24 + 24),
   batch 4, a 128-token prompt over 128 frames, 32 greedy steps: decode
   against ``forward`` within 2e-3 in float32, bfloat16 reported, every
   logit finite; (c) the served bfloat16 model: phase 11's timings,
   trace and launches beside bounds counted for an encoder–decoder
   (``encdec_bounds``: decode reads the decoder's weights and the tied
   table, not the encoder's, and every layer's cross ck/cv; prefill
   adds the encoder's non-causal products and the cross products), and
   one prefill over 1024 encoder frames beside its own bound;
15. language-model training (``repro_torch.train``,
   ``repro_torch.launch.train``; the loss, the flash backward and AdamW
   reach no Pallas kernel either), after phase 14 has freed its model:
   (a) ``loss_fn``'s loss and every parameter's gradient on the card
   against the CPU within 1e-4 of that parameter's max |CPU gradient|:
   gemma-2b at full width cut to 2 layers (batch 1 × 64 tokens), and
   deepseek-moe-16b (batch 1), zamba2-7b, xlstm-350m and
   seamless-m4t-large-v2 reduced; (b) gemma-2b at full width and depth
   through ``launch.train``'s ``Trainer`` at the launcher's sizes (batch
   8 × 128 tokens, float32 masters and AdamW state, bfloat16
   activations, ``remat="full"``): 6 steps, every loss finite; step ms
   split into forward+backward and AdamW (CUDA events), tokens/s, peak
   memory, launches and the device's idle share of one profiled step,
   beside ``train_bounds``; 4 steps on one repeated batch from the
   trained state and from fresh masters, the descent reported; (c)
   reduced gemma-2b through the ``Trainer`` with a
   checkpoint every 3 steps and a failure injected at step 4, restored
   and finished: its final state against an uninterrupted run's
   (equal bit for bit, or the phase fails), and the card's checkpoint
   restored onto the CPU;
16. data-parallel training with the int8 compressed all-reduce
   (``repro_torch.optim.compression``, ``repro_torch.launch.mesh``,
   ``build_compressed_train_step``; the compression is plain PyTorch
   and reaches no Pallas kernel either), after phase 15 has freed its
   model: (a) four spawned gloo ranks on the one card, a (4, 1)
   ("data", "model") mesh, reduced gemma-2b with the same weights on
   every rank, batch 8 × 32, ``q_chunk`` 16: 2 compressed steps on the
   card, each from the CPU's state before it, against the same ranks'
   CPU run (loss within 1e-5,
   ``grad_norm`` within 1e-4 relative, parameters within 1e-5 of each
   leaf's max but for elements where a rounding flipped, fewer than
   1e-3 of them), and the reference's convergence test: 5 steps on one
   batch, compressed and plain, the compressed loss below 6.3 and
   within 0.35 of the plain one; (b) gemma-2b at full width and depth
   as the one rank of an NCCL group in this process (phase 15's
   launcher sizes, plus the float32 error): a warm-up and 3 timed
   steps, every loss finite; step ms split into forward+backward, the
   compression with its all-reduce, and AdamW (CUDA events), tokens/s,
   peak memory, the bytes a rank hands the all-reduce, launches and
   the idle share of one profiled step, beside phase 15's plain step
   and the bound (``train_bounds`` plus the compression's bytes); (c)
   ``launch.analytic``'s flops and bytes beside this script's bounds
   at the same shapes;
17. the dry run (``repro_torch.launch.dryrun``, ``op_count``,
   ``roofline``, ``launch.sharding``, ``models.partitioning``), after
   phase 16 has freed its model: (a) the CLI in subprocesses, all
   started together, each rank 0 of a fake world — gemma-2b ×
   train_4k on 16×16 and on 2×16×16, xlstm-350m × train_4k (its
   sLSTM's 4,096 tokens and mLSTM's 32 chunks folded by the op
   counter) and deepseek-moe-16b × decode_32k on 16×16 (fake CUDA
   tensors, nothing allocated), and geodesic2d ×
   img_16k on 16×16 (a real 1024² uint8 block on the card, its kernel
   launches reported: they happen in the subprocess, so the ``kernels``
   line does not count them) — every cell OK, then the roofline over
   their records; the H100 memory constant ``analytic.HBM_CAPACITY``
   held against the card's total memory; (b) in one more subprocess,
   the dry run's cell function on a one-rank world at phase 15's
   launcher sizes (gemma-2b, batch 8 × 128, float32 masters and AdamW
   state, bfloat16 activations, ``remat="full"``) against the same
   ``build_train_step`` step run for real on the card: the traced dot
   FLOPs must equal the op counter's reading of the real step, and the
   predicted peak bytes must be within 10 % of
   ``torch.cuda.max_memory_allocated``; (c) the same for xlstm-350m at
   full width, 4 of its 24 layers, batch 8 × 640 (``remat="full"``),
   where the prediction folds the sLSTM's 640 token trips and the
   mLSTM's 5 chunk trips (each run as 4, its backward and recompute
   weighted) and the real step runs every trip; (d) in one more
   subprocess, ``dryrun.reduction_collectives`` on a fake world of 8
   (a 2×2×2 mesh, fake CUDA tensors): the card's DTensor must reduce a
   pending sum over ("pod", "data") into a dim split over both
   (``REDUCTION_PINNED``) by two reduce-scatters and no all-reduce
   through ``partitioning._reduce_placed``; gemma-2b × train_4k ×
   2×16×16's collective bytes by kind are printed beside the CPU
   sweep's (``CPU_COLLECTIVES``).

The third-to-last line of standard output is the card's ``nvidia-smi``
name and power limit, the second-to-last ``{"kernels": [...]}``, and
the last ``{"ok": true, "device": {...}}``.  Everything measured also
goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
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
    n_events = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_events += 1
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
    rec = dict(case=case, wall_ms=wall_us / 1e3, device_events=n_events,
               busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
               split_ms={k: v / 1e3 for k, v in split.items()},
               top_ms=dict(sorted(((k, v / 1e3) for k, v in top.items()),
                                  key=lambda kv: -kv[1])[:6]))
    log(f"trace {rec['case']}: wall {rec['wall_ms']:.2f} ms, "
        f"{n_events} device events, device "
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


def make_service(depth: int, requests, pinned, continuous: bool = False):
    """A service on the card (``device=None``), every bucket of the
    stream warmed at every canonical batch size (and, continuous, every
    refillable bucket's slot session)."""
    from repro_torch.serve import Service

    svc = Service(backend="cuda", max_batch=8, pad_quantum=64,
                  max_delay_ms=50, pipeline_depth=depth,
                  cache_capacity=512, continuous=continuous,
                  refill_quantum=REFILL_QUANTUM)
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


def run_serving(counters, card: str) -> tuple:
    """The served stream at pipeline depth 2 (counted, timed) and 1,
    then again at 1 and 2; every value equal across depths and to the
    ``"torch"`` engine, no ticket with an error or degraded, every
    kernel of the mix launched; then a pass split into host stages and
    one profiled pass.  Fails on any of these.  Returns the phase's
    record and what the continuous phase reuses: the stream, the
    services, and each request's depth-1 and ``"torch"`` engine values."""
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
    batch_values, torch_values = [], []
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
        batch_values.append(got1)
        torch_values.append(want)
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
    return out, dict(frames=frames, pinned=pinned, requests=requests,
                     svc2=svc2, svc1=svc1, batch_values=batch_values,
                     torch_values=torch_values)


# ---------------------------------------------------------------------------
# phase 7: the same stream with continuous batching (slot engines)
# ---------------------------------------------------------------------------

#: Scheduler chunks a slot-engine round advances every occupied slot by.
REFILL_QUANTUM = 4
#: The kernels the continuous pass must launch (the slot rounds of the
#: ``rec:*``, ``qdt``/``qdt_l1`` and ``gdt`` buckets; the batch path's
#: buckets launch the others).
CONTINUOUS_KERNELS = ("geodesic_tile_step", "geodesic_compact_step",
                      "qdt_tile_step", "qdt_compact_step", "gdt_tile_step",
                      "gdt_compact_step")
#: HMAX frames of the straggler burst, beside the serpentine request.
BURST = 15


def serpentine(size: int = SIZE):
    """A uint8 reconstruction (marker, mask) whose front must walk a
    serpentine corridor: 16 corridors of 8 rows across the image, joined
    at alternate ends, the marker one pixel at the corridor's start —
    about 17 000 pixels of path, hundreds of scheduler chunks."""
    mask = np.full((size, size), 10, np.uint8)
    step = size // 16
    for k in range(16):
        mask[k * step:k * step + 8] = 200
        if k < 15:
            cols = slice(size - 8, size) if k % 2 == 0 else slice(0, 8)
            mask[k * step:(k + 1) * step + 8, cols] = 200
    marker = np.zeros_like(mask)
    marker[0, 0] = 200
    return marker, mask


def bucket_chunks(svc) -> dict:
    """Per bucket label: (rounds, busy chunks, capacity chunks) so far."""
    return {label: (b.rounds, b.busy_chunks, b.cap_chunks)
            for label, b in svc.metrics._buckets.items()}


def run_burst(svc, requests) -> tuple:
    """One straggler burst through ``svc``: (tickets, wall s, refills,
    the rec:dilate bucket's rounds/busy/cap chunk deltas and the
    latencies: the straggler's, and the others' median, mean and
    maximum)."""
    refills0 = svc.metrics.counters["refills"]
    before = bucket_chunks(svc)
    tickets, wall = serve_pass(svc, requests)
    after = bucket_chunks(svc)
    label = next(k for k in after
                 if k.startswith(f"rec:dilate/{SIZE}x{SIZE}/"))
    delta = tuple(a - b for a, b in zip(after[label],
                                        before.get(label, (0, 0, 0))))
    lat = [(t.t_done - t.t_enqueue) * 1e3 for t in tickets]
    record = dict(zip(("rounds", "busy_chunks", "cap_chunks"), delta),
                  straggler_ms=lat[0],
                  others_p50_ms=float(np.median(lat[1:])),
                  others_mean_ms=float(np.mean(lat[1:])),
                  others_max_ms=max(lat[1:]))
    return (tickets, wall, svc.metrics.counters["refills"] - refills0,
            record)


def run_continuous(counters, card: str, ctx: dict) -> dict:
    """The serving phase's stream through ``Service(continuous=True)``:
    every bucket and slot session warmed; the launch counts set to 0
    just before the counted pass and read just after (the slot rounds'
    kernels must all have launched); every ticket ``ok`` and equal to
    the batch path's (depth 1) and the ``"torch"`` engine's value; then
    passes of the batch and the continuous service in turn, a straggler
    burst (a serpentine reconstruction and ``BURST`` HMAX frames in one
    bucket: refills must happen, values equal to the batch path's), and
    one profiled continuous pass.  Fails on any of these."""
    requests, pinned = ctx["requests"], ctx["pinned"]
    frames = ctx["frames"]
    t0 = time.perf_counter()
    svc = make_service(2, requests, pinned, continuous=True)
    log(f"continuous: service warmed, slot sessions included "
        f"({time.perf_counter() - t0:.1f} s)")

    for fn in counters.values():
        fn.launches = 0
    tickets, wall_c = serve_pass(svc, requests)
    launched = {k: fn.launches for k, fn in counters.items()}
    stats = svc.stats()
    busy = sum(b.busy_chunks for b in svc.metrics._buckets.values())
    cap = sum(b.cap_chunks for b in svc.metrics._buckets.values())
    refills = {key.label(): eng.refills for key, eng in svc._engines.items()}
    missing = [k for k in CONTINUOUS_KERNELS if not launched[k]]
    if missing:
        raise AssertionError(f"the continuous pass never launched {missing}")
    refilled = sorted({label.split("/")[0] for label in refills})
    t0 = time.perf_counter()
    for (op, _, _), t, batch, want in zip(
            requests, tickets, ctx["batch_values"], ctx["torch_values"],
            strict=True):
        if t.outcome != "ok":
            raise AssertionError(
                f"continuous {op} ended {t.outcome}: {t.error!r}")
        got = t.value if isinstance(t.value, tuple) else (t.value,)
        for a, b, w in zip(got, batch, want, strict=True):
            if a.device.type != torch.device(DEVICE).type or not same(a, b):
                raise AssertionError(f"continuous {op} != the batch path")
            if not same(a, w):
                raise AssertionError(
                    f"continuous {op} != the torch engine "
                    f"(max_abs_err={max_abs_err(a, w)})")
    check_s = time.perf_counter() - t0

    # batch, continuous, continuous, batch: order and spread in one phase
    walls = {"batch": [serve_pass(ctx["svc2"], requests)[1]],
             "continuous": [wall_c]}
    walls["continuous"].append(serve_pass(svc, requests)[1])
    walls["batch"].append(serve_pass(ctx["svc2"], requests)[1])

    marker, mask = serpentine()
    burst = [("reconstruct", (marker, mask), {"op": "dilate"})] + [
        ("hmax", (f,), {"h": 40}) for f in frames[:BURST]]
    b_tickets, b_wall, b_refills, b_chunks = run_burst(svc, burst)
    p_tickets, p_wall, _, p_chunks = run_burst(ctx["svc1"], burst)
    if b_refills <= 0:
        raise AssertionError("the straggler burst refilled no slot")
    for (op, _, _), t, p in zip(burst, b_tickets, p_tickets, strict=True):
        if t.outcome != "ok" or p.outcome != "ok":
            raise AssertionError(f"burst {op} ended {t.outcome}/{p.outcome}")
        if not same(t.value, p.value):
            raise AssertionError(f"burst {op}: continuous != the batch path")

    tot = stats["totals"]
    out = dict(
        requests=len(requests), wall_s=walls,
        frames_per_s={k: [FRAMES / w for w in v] for k, v in walls.items()},
        requests_per_s=tot["fps"], batch_occupancy=tot["batch_occupancy"],
        work_occupancy=tot["work_occupancy"], busy_chunks=busy,
        cap_chunks=cap, counters=stats["counters"], refilled_ops=refilled,
        launches={k: launched[k] for k in counters if launched[k]},
        buckets={label: dict(requests=b["requests"], batches=b["batches"],
                             rounds=b["rounds"],
                             refills=refills.get(label, 0),
                             batch_occupancy=b["batch_occupancy"],
                             work_occupancy=b["work_occupancy"],
                             p50_ms=b["latency"]["p50_ms"],
                             p99_ms=b["latency"]["p99_ms"])
                 for label, b in stats["buckets"].items()},
        burst=dict(requests=len(burst), refills=b_refills,
                   continuous=dict(wall_s=b_wall, **b_chunks),
                   batch=dict(wall_s=p_wall, **p_chunks)),
        check_s=check_s)
    log(f"continuous: {len(requests)} requests equal to the batch path and "
        f"the torch engine ({check_s:.1f} s); slot engines for "
        f"{', '.join(refilled)}")
    log(f"continuous totals: batch, continuous, continuous, batch: "
        f"{walls['batch'][0]:.3f} / {walls['continuous'][0]:.3f} / "
        f"{walls['continuous'][1]:.3f} / {walls['batch'][1]:.3f} s a pass "
        f"({FRAMES / walls['batch'][0]:.2f} / "
        f"{FRAMES / walls['continuous'][0]:.2f} / "
        f"{FRAMES / walls['continuous'][1]:.2f} / "
        f"{FRAMES / walls['batch'][1]:.2f} frames/s); metrics (the counted "
        f"continuous pass): {tot['fps']:.1f} requests/s, batch occupancy "
        f"{tot['batch_occupancy']:.3f}, work occupancy "
        f"{tot['work_occupancy']:.3f} (busy {out['busy_chunks']} / cap "
        f"{out['cap_chunks']} chunks), refills "
        f"{stats['counters']['refills']} ({card})")
    for label, b in out["buckets"].items():
        log(f"continuous bucket {label}: {b['requests']} requests, "
            f"{b['rounds']} rounds, {b['refills']} refills, "
            f"{b['batches']} batches, batch occupancy "
            f"{b['batch_occupancy']:.3f}, work occupancy "
            f"{b['work_occupancy']:.3f}, p50 {b['p50_ms']:.1f} ms, p99 "
            f"{b['p99_ms']:.1f} ms ({card})")
    log(f"continuous launches: {json.dumps(out['launches'])} ({card})")
    log(f"continuous burst (1 serpentine + {BURST} HMAX, one bucket): "
        f"{b_refills} refills; continuous {b_wall:.3f} s, "
        f"{json.dumps(b_chunks)}; batch (depth 1) {p_wall:.3f} s, "
        f"{json.dumps(p_chunks)} ({card})")
    out["trace"] = profile_run("serve/continuous",
                               lambda: serve_pass(svc, requests), card)
    return out


# ---------------------------------------------------------------------------
# phase 8: the static verifier on the card's executables
# ---------------------------------------------------------------------------


def run_verifier(card: str) -> dict:
    """(a) the lint sweep at "full" on the card; (b) every executable the
    earlier phases compiled (the main path, every served bucket and the
    slot sessions' executables: the compile cache) at "full"; (c) the
    launch model's shape and every window of each launch that (a) and
    (b) met against the library's geometry exports.  Fails on any ERROR
    or mismatch.  Returns the phase's counts."""
    from repro_torch.analysis import indexmaps as IM
    from repro_torch.analysis.lint import iter_registry_cases, run_lint
    from repro_torch.analysis.verifier import verify_executable
    from repro_torch.api import compile
    from repro_torch.api.compile import cached_executables

    earlier = list(cached_executables())
    t0 = time.perf_counter()
    lint = run_lint(level="full", device=None)
    lint_s = time.perf_counter() - t0
    if not lint.ok:
        raise AssertionError(f"verifier: the lint sweep has errors:\n{lint}")
    cases = list(iter_registry_cases())
    lint_exes = [compile(expr, shape3, dtype, backend, verify=False)
                 for _, expr, shape3, dtype, backend in cases]

    findings = collections.Counter()
    for f in lint.findings:
        findings[f"{f.check}/{f.severity}"] += 1
    fast_s = []
    for exe in earlier:
        t0 = time.perf_counter()
        verify_executable(exe, level="fast")
        fast_s.append(time.perf_counter() - t0)
        report = verify_executable(exe, level="full")
        for f in report.findings:
            findings[f"{f.check}/{f.severity}"] += 1
        if not report.ok:
            raise AssertionError(f"verifier: {report}")

    launches = list(dict.fromkeys(
        launch for exe in earlier + lint_exes
        for launch in IM.executable_launches(exe)))
    n_windows = 0
    for launch in launches:
        bad, n = IM.compare_with_library(launch)
        if bad:
            raise AssertionError("verifier: the launch model disagrees with "
                                 "the library:\n" + "\n".join(map(str, bad)))
        n_windows += n
    out = {"lint_cases": len(cases),
           "lint_s": lint_s, "executables": len(earlier),
           "findings": dict(findings), "geometries": len(launches),
           "windows": n_windows,
           "kernels": sorted({l.kernel for l in launches}),
           "fast_verify_ms": 1e3 * float(np.mean(fast_s)) if fast_s else None}
    log(f"verifier: lint {out['lint_cases']} cases at full, no ERROR "
        f"({lint_s:.1f} s); {len(earlier)} main-path and served executables "
        f"at full, no ERROR; findings by class {dict(findings) or 'none'}; "
        f"{len(launches)} launch geometries and {n_windows} windows equal "
        f"to the library's ({len(out['kernels'])} kernels); a fast "
        f"verification {out['fast_verify_ms']:.3f} ms a compile ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 9: the paper's baselines beside the fused chains
# ---------------------------------------------------------------------------

#: vhgw's half-widths: windows 3×3 to 183×183, the paper's uint8 crossover
VHGW_S = (1, 3, 7, 15, 31, 63, 91)
#: elementary filters of the naive per-filter chain
NAIVE_N = 64


def run_baselines(images, card: str) -> dict:
    """vhgw erosion against the ``"cuda"`` engine's ``E.erode`` chain of
    the same s (s elementary 3×3 steps give the (2s+1)² window) at N=8 ×
    1024² in uint8 and float64, and the naive chain at n = 64 beside the
    fused one.  Every vhgw result must equal the chain's.  No gain is
    claimed: it prints the crossover."""
    from repro_torch.api import E, compile
    from repro_torch.baselines import naive, vhgw

    out = {}
    inputs = {"uint8": images["uint8"],
              "float64": images["float32"].to(torch.float64)}
    for name, x in inputs.items():
        rows = []
        for s in VHGW_S:
            exe = compile(E.erode(s, E.input("f")), tuple(x.shape), x.dtype,
                          "cuda", device=DEVICE)
            if not same(vhgw.erode(x, s), exe(x)):
                raise AssertionError(f"baselines: vhgw != chain at s={s} "
                                     f"({name})")
            rows.append(dict(s=s, window=2 * s + 1,
                             vhgw_ms=cuda_ms(lambda: vhgw.erode(x, s), 5),
                             chain_ms=cuda_ms(lambda: exe(x), 5)))
        chain_wins = [r["s"] for r in rows if r["chain_ms"] < r["vhgw_ms"]]
        vhgw_wins = [r["s"] for r in rows if r["chain_ms"] >= r["vhgw_ms"]]
        fused = compile(E.erode(NAIVE_N, E.input("f")), tuple(x.shape),
                        x.dtype, "cuda", device=DEVICE)
        want = fused(x)
        sync()
        t0 = time.perf_counter()
        got = naive.chain(x, NAIVE_N, device=DEVICE)
        naive_ms = (time.perf_counter() - t0) * 1e3
        if not same(got, want):
            raise AssertionError(f"baselines: naive chain != fused ({name})")
        out[name] = dict(rows=rows, chain_faster_at=chain_wins,
                         vhgw_faster_at=vhgw_wins, naive_ms=naive_ms,
                         fused_ms=cuda_ms(lambda: fused(x), 5))
        for r in rows:
            log(f"baselines {name} s={r['s']} ({r['window']}x{r['window']}):"
                f" vhgw {r['vhgw_ms']:.3f} ms, chain {r['chain_ms']:.3f} ms")
        log(f"baselines {name}: vhgw equal to the chain at every s; chain "
            f"faster at s {chain_wins}, vhgw at s {vhgw_wins} (crossover: "
            f"{'none' if not vhgw_wins else min(vhgw_wins)}); naive chain "
            f"n={NAIVE_N} {naive_ms:.2f} ms (host clock, a sync a filter) "
            f"against fused {out[name]['fused_ms']:.3f} ms ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 10: distributed morphology (repro_torch.core.distributed)
# ---------------------------------------------------------------------------

#: Steps of the distributed chains (2 chunks of K = 32 in uint8, 4 of
#: K = 16 in float32).
DIST_N = 64
#: The kernels the distributed path must launch.
DIST_KERNELS = ("chain_step", "geodesic_chain_step")
#: The 2×2 grid's ranks, all on the one card under gloo.
DIST_RANKS = 4
#: Seconds the four ranks may take, start-up included.
DIST_TIMEOUT_S = 300


def dist_inputs(device) -> dict:
    """Case → inputs: a 1024² ``blobs`` image through the chain in uint8
    and float32, and the HMAX pair (marker f - 40, mask f)."""
    from repro_torch.core.operators import sat_sub
    from repro_torch.data.images import blobs

    u8 = torch.from_numpy(blobs(SIZE, SIZE, np.uint8)).to(device)
    f32 = torch.from_numpy(blobs(SIZE, SIZE, np.float32)).to(device)
    return {"chain/uint8": (u8,), "chain/float32": (f32,),
            "hmax40-rec/uint8": (sat_sub(u8, 40), u8)}


def halo_bytes(grid, block, k: int, itemsize: int) -> int:
    """Bytes all ranks send in one chunk's two-phase exchange: k rows of
    the block to each row neighbour, then k columns of the row-extended
    block to each column neighbour."""
    rows, cols = grid.shape
    h, w = block
    row_sends = 2 * (rows - 1) * cols
    col_sends = 2 * rows * (cols - 1)
    return itemsize * k * (row_sends * w + col_sends * (h + 2 * k))


def run_dist_cases(grid, rank: int, device, counters) -> tuple:
    """Every distributed case on this rank's blocks: one warm-up run,
    then the counted run, each case timed on the host clock around
    ``torch.cuda.synchronize()``.  Returns per-case rows, the gathered
    images and the counted launches."""
    from repro_torch.core import distributed as D
    from repro_torch.core.chain import plan_chain

    runs = {}
    for case, args in dist_inputs(device).items():
        blocks = [D.scatter_blocks(a, grid, rank).contiguous() for a in args]
        h, w = blocks[0].shape
        if case.startswith("chain"):
            fn = D.distributed_chain(grid, n=DIST_N, device=device)
            k = plan_chain(h, w, blocks[0].dtype, DIST_N).fuse_k
        else:
            fn = D.distributed_reconstruct(grid, op="dilate", device=device)
            k = plan_chain(h, w, blocks[0].dtype, None,
                           n_images_resident=2).fuse_k
        runs[case] = (fn, blocks, k)
        fn(*blocks)
    sync()
    for c in counters.values():
        c.launches = 0
    rows, outs = {}, {}
    for case, (fn, blocks, k) in runs.items():
        sync()
        t0 = time.perf_counter()
        local = fn(*blocks)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        chunks = getattr(fn, "chunks", -(-DIST_N // k))
        rows[case] = dict(ms=ms, k=k, chunks=chunks, block=[h, w],
                          halo_bytes_per_chunk=halo_bytes(
                              grid, blocks[0].shape, k,
                              blocks[0].element_size()))
        outs[case] = D.gather_blocks(local, grid)
    return rows, outs, {k: counters[k].launches for k in DIST_KERNELS}


def dist_rank(rank: int, tmp: str) -> None:
    """One of phase 10's gloo ranks (spawned): computes on the one card,
    carries its halos through host buffers, and writes its rows and
    launches (rank 0 also the gathered images) under ``tmp``."""
    from repro_torch.core import distributed as D

    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    with D.file_group(f"{tmp}/gloo", rank, DIST_RANKS, "gloo"):
        rows, outs, launches = run_dist_cases(
            D.RankGrid(2, 2), rank, torch.device("cuda", 0),
            kernel_modules())
    if rank == 0:
        torch.save({k: v.cpu() for k, v in outs.items()}, f"{tmp}/gloo.pt")
    pathlib.Path(f"{tmp}/rank{rank}.json").write_text(
        json.dumps(dict(rows=rows, launches=launches)))


def run_distributed(counters, card: str) -> dict:
    """(a) one rank under NCCL on a 1×1 grid, in this process; (b) a 2×2
    grid of four spawned gloo ranks on the one card (512² blocks, so the
    K-deep halos cross ranks).  Each case must equal the ``"torch"``
    engine, (b) must equal (a), and every rank's counted run must launch
    ``chain_step`` and ``geodesic_chain_step``.  No speed-up is claimed:
    one card cannot show one."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops

    inputs = dist_inputs(DEVICE)
    u8, f32 = inputs["chain/uint8"][0], inputs["chain/float32"][0]
    want = {"chain/uint8": ops.morph_chain(u8, DIST_N, "erode", "torch",
                                           device=DEVICE),
            "chain/float32": ops.morph_chain(f32, DIST_N, "erode", "torch",
                                             device=DEVICE),
            "hmax40-rec/uint8": ops.reconstruct_with_stats(
                *inputs["hmax40-rec/uint8"], "dilate", "torch",
                device=DEVICE)[0]}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        with D.file_group(f"{tmp}/nccl", 0, 1, "nccl"):
            rows, outs, launches = run_dist_cases(
                D.RankGrid(1, 1), 0, torch.device(DEVICE), counters)
        for case, got in outs.items():
            if not same(got, want[case]):
                raise AssertionError(
                    f"distributed nccl {case} != torch engine "
                    f"(max_abs_err={max_abs_err(got, want[case])})")
        missing = [k for k in DIST_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"distributed nccl never launched {missing}")
        out["nccl_1x1"] = dict(rows=rows, launches=launches)

        t0 = time.perf_counter()
        ctx = mp.start_processes(dist_rank, args=(tmp,), nprocs=DIST_RANKS,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > DIST_TIMEOUT_S:
                    raise TimeoutError(f"distributed gloo ranks still "
                                       f"running after {DIST_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        spawn_s = time.perf_counter() - t0
        gloo = torch.load(f"{tmp}/gloo.pt")
        ranks = [json.loads(pathlib.Path(f"{tmp}/rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
    for case, got in gloo.items():
        if not same(got.to(DEVICE), outs[case]):
            raise AssertionError(f"distributed gloo 2x2 {case} != the nccl "
                                 "1x1 run")
    for r, rec in enumerate(ranks):
        missing = [k for k in DIST_KERNELS if not rec["launches"][k]]
        if missing:
            raise AssertionError(f"distributed gloo rank {r} never launched "
                                 f"{missing}")
    gloo_rows = {case: dict(ranks[0]["rows"][case],
                            ms=max(rec["rows"][case]["ms"] for rec in ranks))
                 for case in ranks[0]["rows"]}
    out["gloo_2x2"] = dict(rows=gloo_rows, spawn_s=spawn_s,
                           launches=[rec["launches"] for rec in ranks])
    for run, rec in (("nccl 1x1", out["nccl_1x1"]),
                     ("gloo 2x2", out["gloo_2x2"])):
        for case, row in rec["rows"].items():
            log(f"distributed {run} {case}: {row['ms']:.2f} ms wall, "
                f"K={row['k']}, {row['chunks']} chunks, "
                f"{row['halo_bytes_per_chunk']} halo bytes a chunk, block "
                f"{row['block'][0]}x{row['block'][1]} ({card})")
        log(f"distributed {run}: equal to the torch engine; launches "
            f"{rec['launches']}")
    log(f"distributed gloo 2x2: four ranks on one card in {spawn_s:.1f} s "
        f"(start-up included)")
    return out


# ---------------------------------------------------------------------------
# phase 11: language-model serving (repro_torch.models, launch.serve)
# ---------------------------------------------------------------------------

#: H100 SXM dense bfloat16 tensor-core peak, without sparsity (NVIDIA
#: H100 data sheet): the rate of the prefill bound.
BF16_TENSOR_OPS_PER_S = 989e12

#: The slice's model, served at full width and depth.
LM_ARCH = "gemma-2b"
#: (b): batch, prompt, greedy decode steps, flash chunk (the launcher's)
LM_BATCH, LM_PROMPT, LM_GEN, LM_Q_CHUNK = 4, 128, 32, 128
#: (a): depth, prompt and decode steps of the card-against-CPU check
LM_CHECK_LAYERS, LM_CHECK_PROMPT, LM_CHECK_STEPS = 2, 32, 4
#: timed calls after a warm-up
LM_REPS = 10
#: decode steps of the profiled pass (the profiler's post-processing of
#: ~1,400 device events a step takes seconds)
LM_TRACE_STEPS = 8


def lm_config():
    from repro_torch.configs.registry import get_config

    return get_config(LM_ARCH)


@contextlib.contextmanager
def recorded_routes():
    """Every ``repro_torch.models.moe.route`` result while the block runs,
    in call order (a layer's chunks, layer by layer): the MoE phase
    reads its experts and dropped assignments from them after a run."""
    from repro_torch.models import moe as MOE

    calls, route = [], MOE.route

    def spy(*args):
        calls.append(route(*args))
        return calls[-1]

    MOE.route = spy
    try:
        yield calls
    finally:
        MOE.route = route


def lm_greedy(model, tokens, steps: int, q_chunk: int, **enc) -> tuple:
    """Prefill ``tokens`` (an encoder–decoder's encoder input in
    ``enc``), then ``steps`` greedy decode steps -> (every logits
    tensor, prefill's first; the tokens fed)."""
    from repro_torch.models import decode as DEC

    logits, cache = DEC.prefill(model, tokens, smax=tokens.shape[1] + steps,
                                q_chunk=q_chunk, **enc)
    out, fed = [logits], []
    for _ in range(steps):
        fed.append(logits.argmax(-1))
        logits, cache = DEC.decode_step(model, cache, fed[-1])
        out.append(logits)
    return out, torch.cat(fed, 1)


def lm_cross_device(cfg, layers: int = LM_CHECK_LAYERS,
                    prompt: int = LM_CHECK_PROMPT, batch: int = 1,
                    enc_frames: int = 0) -> dict:
    """(a) The full-width model cut to ``layers`` layers (an
    encoder–decoder's encoder too, fed ``enc_frames`` frames drawn after
    the tokens), in float32 activations, drawn on the CPU from seed 0:
    prefill of ``prompt`` tokens and every decode step's logits on the
    card against the CPU's within 1e-4 of max |logits|, the same greedy
    tokens and, for a MoE, the same experts for every token in every
    layer."""
    from repro_torch.models import model as MDL

    cfg = dataclasses.replace(
        cfg, n_layers=layers, activation_dtype="float32",
        encoder_layers=layers if cfg.is_enc_dec else 0)
    t0 = time.perf_counter()
    model = MDL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, prompt)))
    enc = ({"enc_embeds": torch.from_numpy(rng.standard_normal(
        (batch, enc_frames, cfg.d_model), dtype=np.float32))}
        if cfg.is_enc_dec else {})
    runs, routes = {}, {}
    for dev in ("cpu", DEVICE):
        model = model.to(dev)          # moves the parameters in place
        with recorded_routes() as calls:
            runs[dev] = lm_greedy(model, tokens.to(dev), LM_CHECK_STEPS,
                                  min(prompt, LM_Q_CHUNK),
                                  **{k: v.to(dev) for k, v in enc.items()})
            sync()
        routes[dev] = [r.gate_idx.cpu() for r in calls]
    (want, want_fed), (got, got_fed) = runs["cpu"], runs[DEVICE]
    flips = [(i, (g != w).any(-1).nonzero().tolist())
             for i, (g, w) in enumerate(zip(routes[DEVICE], routes["cpu"]))
             if not torch.equal(g, w)]
    if flips or len(routes["cpu"]) != len(routes[DEVICE]):
        raise AssertionError(f"lm serving (a): experts differ between card "
                             f"and CPU (route call, [row, token]): {flips}")
    errs = [max_abs_err(g.cpu(), w) / float(w.abs().max())
            for g, w in zip(got, want)]
    if max(errs) > 1e-4:
        raise AssertionError(f"lm serving (a): card != CPU, relative "
                             f"errors {errs} (bound 1e-4)")
    if not torch.equal(got_fed.cpu(), want_fed):
        raise AssertionError(f"lm serving (a): greedy tokens differ: card "
                             f"{got_fed.tolist()} CPU {want_fed.tolist()}")
    return dict(layers=cfg.n_layers, prompt=prompt, batch=batch,
                enc_frames=enc_frames, steps=LM_CHECK_STEPS, rel_errs=errs,
                tokens=got_fed.tolist(), route_calls=len(routes["cpu"]),
                seconds=time.perf_counter() - t0)


def lm_decode_check(model, kw, steps: int = LM_GEN) -> tuple:
    """The last of ``steps`` decode steps' logits against ``forward``
    over the prompt and the fed tokens (an encoder–decoder's over the
    same encoder input; ``tests/test_arch_smoke.py``'s check) -> (its
    relative error, every logit finite)."""
    from repro_torch.launch import serve
    from repro_torch.models import decode as DEC
    from repro_torch.models import model as MDL

    prompt = kw["tokens"].shape[1]
    logits, cache = DEC.prefill(model, smax=prompt + steps,
                                q_chunk=LM_Q_CHUNK, **kw)
    fed, last = serve.decode(model, cache, logits.argmax(-1), steps)
    enc = {k: v for k, v in kw.items() if k != "tokens"}
    full, _ = MDL.forward(model, torch.cat([kw["tokens"], fed], 1),
                          q_chunk=LM_Q_CHUNK, **enc)
    a, b = full[:, -1], last[:, 0]
    finite = all(bool(torch.isfinite(t).all()) for t in (logits, last, full))
    return max_abs_err(a, b) / float(a.abs().max()), finite


def lm_bounds(cfg, model, experts_read: float | None = None) -> dict:
    """The least times for this run's work: decode reads every bfloat16
    weight and the cache's filled slots (and writes one) a step, at the
    HBM rate; prefill's matrix products — the layers' weights a token
    touches over every prompt token, the unembedding of the last token,
    causal attention — at the dense bfloat16 tensor-core peak.

    For a MoE, ``experts_read`` is the distinct routed experts a decode
    step's routing chose, summed over the layers (counted from the
    run): the step reads those, the shared experts and every other
    weight but the embedding table, of which it gathers ``LM_BATCH``
    rows.  ``all_experts_ms`` is the read of every weight the port's
    dense expert products make instead."""
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    slot = (cfg.n_layers * 2 * LM_BATCH * cfg.n_kv_heads * cfg.head_dim
            * model.dtype.itemsize)
    kv_bytes = sum(slot * (LM_PROMPT + i + 2) for i in range(LM_GEN)) / LM_GEN
    d, v = cfg.d_model, cfg.vocab_size
    layer_params = cfg.active_param_count() - v * d * (
        1 if cfg.tie_embeddings else 2)
    tokens = LM_BATCH * LM_PROMPT
    attn = (2 * 2 * LM_BATCH * cfg.n_layers * cfg.n_heads * cfg.head_dim
            * LM_PROMPT * (LM_PROMPT + 1) // 2)
    prefill_ops = 2 * layer_params * tokens + 2 * d * v * LM_BATCH + attn
    out = dict(weight_bytes=weight_bytes, kv_bytes_per_token=kv_bytes,
               prefill_ops=prefill_ops,
               prefill_bound_ms=prefill_ops / BF16_TENSOR_OPS_PER_S * 1e3)
    read = weight_bytes
    if experts_read is not None:
        routed = sum(p.numel() * p.element_size() for layer in model.layers
                     for p in (layer.moe.gate, layer.moe.up, layer.moe.down))
        table = model.embed.table
        read = (weight_bytes - routed
                - (table.shape[0] - LM_BATCH) * table[0].nbytes
                + experts_read * routed / (cfg.n_layers * cfg.moe.n_experts))
        out.update(routed_expert_bytes=routed,
                   experts_read_per_token=experts_read,
                   all_experts_ms=(weight_bytes + kv_bytes) / HBM_BYTES_PER_S
                   * 1e3)
    out.update(read_bytes_per_token=read,
               decode_bound_ms=(read + kv_bytes) / HBM_BYTES_PER_S * 1e3)
    return out


def clone_cache(cache: dict) -> dict:
    """A copy of a serving cache: every entry's tensors cloned."""
    return {name: ([{n: t.clone() for n, t in e.items()} for e in v]
                   if isinstance(v, list) else v)
            for name, v in cache.items()}


def lm_timings(model, kw, card: str, trace_steps: int,
               reps: int = LM_REPS) -> dict:
    """(c) The served model's prefill ms (CUDA events, mean of ``reps``
    after a warm-up), decode ms/token (the second of two passes of
    ``LM_GEN`` steps), tok/s, peak memory, and one profiled prefill and
    ``trace_steps``-step decode pass."""
    from repro_torch.launch import serve
    from repro_torch.models import decode as DEC

    prompt = kw["tokens"].shape[1]
    smax = prompt + LM_GEN
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = cuda_ms(lambda: DEC.prefill(
        model, smax=smax, q_chunk=LM_Q_CHUNK, **kw), reps)
    decode_ms = []
    for _ in range(2):                  # the first pass is the warm-up
        logits, cache = DEC.prefill(model, smax=smax, q_chunk=LM_Q_CHUNK,
                                    **kw)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fed, last = serve.decode(model, cache, logits.argmax(-1), LM_GEN)
        stop.record()
        stop.synchronize()
        decode_ms.append(start.elapsed_time(stop) / LM_GEN)
        if not bool(torch.isfinite(last).all()):
            raise AssertionError("lm serving (c): non-finite logits")
    peak = torch.cuda.max_memory_allocated()
    logits, cache = DEC.prefill(model, smax=smax, q_chunk=LM_Q_CHUNK, **kw)
    traces = [
        profile_run(f"lm prefill {LM_BATCH}x{prompt}", lambda: DEC.prefill(
            model, smax=smax, q_chunk=LM_Q_CHUNK, **kw), card),
        profile_run(f"lm decode {trace_steps} steps", lambda: serve.decode(
            model, clone_cache(cache), logits.argmax(-1), trace_steps),
            card)]
    return dict(prefill_ms=prefill_ms, decode_ms_per_token=decode_ms[-1],
                decode_warmup_ms_per_token=decode_ms[0],
                tokens_per_s=LM_BATCH * 1e3 / decode_ms[-1], peak_bytes=peak,
                sample_tokens=fed[0, :10].tolist(), traces=traces,
                prefill_launches=traces[0]["device_events"],
                decode_launches_per_step=traces[1]["device_events"]
                / trace_steps)


def log_lm_timings(tag: str, out: dict, card: str) -> None:
    log(f"{tag} (c) prefill {out['prefill_ms']:.3f} ms (bound "
        f"{out['prefill_bound_ms']:.3f} ms: {out['prefill_ops']:.4g} "
        f"bfloat16 operations at {BF16_TENSOR_OPS_PER_S:.4g}/s) ({card})")
    log(f"{tag} (c) decode {out['decode_ms_per_token']:.3f} ms/token "
        f"(warm-up pass {out['decode_warmup_ms_per_token']:.3f}), "
        f"{out['tokens_per_s']:.1f} tok/s (bound "
        f"{out['decode_bound_ms']:.3f} ms/token: "
        f"{out['read_bytes_per_token']:.0f} weight bytes + "
        f"{out['kv_bytes_per_token']:.0f} cache bytes a token at "
        f"{HBM_BYTES_PER_S:.4g} B/s) ({card})")
    log(f"{tag} (c) peak memory {out['peak_bytes'] - out['held_before_bytes']}"
        f" bytes (torch.cuda.max_memory_allocated over the timed serving, "
        f"the bfloat16 model included, less the {out['held_before_bytes']} "
        f"bytes earlier phases held); sample token ids "
        f"{out['sample_tokens']}; phase {out['seconds']:.1f} s ({card})")


def run_lm_serving(card: str) -> dict:
    """(a) card against CPU at full width, two layers, float32; (b)
    gemma-2b at full width and depth: decode against ``forward`` in
    float32 (rel ≤ 2e-3) and in bfloat16 (reported), every logit finite;
    (c) the served model's prefill ms, decode ms/token, tok/s and peak
    memory beside their bounds.  Fails on any mismatch or non-finite
    logit."""
    from repro_torch.launch import serve
    from repro_torch.models import model as MDL

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm serving: the float32 checks need TF32 off")
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    cfg = lm_config()
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "cross_device": lm_cross_device(cfg)}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    masters = MDL.init_params(cfg32, torch.Generator(DEVICE).manual_seed(0),
                              DEVICE)
    kw = serve.prompt_inputs(cfg, LM_BATCH, LM_PROMPT, DEVICE)
    rel32, finite32 = lm_decode_check(masters, kw)
    del masters
    torch.cuda.empty_cache()
    if not finite32 or rel32 > 2e-3:
        raise AssertionError(f"lm serving (b): float32 decode != forward "
                             f"(rel {rel32}, bound 2e-3; finite {finite32})")

    model = serve.load_model(cfg, DEVICE, seed=0)   # the same draws
    rel16, finite16 = lm_decode_check(model, kw)
    if not finite16:
        raise AssertionError("lm serving (b): non-finite bfloat16 logits")
    load_s = time.perf_counter() - t0

    out.update(lm_timings(model, kw, card, LM_TRACE_STEPS))
    out.update(lm_bounds(cfg, model))
    out.update(
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, q_chunk=LM_Q_CHUNK,
        decode_vs_forward_rel_float32=rel32,
        decode_vs_forward_rel_bfloat16=rel16, load_and_check_s=load_s,
        held_before_bytes=held)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase

    x = out["cross_device"]
    log(f"lm serving (a) {cfg.name} at {x['layers']} layers, float32, "
        f"prompt {x['prompt']}, {x['steps']} decode steps: card equals "
        f"CPU within {max(x['rel_errs']):.2e} of max |logits| (bound "
        f"1e-4), the same greedy tokens {x['tokens'][0]} "
        f"({x['seconds']:.1f} s) ({card})")
    log(f"lm serving (b) {cfg.name} full width and depth ({out['params']} "
        f"parameters), batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} "
        f"decode steps: decode vs forward rel {rel32:.2e} in float32 "
        f"(bound 2e-3), {rel16:.2e} in bfloat16 (no bound); every logit "
        f"finite ({card})")
    log_lm_timings("lm serving", out, card)
    return out


# ---------------------------------------------------------------------------
# phase 12: MoE serving (repro_torch.models.moe)
# ---------------------------------------------------------------------------

#: The MoE slice's model, served at full width and depth.
MOE_ARCH = "deepseek-moe-16b"
#: (b): the float32 check's depth (28 float32 layers are 67.5 GB)
MOE_FLOAT32_LAYERS = 14
#: decode steps of the profiled pass (~2,800 device launches a step)
MOE_TRACE_STEPS = 4
#: (d): arctic-480b at full width, cut to one layer (35 are 954 GB in
#: bfloat16: no single card holds them), and its decode steps
ARCTIC_ARCH, ARCTIC_LAYERS, ARCTIC_GEN = "arctic-480b", 1, 8


def no_drop(cfg):
    """``cfg`` with ``capacity_factor`` E/K: then C ≥ a chunk's tokens and
    no assignment drops, so ``forward`` over the prompt and the fed
    tokens routes every token as prefill and decode do."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def run_lm_moe(card: str) -> dict:
    """(a) card against CPU at full width, two layers, float32, the same
    experts; (b) decode against ``forward`` at ``capacity_factor`` E/K:
    float32 at ``MOE_FLOAT32_LAYERS`` layers (rel ≤ 2e-3), bfloat16 at
    full depth (reported), every logit finite; (c) the served bfloat16
    model, configuration as written: prefill ms, decode ms/token, tok/s,
    peak memory beside their bounds, the served prefill's dropped
    assignments; (d) arctic-480b at full width, one layer, bfloat16:
    every logit finite, decode against ``forward`` reported.  Fails on
    any mismatch or non-finite logit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode as DEC
    from repro_torch.models import model as MDL

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    cfg = get_config(MOE_ARCH)
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(),
           "cross_device": lm_cross_device(cfg)}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(no_drop(cfg), n_layers=MOE_FLOAT32_LAYERS,
                                activation_dtype="float32")
    masters = MDL.init_params(cfg32, torch.Generator(DEVICE).manual_seed(0),
                              DEVICE)
    kw = serve.prompt_inputs(cfg, LM_BATCH, LM_PROMPT, DEVICE)
    rel32, finite32 = lm_decode_check(masters, kw)
    del masters
    torch.cuda.empty_cache()
    if not finite32 or rel32 > 2e-3:
        raise AssertionError(f"lm moe (b): float32 decode != forward "
                             f"(rel {rel32}, bound 2e-3; finite {finite32})")
    model = serve.load_model(no_drop(cfg), DEVICE, seed=0)
    rel16, finite16 = lm_decode_check(model, kw)
    del model
    torch.cuda.empty_cache()
    if not finite16:
        raise AssertionError("lm moe (b): non-finite bfloat16 logits")
    load_s = time.perf_counter() - t0

    model = serve.load_model(cfg, DEVICE, seed=0)   # the same draws
    with recorded_routes() as calls:
        logits, cache = DEC.prefill(model, smax=LM_PROMPT + LM_GEN,
                                    q_chunk=LM_Q_CHUNK, **kw)
        by_layer = [int((~r.valid).sum()) for r in calls]
        dropped = sum(by_layer)
        assignments = sum(r.valid.numel() for r in calls)
        del calls[:]
        serve.decode(model, cache, logits.argmax(-1), LM_GEN)
        experts = sum(int(r.gate_idx.unique().numel())
                      for r in calls) / LM_GEN
    del logits, cache
    out.update(lm_timings(model, kw, card, MOE_TRACE_STEPS))
    out.update(lm_bounds(cfg, model, experts))
    out.update(
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, q_chunk=LM_Q_CHUNK,
        float32_layers=MOE_FLOAT32_LAYERS,
        decode_vs_forward_rel_float32=rel32,
        decode_vs_forward_rel_bfloat16=rel16, load_and_check_s=load_s,
        prefill_dropped=dropped, prefill_dropped_by_layer=by_layer,
        prefill_assignments=assignments,
        held_before_bytes=held)
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    acfg = no_drop(dataclasses.replace(get_config(ARCTIC_ARCH),
                                       n_layers=ARCTIC_LAYERS))
    model = serve.load_model(acfg, DEVICE, seed=0)
    akw = serve.prompt_inputs(acfg, LM_BATCH, LM_PROMPT, DEVICE)
    arel, afinite = lm_decode_check(model, akw, ARCTIC_GEN)
    abytes = sum(p.numel() * p.element_size() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    if not afinite:
        raise AssertionError("lm moe (d): non-finite arctic-480b logits")
    full = get_config(ARCTIC_ARCH)
    out["arctic"] = dict(arch=acfg.name, layers=ARCTIC_LAYERS,
                         full_layers=full.n_layers,
                         full_params=full.param_count(),
                         weight_bytes=abytes, gen=ARCTIC_GEN,
                         decode_vs_forward_rel_bfloat16=arel,
                         seconds=time.perf_counter() - t0)
    out["seconds"] = time.perf_counter() - t_phase

    x = out["cross_device"]
    log(f"lm moe (a) {cfg.name} at {x['layers']} layers, float32, prompt "
        f"{x['prompt']}, {x['steps']} decode steps: card equals CPU within "
        f"{max(x['rel_errs']):.2e} of max |logits| (bound 1e-4), the same "
        f"greedy tokens {x['tokens'][0]} and the same experts in all "
        f"{x['route_calls']} routing calls ({x['seconds']:.1f} s) ({card})")
    log(f"lm moe (b) {cfg.name} full width ({out['params']} parameters, "
        f"{out['active_params']} active a token), capacity_factor E/K, "
        f"batch {LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} decode steps: "
        f"decode vs forward rel {rel32:.2e} in float32 at "
        f"{MOE_FLOAT32_LAYERS} layers (bound 2e-3), {rel16:.2e} in "
        f"bfloat16 at {cfg.n_layers} (no bound); every logit finite "
        f"({card})")
    log(f"lm moe (c) served prefill (capacity_factor "
        f"{cfg.moe.capacity_factor}): {dropped} of {assignments} "
        f"assignments dropped (by layer {by_layer}); decode reads "
        f"{experts:.2f} distinct routed "
        f"experts a token over {cfg.n_layers} layers; the dense expert "
        f"products read every weight, {out['weight_bytes']} bytes "
        f"({out['all_experts_ms']:.3f} ms a token at {HBM_BYTES_PER_S:.4g}"
        f" B/s) ({card})")
    log_lm_timings("lm moe", out, card)
    a = out["arctic"]
    log(f"lm moe (d) {a['arch']} at full width, {a['layers']} of "
        f"{a['full_layers']} layers ({a['weight_bytes']} bytes in bfloat16; "
        f"all {a['full_layers']} layers, {a['full_params']} parameters, fit "
        f"no single card), "
        f"capacity_factor E/K, batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{ARCTIC_GEN} decode steps: decode vs forward rel "
        f"{a['decode_vs_forward_rel_bfloat16']:.2e} in bfloat16 (no bound); "
        f"every logit finite ({a['seconds']:.1f} s) ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 13: the recurrent layer kinds (repro_torch.models.ssm, .xlstm)
# ---------------------------------------------------------------------------

#: The recurrent slice's models: zamba2-7b (Mamba2 and a shared
#: attention block) and xlstm-350m, served at full width and depth
ZAMBA_ARCH, XLSTM_ARCH = "zamba2-7b", "xlstm-350m"
#: (a), (b): a prompt of two 128-token scan chunks; (a) cuts zamba2 to
#: one group of 6 layers, the shared block and one tail layer
REC_PROMPT, ZAMBA_CHECK_LAYERS = 256, 7
#: (a): xlstm-350m's whole stack against the CPU over 4 prompt tokens.
#: Its sLSTM under the reference's initialiser (``r`` at std 0.5 over
#: 256-wide heads) is chaotic: on the CPU a 1e-7 relative perturbation
#: of the embeddings moves the logits of the prefill and 4 greedy steps
#: by up to 1.8e-5 at 4 tokens, 3.4e-5 at 8, 1.2e-4 at 16, 5e-3 at 32
#: and 0.5 at 64, so no two devices' float32 agree within 1e-4 further
#: out.  The 256-token prompt (two chunks) runs through its first mLSTM
#: layer alone.
XLSTM_CHECK_PROMPT = 4
#: (b): greedy steps, so that ``forward`` runs prompt + steps = 384
#: tokens, three whole chunks
REC_CHECK_GEN = 128
#: (c): timed prefill calls (an xlstm-350m prefill is ~23,000 launches)
#: and the decode steps of the profiled pass
REC_REPS = {ZAMBA_ARCH: LM_REPS, XLSTM_ARCH: 3}
REC_TRACE_STEPS = 4


def rec_bounds(cfg, model, prompt: int) -> dict:
    """The least times for this run's work on a recurrent stack.

    Decode reads every bfloat16 weight once a step — the shared block's
    once for each of its uses (0.41 GB does not stay in a 50 MB L2), the
    tied table for the unembedding — reads and writes every layer's
    state, and reads the shared blocks' filled k/v slots (writing one),
    at the HBM rate.  Prefill's products: the matrix weights a token
    touches over every prompt token, the last token's unembedding, the
    scans' bfloat16 products (C·Bᵀ, q·kᵀ) and causal attention at the
    bfloat16 tensor-core peak; the scans' float32 products (against the
    float32 states and decays; the lower triangle of a chunk's L × L)
    at the float32 peak."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models.model import shared_groups

    def nbytes(mod):
        return sum(p.numel() * p.element_size() for p in mod.parameters())

    def matrix_params(mod):
        return sum(p.numel() for n, p in mod.named_parameters()
                   if p.ndim == 2 and not n.endswith("conv_w"))

    b, d, item = LM_BATCH, cfg.d_model, model.dtype.itemsize
    uses = len(shared_groups(cfg))
    weight_bytes = nbytes(model)
    read = weight_bytes
    per_token = sum(matrix_params(layer) for layer in model.layers)
    bf16_ops = 2 * d * cfg.vocab_size * b
    f32_ops = 0
    state = 0
    chunk = min(128, prompt)
    n_chunks = prompt // chunk
    tri = chunk * (chunk + 1) // 2
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "mamba2":
            d_in, h = SSM.ssm_dims(d, cfg.ssm_head_dim)
            hp, n = cfg.ssm_head_dim, cfg.ssm_state
            state += b * (h * hp * n * 4 + (SSM.CONV_K - 1) * (d_in + 2 * n)
                          * item)
            bf16_ops += 2 * b * n_chunks * tri * n
            f32_ops += 2 * b * n_chunks * (tri * h * hp + 2 * chunk * h * hp * n)
        elif kind == "mlstm":
            hn, hp = cfg.n_heads, 2 * d // cfg.n_heads
            state += b * hn * (hp * hp + hp + 1) * 4
            bf16_ops += 2 * b * n_chunks * tri * hn * hp
            f32_ops += 2 * b * n_chunks * (tri * hn * hp
                                           + 2 * chunk * hn * hp * hp)
        else:
            hn, hp = cfg.n_heads, d // cfg.n_heads
            state += b * 4 * d * 4
            f32_ops += 2 * b * prompt * hn * hp * 4 * hp
    shared_kv = 0
    if model.shared_attn is not None:
        read += (uses - 1) * nbytes(model.shared_attn)
        per_token += uses * matrix_params(model.shared_attn)
        bf16_ops += uses * 2 * 2 * b * cfg.n_heads * cfg.head_dim * (
            prompt * (prompt + 1) // 2)
        slot = uses * 2 * b * cfg.n_kv_heads * cfg.head_dim * item
        shared_kv = sum(slot * (prompt + i + 2) for i in range(LM_GEN)) / LM_GEN
    bf16_ops += 2 * per_token * b * prompt
    prefill_ms = (bf16_ops / BF16_TENSOR_OPS_PER_S
                  + f32_ops / PEAK_OPS_PER_S) * 1e3
    cache_bytes = 2 * state + shared_kv
    return dict(weight_bytes=weight_bytes, read_bytes_per_token=read,
                state_bytes=state, kv_bytes_per_token=cache_bytes,
                prefill_ops=bf16_ops, prefill_f32_ops=f32_ops,
                prefill_bound_ms=prefill_ms,
                decode_bound_ms=(read + cache_bytes) / HBM_BYTES_PER_S * 1e3)


def mlstm_layer_cross_device(cfg) -> dict:
    """(a) xlstm-350m's first layer (mLSTM) at full width, float32, drawn
    on the CPU from seed 0, over a ``REC_PROMPT``-token prompt (two scan
    chunks, so the card carries (C, n, m) across a chunk boundary): its
    output and final state on the card against the CPU's within 1e-4 of
    max |reference|, leaf by leaf."""
    from repro_torch.models import model as MDL

    cfg = dataclasses.replace(cfg, n_layers=1, activation_dtype="float32")
    t0 = time.perf_counter()
    model = MDL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, REC_PROMPT)))
    runs = {}
    with torch.no_grad():
        for dev in ("cpu", DEVICE):
            model = model.to(dev)
            x = MDL.embed_inputs(model, tokens.to(dev))
            y, state = MDL.recurrent_sublayer(model.layers[0], x)
            runs[dev] = {"y": y.cpu(), **{n: t.cpu() for n, t in
                                          state.items()}}
    errs = {n: max_abs_err(runs[DEVICE][n], w) / float(w.abs().max())
            for n, w in runs["cpu"].items()}
    if max(errs.values()) > 1e-4:
        raise AssertionError(f"lm recurrent (a): the mLSTM layer's card != "
                             f"CPU, relative errors {errs} (bound 1e-4)")
    return dict(prompt=REC_PROMPT, rel_errs=errs,
                seconds=time.perf_counter() - t0)


def rec_served(arch: str, card: str) -> dict:
    """(c) One served bfloat16 model at full width and depth, drawn on the
    card from seed 0: phase 11's timings and trace beside
    ``rec_bounds``; every logit finite."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    cfg = get_config(arch)
    model = serve.load_model(cfg, DEVICE, seed=0)
    kw = serve.prompt_inputs(cfg, LM_BATCH, LM_PROMPT, DEVICE)
    out = {"arch": arch, "batch": LM_BATCH,
           "params": sum(p.numel() for p in model.parameters()),
           "prompt": LM_PROMPT, "gen": LM_GEN, "held_before_bytes": held}
    out.update(lm_timings(model, kw, card, REC_TRACE_STEPS, REC_REPS[arch]))
    out.update(rec_bounds(cfg, model, LM_PROMPT))
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def run_lm_recurrent(card: str) -> dict:
    """(a) card against CPU, float32, weights drawn on the CPU, 4 greedy
    steps within 1e-4 of max |logits| and the same tokens: zamba2-7b at
    full width cut to 7 layers (one group, the shared block, one tail
    layer) with a 256-token prompt, xlstm-350m at full width and depth
    with a 4-token prompt (``XLSTM_CHECK_PROMPT``: its sLSTM is chaotic)
    and its first mLSTM layer over 256 tokens; (b)
    zamba2-7b at full width and depth, batch 4, a 256-token prompt and
    128 greedy steps: decode against ``forward`` within 2e-3 in float32,
    bfloat16 reported, every logit finite; (c) both served models'
    timings beside their bounds.  Fails on any mismatch or non-finite
    logit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as MDL

    t_phase = time.perf_counter()
    zcfg, xcfg = get_config(ZAMBA_ARCH), get_config(XLSTM_ARCH)
    out = {"cross_device": {
        ZAMBA_ARCH: lm_cross_device(zcfg, ZAMBA_CHECK_LAYERS, REC_PROMPT),
        XLSTM_ARCH: lm_cross_device(xcfg, xcfg.n_layers,
                                    XLSTM_CHECK_PROMPT)},
        "mlstm_layer": mlstm_layer_cross_device(xcfg)}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(zcfg, activation_dtype="float32")
    masters = MDL.init_params(cfg32, torch.Generator(DEVICE).manual_seed(0),
                              DEVICE)
    kw = serve.prompt_inputs(zcfg, LM_BATCH, REC_PROMPT, DEVICE)
    rel32, finite32 = lm_decode_check(masters, kw, REC_CHECK_GEN)
    del masters
    torch.cuda.empty_cache()
    if not finite32 or rel32 > 2e-3:
        raise AssertionError(f"lm recurrent (b): float32 decode != forward "
                             f"(rel {rel32}, bound 2e-3; finite {finite32})")
    model = serve.load_model(zcfg, DEVICE, seed=0)   # the same draws
    rel16, finite16 = lm_decode_check(model, kw, REC_CHECK_GEN)
    del model
    torch.cuda.empty_cache()
    if not finite16:
        raise AssertionError("lm recurrent (b): non-finite bfloat16 logits")
    out["decode_vs_forward"] = dict(
        arch=ZAMBA_ARCH, batch=LM_BATCH, prompt=REC_PROMPT,
        steps=REC_CHECK_GEN, rel_float32=rel32, rel_bfloat16=rel16,
        seconds=time.perf_counter() - t0)
    out["served"] = {arch: rec_served(arch, card)
                     for arch in (ZAMBA_ARCH, XLSTM_ARCH)}
    out["seconds"] = time.perf_counter() - t_phase

    for arch, x in out["cross_device"].items():
        log(f"lm recurrent (a) {arch} at full width, {x['layers']} layers, "
            f"float32, prompt {x['prompt']}, {x['steps']} decode steps: card "
            f"equals CPU within {max(x['rel_errs']):.2e} of max |logits| "
            f"(bound 1e-4), the same greedy tokens {x['tokens'][0]} "
            f"({x['seconds']:.1f} s) ({card})")
    x = out["mlstm_layer"]
    log(f"lm recurrent (a) {XLSTM_ARCH} layer 0 (mLSTM) at full width, "
        f"float32, prompt {x['prompt']} (two chunks): card equals CPU, "
        f"relative errors {json.dumps(x['rel_errs'])} (bound 1e-4) "
        f"({x['seconds']:.1f} s) ({card})")
    log(f"lm recurrent (b) {ZAMBA_ARCH} full width and depth "
        f"({out['served'][ZAMBA_ARCH]['params']} parameters), batch "
        f"{LM_BATCH}, prompt "
        f"{REC_PROMPT}, {REC_CHECK_GEN} decode steps: decode vs forward rel "
        f"{rel32:.2e} in float32 (bound 2e-3), {rel16:.2e} in bfloat16 (no "
        f"bound); every logit finite "
        f"({out['decode_vs_forward']['seconds']:.1f} s) ({card})")
    for arch, x in out["served"].items():
        tag = f"lm recurrent {arch}"
        log_lm_timings(tag, x, card)
        log(f"{tag} (c) launches: prefill {x['prefill_launches']}, decode "
            f"{x['decode_launches_per_step']:.0f} a step; prefill bound adds "
            f"{x['prefill_f32_ops']:.4g} float32 scan operations at "
            f"{PEAK_OPS_PER_S:.4g}/s; state {x['state_bytes']} bytes read "
            f"and written a step; {x['weight_bytes']} weight bytes "
            f"({x['params']} parameters) ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 14: the encoder–decoder (Model.encoder, cross-attention)
# ---------------------------------------------------------------------------

#: The encoder–decoder slice's model, served at full width and depth
ENCDEC_ARCH = "seamless-m4t-large-v2"
#: (a): batch and encoder frames of the card-against-CPU check (200 is
#: no multiple of a flash chunk: the non-causal tiles pad their keys)
ENCDEC_CHECK_BATCH, ENCDEC_CHECK_FRAMES = 2, 200
#: (c): the encoder frames of the one long prefill, and its timed calls
#: (~1.5 s each: ~64 flash tiles a layer in the encoder)
ENCDEC_LONG_FRAMES, ENCDEC_LONG_REPS = 1024, 3


def encdec_bounds(cfg, model, enc_frames: int) -> dict:
    """The least times for an encoder–decoder's work (``LM_BATCH``
    sequences of ``LM_PROMPT`` tokens over ``enc_frames`` encoder
    frames).

    Decode reads, a step, the decoder's bfloat16 weights and the tied
    table for the unembedding — not the encoder's, which prefill alone
    uses — the self-attention cache's filled slots (writing one), and
    every layer's cross ``ck``/``cv``, at the HBM rate.  Prefill's
    products at the bfloat16 tensor-core peak: the encoder's matrices
    over every frame and its non-causal attention (every frame against
    every frame), the decoder's matrices over every prompt token but
    the cross ``wk``/``wv``, which run over every frame, causal
    self-attention, cross attention (every token against every frame),
    and the last token's unembedding."""
    def nbytes(params):
        return sum(p.numel() * p.element_size() for p in params)

    def matrices(mod):
        return sum(p.numel() for p in mod.parameters() if p.ndim == 2)

    b, s, e, item = LM_BATCH, LM_PROMPT, enc_frames, model.dtype.itemsize
    n_dec, n_enc = cfg.n_layers, cfg.encoder_layers
    heads = cfg.n_heads * cfg.head_dim
    weight_bytes = nbytes(model.parameters())
    encoder_bytes = (nbytes(model.encoder.parameters())
                     + nbytes(model.enc_final_norm.parameters()))
    read = weight_bytes - encoder_bytes
    slot = n_dec * 2 * b * cfg.n_kv_heads * cfg.head_dim * item
    kv_bytes = sum(slot * (s + i + 2) for i in range(LM_GEN)) / LM_GEN
    cross_bytes = slot * e
    cross_kv = sum(layer.cross.wk.numel() + layer.cross.wv.numel()
                   for layer in model.layers)
    encoder_ops = (2 * sum(matrices(layer) for layer in model.encoder) * b * e
                   + 2 * 2 * b * n_enc * heads * e * e)
    decoder_ops = (2 * (sum(matrices(layer) for layer in model.layers)
                        - cross_kv) * b * s
                   + 2 * cross_kv * b * e
                   + 2 * 2 * b * n_dec * heads * s * (s + 1) // 2
                   + 2 * 2 * b * n_dec * heads * s * e
                   + 2 * cfg.d_model * cfg.vocab_size * b)
    ops = encoder_ops + decoder_ops
    return dict(weight_bytes=weight_bytes, encoder_bytes=encoder_bytes,
                read_bytes_per_token=read,
                kv_bytes_per_token=kv_bytes + cross_bytes,
                cross_bytes_per_token=cross_bytes, enc_frames=e,
                prefill_ops=ops, prefill_encoder_ops=encoder_ops,
                prefill_bound_ms=ops / BF16_TENSOR_OPS_PER_S * 1e3,
                decode_bound_ms=(read + kv_bytes + cross_bytes)
                / HBM_BYTES_PER_S * 1e3)


def run_lm_encdec(card: str) -> dict:
    """(a) card against CPU at full width, 2 + 2 layers, float32, batch 2,
    200 encoder frames; (b) seamless-m4t-large-v2 at full width and
    depth: decode against ``forward`` in float32 (rel ≤ 2e-3) and in
    bfloat16 (reported), every logit finite; (c) the served model's
    prefill ms, decode ms/token, tok/s, peak memory and launches beside
    ``encdec_bounds``, and a prefill over ``ENCDEC_LONG_FRAMES`` frames.
    Fails on any mismatch or non-finite logit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode as DEC
    from repro_torch.models import model as MDL

    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    cfg = get_config(ENCDEC_ARCH)
    out = {"arch": cfg.name, "params": cfg.param_count(),
           "cross_device": lm_cross_device(
               cfg, batch=ENCDEC_CHECK_BATCH,
               enc_frames=ENCDEC_CHECK_FRAMES)}
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    masters = MDL.init_params(cfg32, torch.Generator(DEVICE).manual_seed(0),
                              DEVICE)
    kw = serve.prompt_inputs(cfg, LM_BATCH, LM_PROMPT, DEVICE)
    rel32, finite32 = lm_decode_check(masters, kw)
    del masters
    torch.cuda.empty_cache()
    if not finite32 or rel32 > 2e-3:
        raise AssertionError(f"lm encdec (b): float32 decode != forward "
                             f"(rel {rel32}, bound 2e-3; finite {finite32})")
    model = serve.load_model(cfg, DEVICE, seed=0)   # the same draws
    rel16, finite16 = lm_decode_check(model, kw)
    if not finite16:
        raise AssertionError("lm encdec (b): non-finite bfloat16 logits")
    load_s = time.perf_counter() - t0

    out.update(lm_timings(model, kw, card, LM_TRACE_STEPS))
    out.update(encdec_bounds(cfg, model, kw["enc_embeds"].shape[1]))
    frames = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (LM_BATCH, ENCDEC_LONG_FRAMES, cfg.d_model),
        dtype=np.float32)).to(DEVICE)
    long_kw = dict(kw, enc_embeds=frames)
    logits, _ = DEC.prefill(model, smax=LM_PROMPT + LM_GEN,
                            q_chunk=LM_Q_CHUNK, **long_kw)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("lm encdec (c): non-finite logits over "
                             f"{ENCDEC_LONG_FRAMES} frames")
    del logits
    long_bounds = encdec_bounds(cfg, model, ENCDEC_LONG_FRAMES)
    out["long_prefill"] = dict(
        enc_frames=ENCDEC_LONG_FRAMES,
        prefill_ms=cuda_ms(lambda: DEC.prefill(
            model, smax=LM_PROMPT + LM_GEN, q_chunk=LM_Q_CHUNK, **long_kw),
            ENCDEC_LONG_REPS),
        **{k: long_bounds[k] for k in ("prefill_ops", "prefill_encoder_ops",
                                       "prefill_bound_ms")})
    out.update(
        batch=LM_BATCH, prompt=LM_PROMPT, gen=LM_GEN, q_chunk=LM_Q_CHUNK,
        decode_vs_forward_rel_float32=rel32,
        decode_vs_forward_rel_bfloat16=rel16, load_and_check_s=load_s,
        held_before_bytes=held)
    del model, frames, long_kw
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase

    x = out["cross_device"]
    log(f"lm encdec (a) {cfg.name} at full width, {x['layers']} encoder + "
        f"{x['layers']} decoder layers, float32, batch {x['batch']}, prompt "
        f"{x['prompt']} over {x['enc_frames']} encoder frames, {x['steps']} "
        f"decode steps: card equals CPU within {max(x['rel_errs']):.2e} of "
        f"max |logits| (bound 1e-4), the same greedy tokens {x['tokens']} "
        f"({x['seconds']:.1f} s) ({card})")
    log(f"lm encdec (b) {cfg.name} full width and depth ({cfg.encoder_layers}"
        f" + {cfg.n_layers} layers, {out['params']} parameters), batch "
        f"{LM_BATCH}, prompt {LM_PROMPT} over {LM_PROMPT} frames, {LM_GEN} "
        f"decode steps: decode vs forward rel {rel32:.2e} in float32 (bound "
        f"2e-3), {rel16:.2e} in bfloat16 (no bound); every logit finite "
        f"({card})")
    tag = "lm encdec"
    log_lm_timings(tag, out, card)
    log(f"{tag} (c) launches: prefill {out['prefill_launches']}, decode "
        f"{out['decode_launches_per_step']:.0f} a step; decode reads "
        f"{out['read_bytes_per_token']} weight bytes of "
        f"{out['weight_bytes']} (the encoder's {out['encoder_bytes']} not) "
        f"and {out['cross_bytes_per_token']} bytes of cross ck/cv a step; "
        f"prefill bound: {out['prefill_encoder_ops']:.4g} of the "
        f"operations in the encoder ({card})")
    x = out["long_prefill"]
    log(f"{tag} (c) prefill over {x['enc_frames']} encoder frames: "
        f"{x['prefill_ms']:.3f} ms (mean of {ENCDEC_LONG_REPS}; bound "
        f"{x['prefill_bound_ms']:.3f} ms: {x['prefill_ops']:.4g} bfloat16 "
        f"operations, "
        f"{x['prefill_encoder_ops']:.4g} in the encoder) ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 15: language-model training (repro_torch.train, launch.train)
# ---------------------------------------------------------------------------

#: The slice's model, trained at full width and depth.
TRAIN_ARCH = "gemma-2b"
#: (a): depth, batch and tokens of the card-against-CPU gradient check
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 1, 64
#: (a'): the other families, reduced (a MoE at batch 1), over 32 tokens
TRAIN_CHECK_ARCHS = ("deepseek-moe-16b", "zamba2-7b", "xlstm-350m",
                     "seamless-m4t-large-v2")
#: (b): Trainer steps, timed steps after a warm-up, same-batch steps
TRAIN_STEPS, TRAIN_REPS, TRAIN_DESCENT_STEPS = 6, 3, 4
#: (c): reduced gemma-2b steps, checkpoint period, injected failure
RESUME_STEPS, RESUME_EVERY, RESUME_FAIL_AT = 6, 3, 4


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| / max |want|, inf where either is not finite."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        return float("inf")
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def train_cross_device(cfg, batch: int, seq: int) -> dict:
    """(a) ``loss_fn``'s loss and every parameter's gradient on the card
    against the CPU: float32 activations, the same weights (drawn on the
    CPU from seed 0) and batch (``TokenPipeline`` seed 0, a few labels
    -1, an encoder–decoder's ``enc_embeds`` of ``seq`` frames); each
    gradient within 1e-4 of its max |CPU gradient|."""
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models import model as MDL

    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, activation_dtype="float32")
    model = MDL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    data = TokenPipeline(cfg.vocab_size, seq, batch, 0).batch(0)
    data["labels"][0, :3] = -1
    if cfg.is_enc_dec:
        data["enc_embeds"] = np.random.default_rng(0).standard_normal(
            (batch, seq, cfg.d_model), dtype=np.float32)
    runs = {}
    for dev in ("cpu", DEVICE):
        model = model.to(dev)          # moves the parameters in place
        loss, metrics = MDL.loss_fn(
            model, {k: torch.from_numpy(v).to(dev) for k, v in data.items()},
            q_chunk=min(seq, LM_Q_CHUNK))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs[dev] = (loss.detach().cpu(), [g.cpu() for g in grads])
        del loss, grads
    names = [n for n, _ in model.named_parameters()]
    errs = {n: rel_err(g, w) for n, g, w in zip(names, runs[DEVICE][1],
                                                 runs["cpu"][1])}
    worst = max(errs, key=errs.get)
    loss_rel = rel_err(runs[DEVICE][0], runs["cpu"][0])
    if errs[worst] > 1e-4 or loss_rel > 1e-4:
        raise AssertionError(
            f"lm train (a) {cfg.name}: card != CPU, loss rel {loss_rel}, "
            f"worst gradient {worst} rel {errs[worst]} (bound 1e-4)")
    del model
    return dict(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                batch=batch, seq=seq, loss=float(runs["cpu"][0]),
                loss_rel=loss_rel, worst_param=worst,
                worst_rel=errs[worst], n_params=len(names),
                seconds=time.perf_counter() - t0)


def train_bounds(model, batch: int, seq: int) -> dict:
    """The least times of one step: forward, the recompute of
    ``remat="full"`` and backward (2×) make 8 × N × tokens matrix-product
    operations (N the parameters: the tied table is the unembedding),
    plus the causal attention products (QKᵀ and PV, each 2 × hd
    operations a query–key pair, 4× for the same passes), at the dense
    bfloat16 tensor-core peak; AdamW reads p, g, m, v and writes p, m, v
    in float32, 28 bytes a parameter, at the HBM rate."""
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    attn = (4 * batch * cfg.n_layers * cfg.n_heads * cfg.head_dim
            * seq * (seq + 1) // 2)
    ops = 8 * n * batch * seq + 4 * attn
    opt_bytes = sum(p.numel() * (p.element_size() * 3 + 4 * 4)
                    for p in model.parameters())
    fb_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    return dict(n=n, train_ops=ops, opt_bytes=opt_bytes,
                fwd_bwd_bound_ms=fb_ms, opt_bound_ms=opt_ms,
                step_bound_ms=fb_ms + opt_ms)


def train_resume(card: str) -> dict:
    """(c) Reduced gemma-2b through the ``Trainer`` on the card, 6 steps
    checkpointed every 3: uninterrupted, and failed at step 4, restored
    and finished.  The final parameters and moments must be equal bit
    for bit (a difference fails, reported with its size and leaf), and
    the last checkpoint, written from the card, restored onto a CPU
    template equals the card's state."""
    import tempfile

    from repro_torch.configs.registry import get_reduced
    from repro_torch.train import loop

    t0 = time.perf_counter()
    cfg = get_reduced(TRAIN_ARCH)
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = loop.TrainerConfig(
            steps=RESUME_STEPS, seq_len=32, global_batch=4,
            checkpoint_every=RESUME_EVERY, q_chunk=16, checkpoint_dir=tmp,
            log_every=100)
        state_a, hist_a = loop.Trainer(
            cfg, dataclasses.replace(tcfg, checkpoint_dir=None),
            device=DEVICE).run()
        failed = loop.Trainer(cfg, tcfg, device=DEVICE)
        try:
            failed.run(injector=loop.FailureInjector(RESUME_FAIL_AT))
        except RuntimeError as e:
            if "injected node failure" not in str(e):
                raise
        else:
            raise AssertionError("lm train (c): the failure was not injected")
        restored_from = failed.ckpt.latest_step()
        state_b, hist_b = loop.Trainer(cfg, tcfg, device=DEVICE).run(
            restore=True)
        tree_a, tree_b = (loop.checkpoint_tree(s) for s in (state_a, state_b))
        pairs = [(f"params/{n}", t, tree_b["params"][n])
                 for n, t in tree_a["params"].items()]
        pairs += [(f"opt/{k}/{n}", t, tree_b["opt"][k][n])
                  for k in "mv" for n, t in tree_a["opt"][k].items()]
        diff = {name: float((a - b).abs().max()) for name, a, b in pairs}
        bitwise = all(torch.equal(a, b) for _, a, b in pairs)
        cpu_template = {
            "params": {n: torch.empty(t.shape, dtype=t.dtype)
                       for n, t in tree_b["params"].items()},
            "opt": {k: ({n: torch.empty(t.shape, dtype=t.dtype)
                         for n, t in v.items()} if k in "mv" else v)
                    for k, v in tree_b["opt"].items()}}
        on_cpu, _, last = failed.ckpt.restore(cpu_template)
        cross = all(torch.equal(on_cpu["params"][n], t.cpu())
                    for n, t in tree_b["params"].items())
    worst = max(diff, key=diff.get)
    if not bitwise or not cross:
        raise AssertionError(
            f"lm train (c): the resumed run differs from the uninterrupted "
            f"one by {diff[worst]} at {worst}, or the CPU restore differs "
            f"({cross})")
    return dict(steps=RESUME_STEPS, checkpoint_every=RESUME_EVERY,
                fail_at=RESUME_FAIL_AT, restored_from=restored_from,
                last_checkpoint=last, bitwise=bitwise,
                max_abs_diff=diff[worst], worst=worst,
                losses_a=hist_a, losses_b=hist_b, cpu_restore_equal=cross,
                seconds=time.perf_counter() - t0)


def run_lm_train(card: str) -> dict:
    """(a) card against CPU: gemma-2b at full width, 2 layers, and the
    other families reduced; (b) gemma-2b at full width and depth through
    ``launch.train``'s ``Trainer`` (float32 masters, bfloat16
    activations, ``remat="full"``, float32 AdamW state; the launcher's
    batch 8 × 128 tokens, ``q_chunk`` 128): 6 steps, every loss finite;
    step ms split into forward+backward and AdamW, tokens/s, peak memory
    and one profiled step beside ``train_bounds``; then 4 steps on one
    repeated batch at ``AdamWConfig(lr=3e-3, warmup_steps=1,
    total_steps=10)`` from fresh moments, from the trained state and
    from fresh masters, the descent reported; (c) ``train_resume``.
    Fails on any mismatch or non-finite loss."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models import model as MDL
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.steps import build_train_step

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("lm train: the float32 checks need TF32 off")
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated()
    cfg = get_config(TRAIN_ARCH)
    checks = [train_cross_device(
        dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS),
        TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ)]
    for arch in TRAIN_CHECK_ARCHS:
        rcfg = get_reduced(arch)
        checks.append(train_cross_device(
            rcfg, 1 if rcfg.moe is not None else 2, 32))
    torch.cuda.empty_cache()

    tcfg = loop.TrainerConfig(steps=TRAIN_STEPS)   # the launcher's sizes
    trainer = loop.Trainer(cfg, tcfg, device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init_state()
    sync()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, history = trainer.run(state)
    sync()
    run_s = time.perf_counter() - t0
    if not all(np.isfinite(history)):
        raise AssertionError(f"lm train (b): non-finite losses {history}")
    model, opt = state["params"], state["opt"]
    batch = {k: torch.as_tensor(v, device=DEVICE)
             for k, v in trainer.batch(0).items()}
    tokens = tcfg.global_batch * tcfg.seq_len

    def step():
        nonlocal model, opt
        model, opt, _ = trainer.step_fn(model, opt, batch)

    step_ms = cuda_ms(step, TRAIN_REPS)
    params = dict(model.named_parameters())
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(TRAIN_REPS)]
    for e0, e1, e2 in events:
        e0.record()
        loss, _ = MDL.loss_fn(model, batch, q_chunk=tcfg.q_chunk)
        grads = torch.autograd.grad(loss, list(params.values()))
        e1.record()
        _, opt, _ = adamw.apply_updates(trainer.opt_cfg, params,
                                        dict(zip(params, grads)), opt)
        e2.record()
        del loss, grads
    sync()
    fb_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in events) / TRAIN_REPS
    opt_ms = sum(e1.elapsed_time(e2) for _, e1, e2 in events) / TRAIN_REPS
    peak = torch.cuda.max_memory_allocated()
    trace = profile_run(f"lm train step {tcfg.global_batch}x{tcfg.seq_len}",
                        step, card)

    bounds = train_bounds(model, tcfg.global_batch, tcfg.seq_len)

    def same_batch(model) -> list:
        """``TRAIN_DESCENT_STEPS`` steps on ``batch`` from fresh moments
        at test_arch_smoke's optimizer -> the losses."""
        opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
        opt = adamw.init_state(opt_cfg, dict(model.named_parameters()))
        same_step = build_train_step(cfg, opt_cfg, q_chunk=tcfg.q_chunk,
                                     device=DEVICE)
        losses = []
        for _ in range(TRAIN_DESCENT_STEPS):
            model, opt, metrics = same_step(model, opt, batch)
            losses.append(float(metrics["loss"]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"lm train (b): non-finite losses {losses}")
        return losses

    # test_arch_smoke's protocol from the trained state (fit to this
    # batch by the timed steps) and from fresh masters (seed 1)
    del opt, state, params
    from_trained = same_batch(model)
    del model
    torch.cuda.empty_cache()
    descent = same_batch(MDL.init_params(
        cfg, torch.Generator(DEVICE).manual_seed(1), DEVICE))
    out = {"arch": cfg.name, "cross_device": checks,
           "history": history, "descent": descent,
           "descent_from_trained": from_trained,
           "descends": descent[-1] < descent[0],
           "batch": tcfg.global_batch, "seq": tcfg.seq_len,
           "q_chunk": tcfg.q_chunk, "remat": cfg.remat,
           "activation_dtype": cfg.activation_dtype, "init_s": init_s,
           "run_s_per_step": run_s / TRAIN_STEPS, "step_ms": step_ms,
           "fwd_bwd_ms": fb_ms, "opt_ms": opt_ms,
           "tokens_per_s": tokens * 1e3 / step_ms, "peak_bytes": peak,
           "held_before_bytes": held, "trace": trace,
           "launches_per_step": trace["device_events"], **bounds}
    del trainer
    torch.cuda.empty_cache()
    out["resume"] = train_resume(card)
    out["seconds"] = time.perf_counter() - t_phase

    for x in checks:
        log(f"lm train (a) {x['arch']} ({x['layers']} layers, d "
            f"{x['d_model']}), float32, batch {x['batch']} x {x['seq']} "
            f"tokens: loss {x['loss']:.6f}, card equals CPU within "
            f"{x['loss_rel']:.2e} (loss) and {x['worst_rel']:.2e} of max "
            f"|CPU gradient| at {x['worst_param']}, the worst of "
            f"{x['n_params']} parameters (bound 1e-4) ({x['seconds']:.1f} s)"
            f" ({card})")
    log(f"lm train (b) {cfg.name} full width and depth ({out['n']} "
        f"parameters), float32 masters, {cfg.activation_dtype} "
        f"activations, remat {cfg.remat}, float32 AdamW state, batch "
        f"{tcfg.global_batch} x {tcfg.seq_len}: Trainer losses "
        f"{[round(v, 4) for v in history]}, all finite; one batch "
        f"{TRAIN_DESCENT_STEPS} times at lr 3e-3 from fresh masters: "
        f"{[round(v, 4) for v in descent]} "
        f"({'descends' if out['descends'] else 'DOES NOT DESCEND'}); from "
        f"the trained state with fresh moments: "
        f"{[round(v, 4) for v in from_trained]} ({card})")
    log(f"lm train (b) step {step_ms:.3f} ms (CUDA events, mean of "
        f"{TRAIN_REPS} after a warm-up; Trainer.run "
        f"{run_s / TRAIN_STEPS * 1e3:.1f} ms a step on the host clock, its "
        f"first step included): "
        f"forward+backward {fb_ms:.3f} ms (bound "
        f"{out['fwd_bwd_bound_ms']:.3f}: {out['train_ops']:.4g} operations "
        f"at {BF16_TENSOR_OPS_PER_S:.4g}/s), AdamW {opt_ms:.3f} ms (bound "
        f"{out['opt_bound_ms']:.3f}: {out['opt_bytes']:.4g} bytes at "
        f"{HBM_BYTES_PER_S:.4g} B/s); step bound "
        f"{out['step_bound_ms']:.3f} ms; {out['tokens_per_s']:.1f} "
        f"tokens/s; peak memory {peak - held} bytes (less the {held} bytes "
        f"earlier phases held); {trace['device_events']} launches a step, "
        f"device busy {trace['busy_ms']:.2f} ms of {trace['wall_ms']:.2f} "
        f"(idle share {trace['idle_share']:.3f}) ({card})")
    r = out["resume"]
    log(f"lm train (c) reduced {TRAIN_ARCH}, {r['steps']} steps, a "
        f"checkpoint every {r['checkpoint_every']}, failure at step "
        f"{r['fail_at']}, restored from step {r['restored_from']}: final "
        f"parameters and moments "
        f"{'equal bit for bit' if r['bitwise'] else 'DIFFER'} (max |diff| "
        f"{r['max_abs_diff']:.3g} at {r['worst']}); the card's last "
        f"checkpoint (step {r['last_checkpoint']}) restored onto the CPU "
        f"equals the card's state; phase {out['seconds']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 16: data-parallel training with the int8 compressed all-reduce
# (optim.compression, launch.mesh, build_compressed_train_step)
# ---------------------------------------------------------------------------

#: (a): the gloo ranks on the one card, batch, tokens, flash chunk
COMP_RANKS, COMP_BATCH, COMP_SEQ, COMP_Q_CHUNK = 4, 8, 32, 16
#: (a): compressed steps held card against CPU; steps of the
#: reference's convergence protocol (compressed against plain)
COMP_CHECK_STEPS, COMP_TRACK_STEPS = 2, 5
#: Seconds the four ranks may take, start-up included.
COMP_TIMEOUT_S = 300
#: (b): timed steps after a warm-up
COMP_REPS = 3
#: Bytes the compression moves a parameter, counted from
#: ``optim.compression.psum_compressed``: g and err read (4 + 4), err,
#: the int8 q and the int32 payload written (4 + 1 + 4), the payload
#: read by the reduction (4), the float32 mean written (4).  The code
#: reads g and err once more for a leaf's scale (33 bytes moved).
COMP_BYTES_PER_PARAM = 25


def comp_batch() -> dict:
    """The reference's convergence-test batch (``tests/test_distributed.py``):
    8 rows of 32 tokens from ``default_rng(0)``, the labels rolled by one."""
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 512, (COMP_BATCH, COMP_SEQ)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


def comp_opt():
    """The reference's convergence test's optimizer."""
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=20)


def comp_init(cfg) -> dict:
    """Reduced gemma-2b's state before the first step: weights drawn on
    the CPU from seed 0 (the same on every rank), zero moments and
    error."""
    from repro_torch.models import model as MDL

    model = MDL.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = {n: p.detach() for n, p in model.named_parameters()}
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    return {"params": params, "m": zeros, "v": zeros, "err": zeros,
            "step": 0}


def comp_run(cfg, mesh, device: str, state: dict, steps: int) -> tuple:
    """``steps`` compressed steps on ``comp_batch`` on ``device`` from
    ``state`` (``comp_init``'s form) -> (the state after each step, on
    the CPU; the metrics of each step)."""
    from repro_torch.models import model as MDL
    from repro_torch.train.steps import build_compressed_train_step

    model = MDL.Model(cfg, device="meta")
    model.load_state_dict({n: t.to(device, copy=True)
                           for n, t in state["params"].items()},
                          assign=True)
    opt = {k: ({n: t.to(device, copy=True) for n, t in state[k].items()}
               if k != "step" else state[k]) for k in state if k != "params"}
    step = build_compressed_train_step(cfg, comp_opt(), mesh, "data",
                                       q_chunk=COMP_Q_CHUNK, device=device)
    after, metrics = [], []
    for _ in range(steps):
        model, opt, m = step(model, opt, comp_batch())
        after.append({
            "params": {n: p.detach().cpu().clone()
                       for n, p in model.named_parameters()},
            **{k: ({n: t.cpu().clone() for n, t in opt[k].items()}
                   if k != "step" else opt[k]) for k in opt}})
        metrics.append({k: float(v) for k, v in m.items()})
    return after, metrics


def comp_rank(rank: int, tmp: str) -> None:
    """One of phase 16 (a)'s gloo ranks (spawned): a (4, 1) ("data",
    "model") mesh; ``COMP_CHECK_STEPS`` compressed steps on the CPU, and
    each of them on the card from the CPU's state before it; the
    convergence protocol's compressed run on the card (rank 0 also its
    plain run); writes its results under ``tmp``."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as MDL
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_train_step

    torch.set_num_threads(1)
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    cfg = get_reduced(TRAIN_ARCH)
    init = comp_init(cfg)
    out = {}
    with D.file_group(f"{tmp}/gloo", rank, COMP_RANKS, "gloo"):
        mesh = make_host_mesh(device=DEVICE)
        out["mesh"] = [list(mesh.mesh.shape), list(mesh.mesh_dim_names)]
        states, metrics = comp_run(cfg, mesh, "cpu", init, COMP_CHECK_STEPS)
        out["cpu"] = ([x["params"] for x in states], metrics)
        card = [comp_run(cfg, mesh, DEVICE, before, 1)
                for before in [init] + states[:-1]]
        out["card"] = ([x[0][0]["params"] for x in card],
                       [x[1][0] for x in card])
        out["tracked"] = [m["loss"] for m in comp_run(
            cfg, mesh, DEVICE, init, COMP_TRACK_STEPS)[1]]
    if rank == 0:
        model = MDL.Model(cfg, device="meta")
        model.load_state_dict({n: t.to(DEVICE, copy=True)
                               for n, t in init["params"].items()},
                              assign=True)
        opt = adamw.init_state(comp_opt(), dict(model.named_parameters()))
        step = build_train_step(cfg, comp_opt(), q_chunk=COMP_Q_CHUNK,
                                device=DEVICE)
        out["plain"] = []
        for _ in range(COMP_TRACK_STEPS):
            model, opt, m = step(model, opt, comp_batch())
            out["plain"].append(float(m["loss"]))
    torch.save(out, f"{tmp}/rank{rank}.pt")


def comp_card_against_cpu(ranks: list) -> dict:
    """(a) each rank's card steps against its CPU steps, each card step
    from the CPU's state before it (a rounding that flips in one step
    changes an element by up to a learning rate, and the next step's
    gradients with it, so chained runs part), under
    ``tests/test_torch_compression.py``'s tolerances: the loss within
    1e-5, ``grad_norm`` within 1e-4 relative, every parameter element
    within 1e-5 of its leaf's max |CPU| but for elements where a
    rounding in ``quantize`` flipped (fewer than 1e-3 of all); every
    rank's card parameters equal rank 0's bit for bit."""
    flips = []
    for r, rec in enumerate(ranks):
        (p_cpu, m_cpu), (p_card, m_card) = rec["cpu"], rec["card"]
        for s in range(COMP_CHECK_STEPS):
            if (abs(m_card[s]["loss"] - m_cpu[s]["loss"]) >= 1e-5
                    or abs(m_card[s]["grad_norm"] - m_cpu[s]["grad_norm"])
                    > 1e-4 * m_cpu[s]["grad_norm"]):
                raise AssertionError(
                    f"lm compressed (a) rank {r} step {s + 1}: card "
                    f"{m_card[s]} != CPU {m_cpu[s]}")
            off = n = 0
            for name, want in p_cpu[s].items():
                got = p_card[s][name]
                if r and not torch.equal(got, ranks[0]["card"][0][s][name]):
                    raise AssertionError(
                        f"lm compressed (a) rank {r} step {s + 1}: {name} "
                        "differs from rank 0's")
                tol = 1e-5 * max(float(want.abs().max()), 1e-30)
                off += int(((got - want).abs() > tol).sum())
                n += want.numel()
            if off >= 1e-3 * n:
                raise AssertionError(
                    f"lm compressed (a) rank {r} step {s + 1}: {off} of "
                    f"{n} elements off (bound 1e-3 of them)")
            flips.append(off)
    return dict(flipped=flips, elements=n,
                losses_card=[m["loss"] for m in ranks[0]["card"][1]],
                losses_cpu=[m["loss"] for m in ranks[0]["cpu"][1]],
                grad_norm_card=[m["grad_norm"] for m in ranks[0]["card"][1]])


def run_comp_ranks() -> dict:
    """(a) four spawned gloo ranks on the one card, checked."""
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(comp_rank, args=(tmp,), nprocs=COMP_RANKS,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > COMP_TIMEOUT_S:
                    raise TimeoutError(f"compressed gloo ranks still "
                                       f"running after {COMP_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                 for r in range(COMP_RANKS)]
    out = comp_card_against_cpu(ranks)
    comp, plain = ranks[0]["tracked"], ranks[0]["plain"]
    if any(rec["tracked"] != comp for rec in ranks):
        raise AssertionError("lm compressed (a): the ranks' losses differ")
    if not (comp[-1] < 6.3 and abs(plain[-1] - comp[-1]) < 0.35):
        raise AssertionError(
            f"lm compressed (a): compressed {comp} against plain {plain} "
            "(the reference's bounds: < 6.3, within 0.35)")
    out.update(mesh=ranks[0]["mesh"], tracked=comp, plain=plain,
               spawn_s=time.perf_counter() - t0)
    return out


def comp_full_width(card: str) -> dict:
    """(b) gemma-2b at full width and depth as the one rank of an NCCL
    group in this process: a (1, 1) mesh, the launcher's sizes (batch
    8 × 128, ``q_chunk`` 128, float32 masters, AdamW state and error,
    bfloat16 activations, ``remat="full"``, the ``Trainer``'s
    optimizer).  A warm-up and ``COMP_REPS`` timed steps, every loss
    finite; the step split into forward+backward, the compression with
    its all-reduce, and AdamW (CUDA events); peak memory; one profiled
    step."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.core import distributed as D
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.mesh import axis_group, batch_axes, make_host_mesh
    from repro_torch.models import convert
    from repro_torch.models import model as MDL
    from repro_torch.optim import adamw
    from repro_torch.optim.compression import init_error, psum_compressed
    from repro_torch.train.loop import TrainerConfig
    from repro_torch.train.steps import build_compressed_train_step

    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainerConfig(steps=TRAIN_STEPS)   # the launcher's sizes
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                total_steps=tcfg.steps)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in TokenPipeline(
        cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, 0).batch(0).items()}
    tokens = tcfg.global_batch * tcfg.seq_len
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(0)
        with D.file_group(f"{tmp}/nccl", 0, 1, "nccl"):
            mesh = make_host_mesh(device=DEVICE)
            axes = batch_axes(mesh)
            model = MDL.init_params(
                cfg, torch.Generator(DEVICE).manual_seed(0), DEVICE)
            params = dict(model.named_parameters())
            opt = dict(adamw.init_state(opt_cfg, params),
                       err=init_error(params))
            step_fn = build_compressed_train_step(
                cfg, opt_cfg, mesh, axes, q_chunk=tcfg.q_chunk,
                device=DEVICE)
            losses = []

            def step():
                nonlocal model, opt
                model, opt, m = step_fn(model, opt, batch)
                losses.append(m["loss"])

            step_ms = cuda_ms(step, COMP_REPS)
            group = axis_group(mesh, axes)[0]
            names = list(params)
            leaves = convert.reference_leaves(cfg, names)
            events = [[torch.cuda.Event(enable_timing=True)
                       for _ in range(4)] for _ in range(COMP_REPS)]
            for e0, e1, e2, e3 in events:
                e0.record()
                loss, _ = MDL.loss_fn(model, batch, q_chunk=tcfg.q_chunk)
                grads = dict(zip(names, torch.autograd.grad(
                    loss, list(params.values()))))
                e1.record()
                grads, _ = psum_compressed(grads, opt["err"], group, leaves)
                e2.record()
                _, inner, _ = adamw.apply_updates(
                    opt_cfg, params, grads,
                    {k: opt[k] for k in ("m", "v", "step")})
                opt = {**inner, "err": opt["err"]}
                e3.record()
                del loss, grads
            sync()
            peak = torch.cuda.max_memory_allocated()
            trace = profile_run(f"lm compressed step {tcfg.global_batch}x"
                                f"{tcfg.seq_len}", step, card)
            losses = [float(v) for v in losses]
            if not all(np.isfinite(losses)):
                raise AssertionError(f"lm compressed (b): non-finite "
                                     f"losses {losses}")
            bounds = train_bounds(model, tcfg.global_batch, tcfg.seq_len)
            n = bounds["n"]
            del model, opt, params, step_fn
    torch.cuda.empty_cache()

    def mean_ms(a, b):
        return sum(e[a].elapsed_time(e[b]) for e in events) / COMP_REPS

    comp_bytes = COMP_BYTES_PER_PARAM * n
    comp_bound = comp_bytes / HBM_BYTES_PER_S * 1e3
    return dict(
        arch=cfg.name, batch=tcfg.global_batch, seq=tcfg.seq_len,
        losses=losses, step_ms=step_ms, fwd_bwd_ms=mean_ms(0, 1),
        comp_ms=mean_ms(1, 2), opt_ms=mean_ms(2, 3),
        tokens_per_s=tokens * 1e3 / step_ms, peak_bytes=peak,
        held_before_bytes=held, trace=trace,
        launches_per_step=trace["device_events"], leaves=len(leaves),
        wire_bytes_per_rank=4 * n + 4 * len(leaves) + 4 * 2,
        float32_wire_bytes=4 * n, int8_wire_bytes=n,
        comp_bytes=comp_bytes, comp_bound_ms=comp_bound,
        **bounds, step_bound_with_comp_ms=bounds["step_bound_ms"]
        + comp_bound)


def analytic_rows() -> list:
    """``launch.analytic``'s ``step_flops``/``step_hbm_bytes`` on one
    chip beside this script's bounds at the same shapes, counted on
    meta-device models (no device memory): gemma-2b's prefill and
    decode (``lm_bounds``, the served bfloat16 model), its train step
    (``train_bounds``, the float32 masters) and seamless-m4t-large-v2's
    prefill and decode over ``LM_PROMPT`` frames (``encdec_bounds``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import analytic
    from repro_torch.models import model as MDL

    def row(cfg, step, batch, seq, hand_ops, hand_bytes):
        shape = ShapeSpec(step, seq, batch, step)
        fl = analytic.step_flops(cfg, shape)
        return dict(arch=cfg.name, step=step, batch=batch, seq=seq,
                    analytic_flops=fl["flops"], model_flops=fl["model_flops"],
                    analytic_bytes=analytic.step_hbm_bytes(
                        cfg, shape, {"data": 1, "model": 1}),
                    hand_ops=hand_ops, hand_bytes=hand_bytes)

    rows = []
    for arch in (LM_ARCH, ENCDEC_ARCH):
        cfg = get_config(arch)
        served = MDL.Model(cfg, device="meta").to(torch.bfloat16)
        hand = (encdec_bounds(cfg, served, LM_PROMPT) if cfg.is_enc_dec
                else lm_bounds(cfg, served))
        rows.append(row(cfg, "prefill", LM_BATCH, LM_PROMPT,
                        hand["prefill_ops"], None))
        rows.append(row(cfg, "decode", LM_BATCH, LM_PROMPT, None,
                        hand["read_bytes_per_token"]
                        + hand["kv_bytes_per_token"]))
    cfg = get_config(TRAIN_ARCH)
    hand = train_bounds(MDL.Model(cfg, device="meta"), 8, 128)
    rows.append(row(cfg, "train", 8, 128, hand["train_ops"],
                    hand["opt_bytes"]))
    return rows


def run_lm_compressed(card: str, plain: dict | None = None) -> dict:
    """(a) four gloo ranks on the one card (``run_comp_ranks``); (b)
    gemma-2b at full width and depth as one NCCL rank
    (``comp_full_width``), beside phase 15's plain step (``plain``) and
    the bound: ``train_bounds`` plus the compression's bytes at the HBM
    rate; (c) ``analytic_rows``.  Fails on any mismatch or non-finite
    loss."""
    t_phase = time.perf_counter()
    out = {"ranks": run_comp_ranks()}
    out["full"] = comp_full_width(card)
    out["analytic"] = analytic_rows()
    out["seconds"] = time.perf_counter() - t_phase
    a, b = out["ranks"], out["full"]
    log(f"lm compressed (a) reduced {TRAIN_ARCH}, four gloo ranks on one "
        f"card, mesh {a['mesh']}, batch {COMP_BATCH} x {COMP_SEQ}, q_chunk "
        f"{COMP_Q_CHUNK}: {COMP_CHECK_STEPS} compressed steps card against "
        f"CPU (each from the CPU's state before it), losses "
        f"{a['losses_card']} / {a['losses_cpu']}, elements off by a "
        f"flipped rounding {a['flipped']} of {a['elements']} a rank "
        f"and step (bound 1e-3 of them), every rank's parameters equal; "
        f"the reference's convergence protocol on the card: compressed "
        f"{[round(v, 4) for v in a['tracked']]}, plain "
        f"{[round(v, 4) for v in a['plain']]} (bounds < 6.3, within 0.35); "
        f"{a['spawn_s']:.1f} s with start-up ({card})")
    log(f"lm compressed (b) {b['arch']} full width and depth ({b['n']} "
        f"parameters, {b['leaves']} reference leaves), one NCCL rank, batch "
        f"{b['batch']} x {b['seq']}: losses "
        f"{[round(v, 4) for v in b['losses']]}, all finite; step "
        f"{b['step_ms']:.3f} ms (CUDA events, mean of {COMP_REPS} after a "
        f"warm-up): forward+backward {b['fwd_bwd_ms']:.3f} ms (bound "
        f"{b['fwd_bwd_bound_ms']:.3f}), compression with its all-reduce "
        f"{b['comp_ms']:.3f} ms (bound {b['comp_bound_ms']:.3f}: "
        f"{b['comp_bytes']:.4g} bytes at {HBM_BYTES_PER_S:.4g} B/s), AdamW "
        f"{b['opt_ms']:.3f} ms (bound {b['opt_bound_ms']:.3f}); step bound "
        f"{b['step_bound_with_comp_ms']:.3f} ms; {b['tokens_per_s']:.1f} "
        f"tokens/s; peak memory {b['peak_bytes'] - b['held_before_bytes']} "
        f"bytes (less the {b['held_before_bytes']} bytes earlier phases "
        f"held); {b['launches_per_step']} launches a step, device busy "
        f"{b['trace']['busy_ms']:.2f} ms of {b['trace']['wall_ms']:.2f} "
        f"(idle share {b['trace']['idle_share']:.3f}); on the wire a rank "
        f"hands the all-reduce {b['wire_bytes_per_rank']} bytes a step "
        f"(int32 payload, scales, metrics; float32 would be "
        f"{b['float32_wire_bytes']}, int8 {b['int8_wire_bytes']}) ({card})")
    if plain:
        log(f"lm compressed (b) beside phase 15's plain step: step "
            f"{plain['step_ms']:.3f} ms, forward+backward "
            f"{plain['fwd_bwd_ms']:.3f}, AdamW {plain['opt_ms']:.3f}, peak "
            f"{plain['peak_bytes'] - plain['held_before_bytes']} bytes, "
            f"{plain['launches_per_step']} launches a step ({card})")
    def g4(x):
        return "none" if x is None else f"{x:.4g}"

    for r in out["analytic"]:
        log(f"lm compressed (c) {r['arch']} {r['step']} {r['batch']} x "
            f"{r['seq']}: analytic.step_flops {g4(r['analytic_flops'])} "
            f"(6/2·N·D {g4(r['model_flops'])}), this script's operations "
            f"{g4(r['hand_ops'])}; analytic.step_hbm_bytes "
            f"{g4(r['analytic_bytes'])}, this script's bytes "
            f"{g4(r['hand_bytes'])}")
    log(f"lm compressed: phase {out['seconds']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 17: the dry run (launch.dryrun, op_count, roofline, sharding,
# models.partitioning) on fake worlds of 256 and 512 ranks, and its
# one-rank prediction against the card
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("gemma-2b", "train_4k", False), ("gemma-2b", "train_4k", True),
                ("xlstm-350m", "train_4k", False),
                ("deepseek-moe-16b", "decode_32k", False),
                ("geodesic2d", "img_16k", False))
DRYRUN_TIMEOUT_S = 600
#: the one-rank predictions: (arch, global batch, tokens, real steps,
#: layers) — (b) phase 15's launcher sizes (``TrainerConfig``), a first
#: and a warm step, every layer; (c) 5 mLSTM chunks of 128 (a loop folds
#: from 5 trips) and 640 sLSTM tokens at full width, 4 of the 24 layers
#: (two mLSTM, two sLSTM: an eager step under the counter took ~60 s at
#: 24), one step (the next one's loss is NaN: the first-loss check)
PREDICTIONS = (("gemma-2b", 8, 128, 2, None), ("xlstm-350m", 8, 640, 1, 4))
PREDICT_MEMORY_TOL = 0.10
#: the reference's dot FLOPs a device for (a)'s cells, from its CPU dry
#: run (``python -m repro.launch.dryrun --arch gemma-2b --shape train_4k``,
#: jax 0.9.0; PERF.md §6's train_4k sweep), and how far above it (a)'s
#: record may lie (below it down to the model's own FLOPs a rank: XLA
#: runs heads that do not divide "model" twice over, the port splits
#: the queries)
REFERENCE_DOT_FLOPS = {("gemma-2b", "train_4k", "16x16"): 96113080139776.0}
REFERENCE_DOT_FLOPS_TOL = 1.10
#: the CPU dry run's peak bytes a device of that cell before each
#: ``constrain`` pinned its gradient (torch 2.13; PERF.md §6), which the
#: card's record is set beside
CPU_PEAK_BEFORE = {("gemma-2b", "train_4k", "16x16"): 16_525_683_712}
#: (d): the reduction the card's torch must take by two reduce-scatters
REDUCTION_PINNED = ("P P S2", "S1 S1 S2")
#: the CPU sweep's collective bytes a device by kind (torch 2.13; PERF.md
#: §6's train_4k table), which the card's record is set beside
CPU_COLLECTIVES = {("gemma-2b", "train_4k", "2x16x16"): {
    "all-gather": 14_295_367_680, "all-reduce": 26_175_307_856,
    "all-to-all": 452_984_832, "reduce-scatter": 332_840_960}}


def _src_env() -> dict:
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def predict_rank(arch: str, batch: int, seq: int, steps: int,
                 layers: int | None) -> None:
    """(b), (c), each run in a subprocess of its own (a fake world is the
    process's default group): the dry run's traced step of ``arch`` (cut
    to ``layers``, if given) on a one-rank world (its loops folded),
    then the same step for real on the card (every trip run) -> one
    JSON line."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.op_count import OpCounter
    from repro_torch.models import model as MDL
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_train_step

    shape = ShapeSpec("train_4k", seq, batch, "train")
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"), DEVICE)
        t0 = time.perf_counter()
        counter, arg_bytes = dryrun.trace_step(cfg, shape, mesh,
                                               torch.device(DEVICE))
        pred = {"hlo_dot_flops_per_device": counter.dot_flops,
                "bytes_per_device": counter.peak, "arg_bytes": arg_bytes,
                "accum": dryrun.choose_accum(cfg, shape, mesh),
                "trace_s": time.perf_counter() - t0}
    opt_cfg = adamw.AdamWConfig(
        state_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)
    model = MDL.init_params(cfg, torch.Generator(DEVICE).manual_seed(0),
                            DEVICE)
    opt = adamw.init_state(opt_cfg, dict(model.named_parameters()))
    gen = torch.Generator(DEVICE).manual_seed(1)
    data = {k: torch.randint(0, cfg.vocab_size, (batch, seq),
                             generator=gen, device=DEVICE, dtype=torch.int32)
            for k in ("tokens", "labels")}
    step = build_train_step(cfg, opt_cfg, q_chunk=dryrun._q_chunk(shape),
                            accum=pred["accum"], device=DEVICE)
    real = []
    for _ in range(steps):          # the first step, then warm ones
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        counter = OpCounter()
        counter.track(model, opt["m"], opt["v"], data)
        t0 = time.perf_counter()
        with counter:
            model, opt, metrics = step(model, opt, data)
        torch.cuda.synchronize()
        real.append({"dot_flops": counter.dot_flops,
                     "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "held_before": held, "counter_peak": counter.peak,
                     "loss": float(metrics["loss"]),
                     "step_s": time.perf_counter() - t0})
    print("PREDICT" + json.dumps({"predicted": pred, "real": real}),
          flush=True)


def run_dryrun(card: str) -> dict:
    """(a) the dry-run CLI on DRYRUN_CELLS and the roofline over their
    records; (b), (c) ``predict_rank`` of each of PREDICTIONS in a
    subprocess.  Fails on any failed cell, a geodesic cell that launched
    no kernel, a train cell whose gradients' bytes a device differ from
    its masters', a cell of REFERENCE_DOT_FLOPS with more than
    REFERENCE_DOT_FLOPS_TOL times the reference's dot FLOPs (or fewer
    than the model's own a rank), FLOPs that differ or a peak more than
    PREDICT_MEMORY_TOL off, or (d) a REDUCTION_PINNED reduction that
    takes other collectives than two reduce-scatters."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import analytic

    t_phase = time.perf_counter()
    # (b)'s subprocess needs ~53 GB of the card, (c)'s ~6 GB: hand back
    # this process's cached blocks first
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    if not analytic.HBM_CAPACITY <= total < 1.1 * analytic.HBM_CAPACITY:
        raise AssertionError(
            f"dry run: analytic.HBM_CAPACITY {analytic.HBM_CAPACITY:.4g} B "
            f"is not the card's {total} B")
    out_dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun-"))
    env = _src_env()
    procs = {}
    for arch, shape, mp in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out_dir)]
        procs[(arch, shape, mp)] = subprocess.Popen(
            cmd + ["--multi-pod"] * mp, cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    predicts = {args: subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke as cs; "
                               f"cs.predict_rank(*{args!r})"],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for args in PREDICTIONS}
    reduce_proc = subprocess.Popen(
        [sys.executable, "-c", "import json; from repro_torch.launch import "
                               "dryrun; print('REDUCE' + json.dumps(dryrun."
                               f"reduction_collectives(device={DEVICE!r})))"],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    outputs, pred_outputs = {}, {}
    try:
        for key, p in procs.items():
            outputs[key] = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        for key, p in predicts.items():
            pred_outputs[key] = p.communicate(timeout=DRYRUN_TIMEOUT_S)
        reduce_out = reduce_proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        for p in [*procs.values(), *predicts.values(), reduce_proc]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, p in procs.items():
        if p.returncode != 0 or "1/1 cells OK" not in outputs[key][0]:
            raise AssertionError(f"dry run (a) {key}: exit {p.returncode}\n"
                                 f"{outputs[key][0][-3000:]}\n"
                                 f"{outputs[key][1][-3000:]}")
    records = {}
    for path in sorted(out_dir.glob("*.json")):
        r = json.loads(path.read_text())
        records[(r["arch"], r["shape"], r["mesh"])] = r
    geo = records[("geodesic2d", "img_16k", "16x16")]
    if not sum(geo["launches"].values()) > 0:
        raise AssertionError(f"dry run (a): the geodesic cell launched no "
                             f"kernel: {geo['launches']}")
    roof = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", str(out_dir)],
        cwd=ROOT, env=env, text=True, capture_output=True, timeout=120)
    shutil.rmtree(out_dir, ignore_errors=True)
    if roof.returncode != 0:
        raise AssertionError(f"dry run: roofline failed\n{roof.stderr}")
    for (arch, shape, mesh), r in records.items():
        log(f"dry run (a) {arch} x {shape} x {mesh} ({r['chips']} fake "
            f"ranks, {r['device']}): {r['bytes_per_device']} bytes a "
            f"device (fits_80g {r['fits_80g']}), dot FLOPs a device "
            f"{r['hlo_dot_flops_per_device']:.6g}, collective bytes a device "
            f"{r['collective_bytes_per_device']:.6g} "
            f"{ {k: f'{v:.4g}' for k, v in r['collectives'].items()} }, "
            f"dominant {r['dominant']}, trace {r['trace_s']:.1f} s"
            + (f", kernel launches {r['launches']}" if "launches" in r
               else ""))
    # every gradient reduced to its parameter's placements as the
    # backward makes it: their local bytes are the masters'
    unequal = []
    for (arch, shape, mesh), r in records.items():
        if not shape.startswith("train"):
            continue
        grad, master = r["grad_bytes_per_device"], r["master_bytes_per_device"]
        log(f"dry run (a) {arch} x {shape} x {mesh}: gradients {grad} bytes "
            f"a device against the masters' {master} "
            f"({'equal' if grad == master else 'DIFFER'})")
        if grad != master:
            unequal.append((arch, shape, mesh, grad, master))
    if unequal:
        raise AssertionError(f"dry run (a): gradient bytes differ from the "
                             f"masters': {unequal}")
    # the plan against the reference's: no more dot FLOPs than the factor
    # allows, no fewer than the model's own
    for key, ref in REFERENCE_DOT_FLOPS.items():
        r = records[key]
        flops = r["hlo_dot_flops_per_device"]
        least = r["model_flops"] / r["chips"]
        log(f"dry run (a) {' x '.join(key)}: dot FLOPs a device {flops:.6g} "
            f"against the reference's {ref:.6g} ({flops / ref:.4f}x, bound "
            f"{REFERENCE_DOT_FLOPS_TOL}x) and the model's {least:.6g} a rank; "
            f"peak {r['bytes_per_device']} bytes against the CPU's "
            f"{CPU_PEAK_BEFORE[key]} before the gradient pins; torch "
            f"{torch.__version__} ({card})")
        if not least <= flops <= REFERENCE_DOT_FLOPS_TOL * ref:
            raise AssertionError(f"dry run (a) {key}: dot FLOPs {flops:.6g}, "
                                 f"{flops / ref:.4f} times the reference's")
    log("dry run (a) roofline (the H100's constants):\n" + roof.stdout)
    for key, cpu in CPU_COLLECTIVES.items():
        r = records[key]
        log(f"dry run (a) {' x '.join(key)}: collective bytes a device by "
            f"kind {r['collectives']} (total "
            f"{r['collective_bytes_per_device']:.10g}) on the card, torch "
            f"{torch.__version__}, against the CPU sweep's {cpu} (total "
            f"{sum(cpu.values()):.10g}, torch 2.13) ({card})")

    if reduce_proc.returncode != 0:
        raise AssertionError(f"dry run (d): exit {reduce_proc.returncode}\n"
                             f"{reduce_out[0][-3000:]}\n"
                             f"{reduce_out[1][-3000:]}")
    line = [ln for ln in reduce_out[0].splitlines()
            if ln.startswith("REDUCE")]
    reductions = json.loads(line[-1][len("REDUCE"):])
    for case, row in reductions.items():
        log(f"dry run (d) {case} on a fake 2x2x2 world, torch "
            f"{torch.__version__}: " + "; ".join(
                f"{path} {row[path]['counts']} {row[path]['bytes']}"
                for path in ("placed", "one_call", "by_axis")))
    pinned = reductions[" -> ".join(REDUCTION_PINNED)]["placed"]["counts"]
    if pinned != {"reduce-scatter": 2}:
        raise AssertionError(f"dry run (d): {REDUCTION_PINNED} took "
                             f"{pinned}, not two reduce-scatters")

    results, gaps = {}, {}
    for label, args in zip("bc", PREDICTIONS):
        arch, batch, seq, _, layers = args
        p = predicts[args]
        pred_out, pred_err = pred_outputs[args]
        if p.returncode != 0:
            raise AssertionError(f"dry run ({label}): exit {p.returncode}\n"
                                 f"{pred_out[-3000:]}\n{pred_err[-3000:]}")
        line = [ln for ln in pred_out.splitlines()
                if ln.startswith("PREDICT")]
        res = json.loads(line[-1][len("PREDICT"):])
        pred, real = res["predicted"], res["real"]
        flops_ok = all(r["dot_flops"] == pred["hlo_dot_flops_per_device"]
                       for r in real)
        gap = [pred["bytes_per_device"] / r["max_memory_allocated"] - 1
               for r in real]
        log(f"dry run ({label}) {arch} one rank, "
            f"{layers or get_config(arch).n_layers} layers, batch {batch} x "
            f"{seq}, float32 masters and AdamW state, {pred['accum']} "
            f"microbatch(es), remat {get_config(arch).remat}: traced dot "
            f"FLOPs {pred['hlo_dot_flops_per_device']:.10g} against the "
            f"real step's {[r['dot_flops'] for r in real]} "
            f"({'equal' if flops_ok else 'DIFFER'}); predicted peak "
            f"{pred['bytes_per_device']} bytes (arguments "
            f"{pred['arg_bytes']}) against max_memory_allocated "
            f"{[r['max_memory_allocated'] for r in real]} (the first step, "
            f"then warm ones; held before {[r['held_before'] for r in real]}, "
            f"the op "
            f"counter's own peak on the real step "
            f"{[r['counter_peak'] for r in real]}): "
            f"{', '.join(f'{g:+.2%}' for g in gap)} (bound "
            f"{PREDICT_MEMORY_TOL:.0%}); trace {pred['trace_s']:.1f} s, "
            f"real steps {[round(r['step_s'], 2) for r in real]} s; losses "
            f"{[round(r['loss'], 4) for r in real]} ({card})")
        if not flops_ok:
            raise AssertionError(f"dry run ({label}): traced FLOPs differ "
                                 f"from the real step's")
        # the first step's loss only: at full width xlstm-350m's
        # gradients grow ~1e9-fold each 64 tokens through its sLSTM
        # (chaotic under the reference's init) and overflow float32 by
        # 640, so its second step's loss is NaN (PERF.md §6)
        if not math.isfinite(real[0]["loss"]):
            raise AssertionError(f"dry run ({label}): the first step's "
                                 f"loss is {real[0]['loss']}")
        if max(abs(g) for g in gap) > PREDICT_MEMORY_TOL:
            raise AssertionError(f"dry run ({label}): predicted peak off by "
                                 f"{gap}")
        results[arch], gaps[arch] = res, gap
    out = {"records": list(records.values()), "roofline": roof.stdout,
           "predict": results, "memory_gap": gaps, "hbm_total_bytes": total,
           "reductions": reductions,
           "seconds": time.perf_counter() - t_phase}
    log(f"dry run: phase {out['seconds']:.1f} s; the card's memory {total} "
        f"bytes against analytic.HBM_CAPACITY {analytic.HBM_CAPACITY:.4g} "
        f"({card})")
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
    serving, ctx = run_serving(counters, smi)
    continuous = run_continuous(counters, smi, ctx)
    del ctx
    verifier = run_verifier(smi)
    baselines = run_baselines(images, smi)
    distributed = run_distributed(counters, smi)
    lm_serving = run_lm_serving(smi)
    lm_moe = run_lm_moe(smi)
    lm_recurrent = run_lm_recurrent(smi)
    lm_encdec = run_lm_encdec(smi)
    lm_train = run_lm_train(smi)
    lm_compressed = run_lm_compressed(smi, lm_train)
    dryrun = run_dryrun(smi)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "build_s": build_s,
         "checks": checks.count,
         "main_path": [{k: v for k, v in r.items() if k != "run"}
                       for r in rows],
         "traces": traces, "kernels": timing, "serving": serving,
         "continuous": continuous, "verifier": verifier,
         "baselines": baselines, "distributed": distributed,
         "lm_serving": lm_serving, "lm_moe": lm_moe,
         "lm_recurrent": lm_recurrent, "lm_encdec": lm_encdec,
         "lm_train": lm_train, "lm_compressed": lm_compressed,
         "dryrun": dryrun},
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
