"""Multi-pod dry run: trace every (arch × shape × mesh) cell on a fake
world of 256 or 512 ranks and record per-device memory, dot FLOPs and
collective bytes — the port of ``repro/launch/dryrun.py``.  It proves
that the distribution policy fits together without the hardware.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
        --shape train_4k [--multi-pod] [--out results.json] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
        --out dryrun/

``--all`` traces each cell in a subprocess of its own (a process holds
one default group), ``JOBS`` at once, and records a cell that runs past
``CELL_TIMEOUT_S`` as failed.

The reference lowers and compiles each step with 512 placeholder XLA
devices.  Here one process is rank 0 of a world of torch's fake process
group (its collectives return at once and move nothing), made inside
``run_cell``, never at import.  A language-model cell builds the model,
the AdamW state and the inputs under ``FakeTensorMode`` on ``--device``
(fake CUDA tensors on the card, fake CPU tensors with ``--device cpu``;
nothing is allocated), places the parameters as DTensors by
``sharding.param_specs`` on the production mesh, and runs one train,
prefill or decode step under the activation policy
(``models/partitioning.py``).  ``op_count.OpCounter`` records the
rank's dot FLOPs, collectives and peak bytes.  DTensor leaves a
parameter's gradient a pending sum over the batch axes, whole along the
dims the parameter shards over them; the train step reduces each to its
parameter's placements as the backward makes it
(``partitioning.reduce_grads_to_params``), where the reference's dry
run passes its parameter shardings as ``grad_shardings``.  A train
record's ``grad_bytes_per_device`` and ``master_bytes_per_device`` are
the gradients' and the parameters' local bytes on the traced rank when
AdamW starts.

The step's loops are folded, as the reference's ``hlo_parse`` counts a
``lax.scan``'s ``while`` body once and multiplies it by its trip count:
the model code runs the microbatches, the SSD and mLSTM chunks and the
sLSTM tokens through ``partitioning.scan``, and under the counter
(``OpCounter(fold=True)``) a loop of n ≥ 5 trips runs trips 0, 1, 2 and
n − 1, counts trip 2's forward and backward n − 3 times, and stands in
for the trips between with tensors of their sizes.  The record is the
unfolded trace's (dot FLOPs, collectives, peak bytes), which the CPU
tests hold; only ``trace_s`` shrinks (zamba2-7b × train_4k folds 16
microbatches of 81 layers of 32 SSD chunks, xlstm-350m × prefill_32k
32,768 sLSTM tokens).  ``run_cell(..., fold=False)`` runs every trip.

The geodesic cells run ``core.distributed.distributed_reconstruct`` on
a ``RankGrid`` of the reference's row axes × "model" over the fake
group, as the rank that holds block (1, 1) (an interior block, which
exchanges halos on every side, as each device of the reference's SPMD
program does), on a real local block on ``--device``: on the card the
port's default engine launches the geodesic chain kernel.  The received
halos are whatever the buffers held (the fake group writes nothing);
nothing compares their values.  The loop is traced for one and two
chunks and taken to ``GEO_TOTAL_STEPS / fuse_k`` chunks
(``op_count.extrapolate``), as the reference's ``dynamic_trip`` does.

Record keys are the reference's where the meaning carries over
(``hlo_dot_flops_per_device`` is the op counter's dot FLOPs, under the
reference's name so that ``roofline`` reads both alike).  Renamed:
``fits_16g`` -> ``fits_80g`` (``analytic.HBM_CAPACITY``, the H100's);
``lower_s``/``compile_s`` -> one ``trace_s``.  Dropped:
``xla_flops_per_device_raw`` (XLA's cost analysis) and ``alias_bytes``
(donated buffers).  ``bytes_per_device`` is the rank's peak of live
tensor bytes (the step's arguments included), each rounded up to the
CUDA caching allocator's 512-byte blocks.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells_for
from repro_torch.core.backend import resolve_device
from repro_torch.launch import analytic
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.launch.op_count import OpCounter, extrapolate, local_bytes
from repro_torch.models import partitioning as PT
from repro_torch.models.partitioning import axis_sizes

ENC_LEN_CAP = 4096  # bounded encoder memory for enc-dec


class Input(NamedTuple):
    """A model input's global shape and dtype."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Stand-ins (``Input``) for every model input of the cell."""
    b, s = shape.global_batch, shape.seq_len
    adt = getattr(torch, cfg.activation_dtype)
    if shape.step == "decode":
        return {"tokens": Input((b, 1), torch.int32)}
    batch = {}
    if shape.step == "train":
        batch["labels"] = Input((b, s), torch.int32)
    if cfg.frontend == "vision":
        batch["embeds"] = Input((b, s, cfg.d_model), adt)
    else:
        batch["tokens"] = Input((b, s), torch.int32)
    if cfg.is_enc_dec:
        batch["enc_embeds"] = Input((b, min(s, ENC_LEN_CAP), cfg.d_model),
                                    adt)
    return batch


def _q_chunk(shape: ShapeSpec) -> int:
    return min(1024, shape.seq_len)


def choose_accum(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 budget: float = 10e9) -> int:
    """Microbatch count for train cells: smallest power of two whose
    estimated per-chip activation footprint fits the budget.

    Napkin model: saved residual-stream x per layer + flash-attention
    residuals (q,k,v,out) ≈ 4 tensors × tokens/chip × d_model × 2 B."""
    if shape.step != "train":
        return 1
    data_par = 1
    for a, s in axis_sizes(mesh).items():
        if a != "model":
            data_par *= s
    tokens_per_chip = shape.global_batch * shape.seq_len / data_par
    depth = cfg.n_layers + cfg.encoder_layers
    est = tokens_per_chip * cfg.d_model * depth * 2 * 4
    accum = 1
    max_accum = max(1, shape.global_batch // data_par)
    while est / accum > budget and accum < max_accum:
        accum *= 2
    return accum


def effective_shape(cfg: ModelConfig, sizes: dict) -> dict:
    """Logical mesh re-factorization: when the head counts don't divide
    the model axis, attention would replicate across it.  The same
    ranks are re-viewed with TP = the largest power of two dividing both
    head counts, folding the rest into the data axis -> ``{axis: size}``
    (``sizes`` itself where nothing changes)."""
    msize = sizes["model"]
    if not cfg.attends or cfg.block_pattern is not None:
        return sizes
    tp = msize
    while tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        tp //= 2
    if tp == msize or tp < 2:
        return sizes
    out = dict(sizes)
    out["data"] *= msize // tp
    out["model"] = tp
    return out


def effective_mesh(cfg: ModelConfig, mesh):
    """``effective_shape`` as a ``DeviceMesh`` over the same ranks in the
    same order (``mesh`` itself where nothing changes)."""
    from torch.distributed.device_mesh import DeviceMesh

    sizes = axis_sizes(mesh)
    new = effective_shape(cfg, sizes)
    if new == sizes:
        return mesh
    names = mesh.mesh_dim_names
    return DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape([new[n] for n in names]),
                      mesh_dim_names=names)


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """This process as ``rank`` of a ``world``-rank default group of
    torch's fake backend (collectives return at once, nothing moves);
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world: this "
                           "process already has a default group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_axes(dims) -> tuple:
    return ("pod", "data", "model")[-len(dims):]


def _distribute(t, mesh, spec):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, PT.placements_of(spec,
                                                       mesh.mesh_dim_names),
                             src_data_rank=None)


def _place(model: nn.Module, specs: dict, mesh) -> None:
    """Every parameter of ``model`` replaced by its DTensor shard."""
    from torch.distributed.tensor import distribute_module

    def shard(prefix: str, mod: nn.Module, mesh) -> None:
        for leaf, p in list(mod.named_parameters(recurse=False)):
            name = f"{prefix}.{leaf}" if prefix else leaf
            mod.register_parameter(leaf, nn.Parameter(
                _distribute(p.detach(), mesh, specs[name]),
                requires_grad=p.requires_grad))

    distribute_module(model, mesh, shard)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, device,
               observe=None):
    """(step fn, its arguments, the tensors they hold) on ``mesh``;
    called under ``FakeTensorMode``.  A train step calls
    ``observe(params, grads)`` before AdamW's update
    (``build_train_step``).  Decode: bfloat16 weights, the
    reference's ``attn_tp`` rule (attention TP only where the KV heads
    divide the model axis)."""
    from repro_torch.models import decode as DEC
    from repro_torch.models import model as MDL
    from repro_torch.optim import adamw
    from repro_torch.train import steps as STEPS

    decode = shape.step == "decode"
    model = MDL.Model(cfg, device=device,
                      dtype=torch.bfloat16 if decode else None)
    attn_tp = (not decode
               or cfg.n_kv_heads % axis_sizes(mesh)["model"] == 0)
    _place(model, SH.param_specs(cfg, model, mesh, attn_tp=attn_tp), mesh)
    inputs = input_specs(cfg, shape)
    specs = SH.batch_specs({k: v.shape for k, v in inputs.items()}, mesh)
    if decode:
        specs["tokens"] = ()            # replicated, as the reference's
    batch = {k: _distribute(torch.zeros(v.shape, dtype=v.dtype,
                                        device=device), mesh, specs[k])
             for k, v in inputs.items()}
    held = [model] + list(batch.values())

    if shape.step == "train":
        opt_cfg = adamw.AdamWConfig(
            state_dtype="bfloat16" if cfg.param_dtype == "bfloat16" else None)
        opt = adamw.init_state(opt_cfg, dict(model.named_parameters()))
        held += list(opt["m"].values()) + list(opt["v"].values())
        fn = STEPS.build_train_step(
            cfg, opt_cfg, q_chunk=_q_chunk(shape),
            accum=choose_accum(cfg, shape, mesh), device=device,
            observe=observe)
        return fn, (model, opt, batch), held

    if shape.step == "prefill":
        fn = STEPS.build_prefill_step(cfg, q_chunk=_q_chunk(shape))
        return fn, (model, batch), held

    enc_len = min(shape.seq_len, ENC_LEN_CAP) if cfg.is_enc_dec else 0
    cache = DEC.init_cache(cfg, shape.global_batch, shape.seq_len, device,
                           enc_len=enc_len)
    cspecs = SH.cache_specs(cfg, cache, mesh)

    def place(tree, spec):
        if isinstance(tree, dict):
            return {k: place(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [place(v, s) for v, s in zip(tree, spec)]
        return _distribute(tree, mesh, spec) if torch.is_tensor(tree) else tree

    cache = place(cache, cspecs)
    held += [t for e in cache["layers"] + cache.get("shared", [])
             for t in e.values()]
    if "enc_out" in cache:
        held.append(cache["enc_out"])
    fn = STEPS.build_serve_step(cfg)
    return fn, (model, cache, batch["tokens"]), held


@contextlib.contextmanager
def _alltoall_on_any_device():
    """While open, DTensor moves a split from one dim to another by its
    all-to-all op on a CPU mesh too, as it does on the card: for a CPU
    mesh it gathers the whole tensor and keeps its chunk (gloo has no
    all-to-all), which the fake group need not do.  Under the fake mode
    the op runs its shape function; the counter counts it."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    orig = getattr(placement_types, "shard_dim_alltoall", None)
    if orig is None or not hasattr(funcol, "_group_or_group_name"):
        yield                       # a torch that moves splits otherwise
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._group_or_group_name(
            funcol._resolve_group((mesh, mesh_dim)))
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim,
                                                     shard_dim, group)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = orig


def trace_step(cfg: ModelConfig, shape: ShapeSpec, mesh, device, *,
               fold: bool = True, observe=None):
    """(the op counter, the argument bytes) of one step of the cell on
    ``mesh`` (a ``DeviceMesh`` of the process's default group), traced
    under ``FakeTensorMode`` and the activation policy.  A train step
    calls ``observe(params, grads)`` before AdamW's update."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    policy = PT.Policy(mesh, batch_axes(mesh))
    with FakeTensorMode(), implicit_replication(), PT.apply_policy(policy), \
            _alltoall_on_any_device():
        fn, args, held = build_cell(cfg, shape, mesh, device, observe)
        counter = OpCounter(fold=fold)
        counter.track(held)
        arg_bytes = counter.live
        with counter:
            fn(*args)
    return counter, arg_bytes


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
             device=None, mesh_shape=None, shape: ShapeSpec | None = None,
             reduced: bool = False, image=None,
             refactor_mesh: bool = True, fold: bool = True) -> dict:
    """One cell's record.  ``mesh_shape`` (2 or 3 sizes, axes
    ("data", "model") or ("pod", "data", "model")) stands in for the
    production mesh, ``shape`` for the named cell's ``ShapeSpec``,
    ``reduced`` for the full configuration, ``image`` (H, W) for a
    geodesic shape's size; ``device=None`` is the GPU.  ``fold=False``
    runs every trip of the folded loops (``op_count``)."""
    device = resolve_device(device)
    dims = tuple(mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)))
    mesh_name = "x".join(map(str, dims))
    if arch == "geodesic2d":
        return run_geodesic_cell(shape_name, dims, device, image=image)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    shape = shape or SHAPES[shape_name]
    with fake_world(math.prod(dims)):
        mesh = make_host_mesh(dims, _mesh_axes(dims), device)
        if refactor_mesh:
            mesh = effective_mesh(cfg, mesh)
        sizes = axis_sizes(mesh)
        t0 = time.perf_counter()
        handed: dict = {}

        def observe(params, grads):
            handed.update(grad_bytes_per_device=local_bytes(grads.values()),
                          master_bytes_per_device=local_bytes(params.values()))

        counter, arg_bytes = trace_step(cfg, shape, mesh, device, fold=fold,
                                        observe=observe)
        peak = counter.peak
        trace_s = time.perf_counter() - t0
        accum = choose_accum(cfg, shape, mesh)
    hlo = counter.result()
    chips = math.prod(dims)
    terms = analytic.roofline_terms(cfg, shape, sizes, hlo, chips=chips)
    return {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "logical_mesh": "x".join(str(v) for v in sizes.values()),
        "chips": chips,
        "device": device.type,
        "ok": True,
        "trace_s": trace_s,
        "accum": accum,
        "bytes_per_device": peak,
        "arg_bytes": arg_bytes,
        "temp_bytes": peak - arg_bytes,
        "fits_80g": bool(peak < analytic.HBM_CAPACITY),
        "hlo_dot_flops_per_device": hlo["dot_flops"],
        "collective_bytes_per_device": hlo["collective_bytes_total"],
        "collectives": hlo["collective_bytes"],
        "collective_counts": hlo["collective_counts"],
        "top_collectives": hlo["top_collectives"],
        "model_flops": terms.model_flops,
        "analytic_flops": analytic.step_flops(cfg, shape)["flops"],
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        **handed,
    }


# ---------------------------------------------------------------------------
# the paper's own workload on the production mesh
# ---------------------------------------------------------------------------

GEO_SHAPES = {
    "img_16k": (16384, 16384, "uint8"),    # H, W, dtype
    "img_64k_rows": (65536, 8192, "uint8"),
}

GEO_TOTAL_STEPS = 4096  # elementary filters applied (reconstruction scale)

#: the reference's tuned fusion depth: halo redundancy (∝ K) sets the
#: roofline fraction of a compute-bound fused chain
GEO_FUSE_K = 8


def geodesic_terms(h, w, dt, k, chips, mesh_shape):
    """Analytic three-term roofline for the K-fused distributed chain,
    on the H100's constants (``launch.analytic``).

    compute: 5 elementwise ops/px/step on the local shard + halo
             redundancy (2K/H_loc + 2K/W_loc extra rows/cols recomputed
             per chunk);
    memory:  one read+write of the shard per K-chunk (the fusion win);
    collective: 2K halo rows+cols per chunk over every NVLink link (volume
             ∝ steps), plus 4 messages a chunk at ``NVLINK_LATENCY``
             (their count is steps/K — latency amortization).
    """
    b = torch.empty((), dtype=getattr(torch, dt)).element_size()
    rows_par = math.prod(v for a, v in mesh_shape.items() if a != "model")
    cols_par = mesh_shape.get("model", 1)
    h_loc, w_loc = h / rows_par, w / cols_par
    chunks = GEO_TOTAL_STEPS / k
    redundancy = 1.0 + 2 * k / h_loc + 2 * k / w_loc
    ops = 5.0 * h_loc * w_loc * GEO_TOTAL_STEPS * redundancy
    compute_s = ops / analytic.VPU_OPS[b]
    memory_s = chunks * 2 * h_loc * w_loc * b / analytic.HBM_BW
    halo_bytes = chunks * 2 * k * (h_loc + w_loc) * b
    collective_s = (halo_bytes / (analytic.NVLINK_LINKS * analytic.NVLINK_BW)
                    + chunks * 4 * analytic.NVLINK_LATENCY)
    useful = 5.0 * h * w * GEO_TOTAL_STEPS / chips / analytic.VPU_OPS[b]
    return compute_s, memory_s, collective_s, useful


def _geo_trace(grid, marker, mask, fuse_k: int, chunks: int, device):
    """(op counts, peak bytes) of ``chunks`` chunks of the reconstruction
    on this rank's blocks."""
    from repro_torch.core import distributed as D

    fn = D.distributed_reconstruct(grid, op="erode", fuse_k=fuse_k,
                                   max_chunks=chunks, device=device)
    counter = OpCounter()
    counter.track(marker, mask)
    with counter:
        fn(marker, mask)
    if fn.chunks != chunks:
        raise AssertionError(f"the trace ran {fn.chunks} chunks, not "
                             f"{chunks}")
    return counter.result(), counter.peak


def run_geodesic_cell(shape_name: str, dims, device, *,
                      fuse_k: int = GEO_FUSE_K, image=None) -> dict:
    """The distributed reconstruction of ``GEO_SHAPES[shape_name]`` (or an
    ``image`` of (H, W)) over a grid of the row axes × "model"."""
    from repro_torch.core import distributed as D
    from repro_torch.kernels import geodesic_chain

    h, w, dt = GEO_SHAPES[shape_name]
    if image is not None:
        h, w = image
    axes = _mesh_axes(dims)
    sizes = dict(zip(axes, dims))
    rows, cols = math.prod(dims[:-1]), dims[-1]
    if h % rows or w % cols:
        raise ValueError(f"a {h}x{w} image does not split over {rows}x"
                         f"{cols} ranks")
    # the interior block (1, 1), or the last row/column where the grid
    # has no interior
    rank = min(1, rows - 1) * cols + min(1, cols - 1)
    gen = torch.Generator().manual_seed(0)
    block = (h // rows, w // cols)
    mask = torch.randint(0, 256, block, generator=gen, dtype=torch.int32)
    mask = mask.to(getattr(torch, dt)).to(device)
    marker = torch.zeros_like(mask)
    launches = {}
    kernels = [getattr(geodesic_chain, n) for n in (
        "geodesic_chain_step", "geodesic_tile_step",
        "geodesic_compact_step")]
    with fake_world(rows * cols, rank):
        grid = D.RankGrid(rows, cols)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        one, peak = _geo_trace(grid, marker, mask, fuse_k, 1, device)
        two, peak2 = _geo_trace(grid, marker, mask, fuse_k, 2, device)
        trace_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
    hlo = extrapolate(one, two, GEO_TOTAL_STEPS / fuse_k)
    peak = max(peak, peak2)
    chips = math.prod(dims)
    compute_s, memory_s, collective_s, useful = geodesic_terms(
        h, w, dt, fuse_k, chips, sizes)
    bound = max(compute_s, memory_s, collective_s)
    dom = {"compute": compute_s, "memory": memory_s,
           "collective": collective_s}
    return {
        "arch": "geodesic2d", "shape": shape_name,
        "image": [h, w], "mesh": "x".join(map(str, dims)), "chips": chips,
        "device": device.type, "rank": rank, "fuse_k": fuse_k,
        "ok": True, "trace_s": trace_s,
        "bytes_per_device": peak, "fits_80g": bool(
            peak < analytic.HBM_CAPACITY),
        "hlo_dot_flops_per_device": hlo["dot_flops"],
        "collective_bytes_per_device": hlo["collective_bytes_total"],
        "collectives": hlo["collective_bytes"],
        "collective_counts": hlo["collective_counts"],
        "top_collectives": hlo["top_collectives"],
        "launches": launches,
        "model_flops": 5.0 * h * w * GEO_TOTAL_STEPS,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "roofline_frac": useful / bound,
        "dominant": max(dom, key=dom.get),
    }


# ---------------------------------------------------------------------------


#: ``--all``: cells traced at once (one subprocess each) and the seconds
#: after which a cell is stopped and recorded as failed
JOBS = 4
CELL_TIMEOUT_S = 3600


def _record_name(r: dict) -> str:
    return f"{r['arch']}_{r['shape']}_{r['mesh']}.json"


def _run_all(cells, args) -> int:
    """``--all``: each cell in a subprocess of its own (this CLI, one
    cell, one fake world: a process holds one default group), ``JOBS``
    at once; a cell past ``CELL_TIMEOUT_S`` is killed and recorded as
    failed."""
    import subprocess

    keep = ["--out", args.out]
    for flag in ("device", "mesh", "batch", "seq_len", "image"):
        if getattr(args, flag) is not None:
            keep += [f"--{flag.replace('_', '-')}", str(getattr(args, flag))]
    if args.reduced:
        keep.append("--reduced")
    pending, running, ok = list(cells), [], 0
    while pending or running:
        while pending and len(running) < JOBS:
            arch, shp, mp = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shp, *keep]
            running.append(((arch, shp, mp), time.perf_counter(),
                            subprocess.Popen(cmd + ["--multi-pod"] * mp,
                                             stdout=subprocess.PIPE,
                                             stderr=subprocess.DEVNULL,
                                             text=True)))
        time.sleep(1.0)
        for job in list(running):
            (arch, shp, mp), t0, proc = job
            late = time.perf_counter() - t0 > CELL_TIMEOUT_S
            if proc.poll() is None and not late:
                continue
            running.remove(job)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                r = {"arch": arch, "shape": shp,
                     "mesh": args.mesh or ("2x16x16" if mp else "16x16"),
                     "ok": False, "error": f"TimeoutError: the trace ran "
                                           f"past {CELL_TIMEOUT_S} s"}
                with open(os.path.join(args.out, _record_name(r)), "w") as f:
                    json.dump(r, f, indent=1)
                print(f"[FAIL] {arch} × {shp} × {r['mesh']}: {r['error']}",
                      flush=True)
                continue
            out = proc.stdout.read()
            ok += "1/1 cells OK" in out
            print(out.strip().splitlines()[0] if out.strip() else
                  f"[FAIL] {arch} × {shp}: exit {proc.returncode}",
                  flush=True)
    print(f"\n{ok}/{len(cells)} cells OK")
    return 0 if ok == len(cells) else 1


def _dims(text: str | None):
    return tuple(int(v) for v in text.split("x")) if text else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS + ("geodesic2d",))
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help=f"every cell, {JOBS} subprocesses at once; "
                         f"--out names a directory")
    ap.add_argument("--out", default=None,
                    help="a .json file for one cell's record, or a "
                         "directory for one record a cell")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu: where the fake "
                         "tensors and the geodesic blocks live")
    ap.add_argument("--mesh", default=None,
                    help="e.g. 2x2 or 2x2x2: a smaller fake world in place "
                         "of the production mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced configuration")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--image", default=None,
                    help="HxW in place of a geodesic shape's size")
    args = ap.parse_args(argv)

    if args.all:
        if not args.out or args.out.endswith(".json"):
            ap.error("--all writes one record a cell: give --out a "
                     "directory")
        os.makedirs(args.out, exist_ok=True)
        cells = [(arch, shp, mp) for arch in ARCH_IDS
                 for shp in cells_for(get_config(arch))
                 for mp in (False, True)]
        cells += [("geodesic2d", shp, mp) for shp in GEO_SHAPES
                  for mp in (False, True)]
        return _run_all(cells, args)

    arch, shp, mp = args.arch, args.shape, args.multi_pod
    mesh = args.mesh or ("2x16x16" if mp else "16x16")
    tag = f"{arch} × {shp} × {mesh}"
    shape = None
    if arch != "geodesic2d" and (args.batch or args.seq_len):
        base = SHAPES[shp]
        shape = ShapeSpec(shp, args.seq_len or base.seq_len,
                          args.batch or base.global_batch, base.step)
    try:
        r = run_cell(arch, shp, mp, device=args.device,
                     mesh_shape=_dims(args.mesh), shape=shape,
                     reduced=args.reduced, image=_dims(args.image))
        print(f"[OK] {tag}: {r['bytes_per_device'] / 1e9:.2f} GB/dev, "
              f"dominant={r.get('dominant')}, trace "
              f"{r['trace_s']:.1f} s", flush=True)
    except Exception as e:  # noqa: BLE001
        r = {"arch": arch, "shape": shp, "mesh": mesh, "ok": False,
             "error": f"{type(e).__name__}: {e}"[:2000],
             "traceback": traceback.format_exc()[-4000:]}
        print(f"[FAIL] {tag}: {r['error'][:500]}", flush=True)
        print(r["traceback"], file=sys.stderr, flush=True)
    if args.out and args.out.endswith(".json"):
        with open(args.out, "w") as f:        # a list, as the reference's
            json.dump([r], f, indent=1)
    elif args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, _record_name(r)), "w") as f:
            json.dump(r, f, indent=1)
    print(f"\n{int(r['ok'])}/1 cells OK")
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
