"""``repro_torch.launch.{dryrun,op_count,roofline}`` against
``repro.launch.{dryrun,hlo_parse,roofline}``.

The reference's dry-run module sets ``XLA_FLAGS`` to 512 host devices
when it is imported, so its functions run in one subprocess
(``reference``), which also compiles a column- then row-parallel MLP
block on four of those devices for ``hlo_parse.analyze``, and the train
steps of reduced configurations (``REDUCED``, batch 8 × 64) on small
meshes of them.  The port's op counter runs here on a 2×2 mesh of
torch's fake process group; the CLI and the reduced cells run in
subprocesses (a process holds one fake world at a time) with
``--device cpu``.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import roofline as RR
from repro_torch.configs import registry, shapes
from repro_torch.launch import analytic as A
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R
from repro_torch.launch.op_count import OpCounter, extrapolate
from repro_torch.models import partitioning as PT

REPO = pathlib.Path(__file__).resolve().parent.parent
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GEO_K = (1, 8, 64)
#: reduced train cells (batch 8 × 64) and the port's dot FLOPs a device
#: against the reference's: equal, or within this factor either way
REDUCED = {("gemma-7b", (2, 2)): 1.0, ("qwen2.5-32b", (2, 2)): 1.0,
           ("seamless-m4t-large-v2", (2, 2)): 1.0,
           ("chameleon-34b", (2, 2)): 1.0,
           # 1 KV head on 4: the queries split over "model"
           ("gemma-2b", (2, 4)): 1.10,
           # the split projections' gradients held in their shards
           ("zamba2-7b", (2, 2)): 1.10, ("xlstm-350m", (2, 2)): 1.10}

REFERENCE = """
import json, sys
import numpy as np
import repro.launch.dryrun as DR              # sets the 512 host devices
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.registry import ARCH_IDS, get_config
from repro.configs.shapes import SHAPES, cells_for
from repro.launch import analytic as RA, hlo_parse
from repro.launch.mesh import make_production_mesh

port = json.loads(sys.argv[1])
out = {"inputs": {}, "accum": {}, "mesh": {}, "geo": {}}
meshes = {"16x16": make_production_mesh(multi_pod=False),
          "2x16x16": make_production_mesh(multi_pod=True)}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for name, mesh in meshes.items():
        out["mesh"][f"{arch}|{name}"] = dict(DR.effective_mesh(cfg,
                                                               mesh).shape)
    for cell in cells_for(cfg):
        shape = SHAPES[cell]
        out["inputs"][f"{arch}|{cell}"] = {
            k: [list(v.shape), str(v.dtype)]
            for k, v in DR.input_specs(cfg, shape).items()}
        for name, mesh in meshes.items():
            out["accum"][f"{arch}|{cell}|{name}"] = DR.choose_accum(
                cfg, shape, mesh)
RA.VPU_OPS = {int(k): v for k, v in port["vpu"].items()}
RA.HBM_BW, RA.ICI_BW, RA.ICI_LATENCY = port["hbm"], port["bw"], port["lat"]
for geo, (h, w, dt) in DR.GEO_SHAPES.items():
    for name, mesh in meshes.items():
        for k in port["ks"]:
            chips = int(np.prod(list(mesh.shape.values())))
            out["geo"][f"{geo}|{name}|{k}"] = DR.geodesic_terms(
                h, w, dt, k, chips, dict(mesh.shape))

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
def mlp(x, w1, w2):
    return jax.nn.relu(x @ w1) @ w2
sh = lambda *s: NamedSharding(mesh, P(*s))
f = jax.jit(mlp, in_shardings=(sh("data", None), sh(None, "model"),
                               sh("model", None)),
            out_shardings=sh("data", None))
args = [jax.ShapeDtypeStruct(s, jnp.float32)
        for s in ((8, 16), (16, 64), (64, 16))]
out["mlp"] = hlo_parse.analyze(f.lower(*args).compile().as_text())

from repro.configs.registry import get_reduced
from repro.configs.shapes import ShapeSpec
from repro.launch.mesh import batch_axes
from repro.models import partitioning as PT
out["reduced"] = {}
for arch, dims in port["reduced"]:
    cfg = get_reduced(arch)
    m = DR.effective_mesh(cfg, Mesh(np.array(
        jax.devices()[:int(np.prod(dims))]).reshape(dims), ("data", "model")))
    with PT.apply_policy(PT.Policy(m, batch_axes(m))):
        shape = ShapeSpec("train_4k", 64, 8, "train")
        jfn, args = DR.build_cell(cfg, shape, m)
        text = jfn.lower(*args).compile().as_text()
    out["reduced"][f"{arch}|{dims}"] = hlo_parse.analyze(text)["dot_flops"]
out["cube"] = {}
for arch in port["cube"]:
    cfg = get_reduced(arch)
    m = DR.effective_mesh(cfg, Mesh(np.array(jax.devices()[:8]).reshape(
        2, 2, 2), ("pod", "data", "model")))
    with PT.apply_policy(PT.Policy(m, batch_axes(m))):
        jfn, args = DR.build_cell(cfg, ShapeSpec("train_4k", 64, 8, "train"),
                                  m)
        text = jfn.lower(*args).compile().as_text()
    out["cube"][arch] = hlo_parse.analyze(text)["collective_bytes_total"]
print("REF" + json.dumps(out))
"""

#: the port's side of ``REDUCED``, one process, one fake world a cell;
#: then reduced deepseek-moe-16b on 2×4 (``MOE_CELL``) under a counter
#: that keeps the local shape of every tensor and collective result the
#: MoE's chunk code makes (forward, and backward by the autograd node's
#: forward frame, which anomaly mode records) and of its forward router
#: products
PORT_REDUCED = """
import json, re, sys
import torch
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import trace_profile as TP
SHAPE = ShapeSpec("train_4k", 64, 8, "train")
out = {}
for arch, dims in json.loads(sys.argv[1]):
    r = D.run_cell(arch, "train_4k", device="cpu", mesh_shape=tuple(dims),
                   shape=SHAPE, reduced=True)
    out[f"{arch}|{dims}"] = r["hlo_dot_flops_per_device"]
print("PORT" + json.dumps(out))


class Seen(D.OpCounter):
    last = None

    def __init__(self, fold=False):
        super().__init__(fold=fold)
        Seen.last, self.made, self.router = self, set(), []

    def chunk_frame(self):
        where, recompute = TP._frame_here()
        node = torch._C._current_autograd_node()
        if node is not None and not recompute and (
                where is None or "/models/" not in where):
            where = TP._node_frame(node)
        m = re.search(r"models/moe\\.py:\\d+ (\\w+)", where or "")
        return m.group(1) if m and m.group(1) != "moe_apply" else None

    def _hold(self, t):
        if t.device.type != "meta" and t.untyped_storage() not in \\
                self._storages and self.chunk_frame():
            self.made.add(("tensor", tuple(t.shape)))
        super()._hold(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = super().__torch_dispatch__(func, types, args, kwargs)
        kind = self._kinds.get(func._overloadpacket)
        if kind and isinstance(res, torch.Tensor) and self.chunk_frame():
            self.made.add((kind[0], tuple(res.shape)))
        return res

    def _on_dot(self, packet, args, flops):
        if self.chunk_frame() == "route" and \\
                torch._C._current_autograd_node() is None:
            self.router.append([list(a.shape) for a in args])


arch, dims = json.loads(sys.argv[2])
D.OpCounter = Seen
torch.autograd.set_detect_anomaly(True, check_nan=False)
r = D.run_cell(arch, "train_4k", device="cpu", mesh_shape=tuple(dims),
               shape=SHAPE, reduced=True)
print("MOE" + json.dumps({
    "logical_mesh": r["logical_mesh"], "accum": r["accum"],
    "made": sorted(Seen.last.made), "router": Seen.last.router}))
"""
MOE_CELL = ("deepseek-moe-16b", (2, 4))

#: reduced train cells (batch 8 × 64) on a fake world of 8, a 2×2×2
#: ("pod", "data", "model") mesh: (collective bytes a device at most, dot
#: FLOPs, peak bytes), on a CPU, torch 2.13.  The bound is each cell's
#: figure with only its pending sums over ("pod", "data") reduced one
#: axis at a time; with DTensor's one-call reductions they read 2,972,736
#: and 9,721,024.  With the loss's logsumexp gathering the vocabulary
#: whole, the peaks read 1,999,872 and 4,788,736 B.
CUBE = {"gemma-2b": (2_729_024, 50_872_320, 1_608_704),
        "deepseek-moe-16b": (7_613_632, 200_867_840, 4_397_568)}
#: their collective bytes against the reference's compile of the same
#: cell on 8 host devices (XLA all-reduces what the port reduce-scatters:
#: totals compare, kinds do not)
CUBE_FACTOR = 1.10

#: ``_reduce_placed``'s collectives for the pending sums over
#: ("pod", "data") into a dim split over both
REDUCTION_COUNTS = {"P P S2 -> S1 S1 S2": {"reduce-scatter": 2},
                    "P P S0 -> S1 S1 S0": {"reduce-scatter": 2},
                    "P P S1 -> S1 S1 S1": {"all-gather": 2,
                                           "reduce-scatter": 2}}

#: ``dryrun.reduction_collectives`` and the ``CUBE`` cells, one process
#: (one fake world at a time)
PORT_CUBE = """
import json, sys
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
out = {"reductions": D.reduction_collectives(device="cpu"), "cells": {}}
for arch in json.loads(sys.argv[1]):
    r = D.run_cell(arch, "train_4k", device="cpu", mesh_shape=(2, 2, 2),
                   shape=ShapeSpec("train_4k", 64, 8, "train"), reduced=True)
    out["cells"][arch] = {k: r[k] for k in (
        "collective_bytes_per_device", "hlo_dot_flops_per_device",
        "bytes_per_device", "logical_mesh")}
print("CUBE" + json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module", autouse=True)
def port_subprocesses():
    """The port's reduced cells and ``trace_profile --dots`` of one of
    them, started with the module so that they trace beside the
    reference's compiles."""
    cells = json.dumps([[arch, list(dims)] for arch, dims in REDUCED])
    procs = {
        "reduced": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(PORT_REDUCED), cells,
             json.dumps(MOE_CELL)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "cube": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(PORT_CUBE),
             json.dumps(list(CUBE))], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "dots": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.trace_profile",
             "--arch", "gemma-2b", "--shape", "train_4k", "--reduced",
             "--mesh", "2x2", "--batch", "8", "--seq-len", "64", "--device",
             "cpu", "--dots", "--collectives", "--top", "1000"], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference():
    port = {"vpu": A.VPU_OPS, "hbm": A.HBM_BW,
            "bw": A.NVLINK_LINKS * A.NVLINK_BW, "lat": A.NVLINK_LATENCY,
            "ks": GEO_K, "reduced": [[arch, list(dims)]
                                     for arch, dims in REDUCED],
            "cube": list(CUBE)}
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), json.dumps(port)],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REF")]
    return json.loads(line[-1][3:])


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def test_input_specs_accum_and_mesh_equal_the_reference(reference):
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        for name, sizes in MESHES.items():
            assert D.effective_shape(cfg, sizes) == \
                reference["mesh"][f"{arch}|{name}"], (arch, name)
        for cell in shapes.cells_for(cfg):
            shape = shapes.SHAPES[cell]
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                   for k, v in D.input_specs(cfg, shape).items()}
            assert got == reference["inputs"][f"{arch}|{cell}"], (arch, cell)
            for name, sizes in MESHES.items():
                assert D.choose_accum(cfg, shape, FakeMesh(sizes)) == \
                    reference["accum"][f"{arch}|{cell}|{name}"]


def test_geodesic_terms_equal_the_reference_on_the_h100s_constants(
        reference):
    """The reference's formula on the port's constants (its VPU rate, HBM
    rate, link rate and per-message latency replaced) gives the port's
    terms exactly."""
    assert A.NVLINK_LATENCY > 0
    for geo, (h, w, dt) in D.GEO_SHAPES.items():
        for name, sizes in MESHES.items():
            for k in GEO_K:
                got = D.geodesic_terms(h, w, dt, k, math.prod(sizes.values()),
                                       sizes)
                assert list(got) == pytest.approx(
                    reference["geo"][f"{geo}|{name}|{k}"], rel=1e-12)


@pytest.fixture(scope="module")
def mesh22():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield M.make_host_mesh((2, 2), device="cpu")
    finally:
        dist.destroy_process_group()


def _mlp_block(mesh, counter):
    """Column- then row-parallel MLP on (8, 16) rows split over "data":
    the reference block's shardings."""
    x = distribute_tensor(torch.ones(8, 16), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    w1 = distribute_tensor(torch.ones(16, 64), mesh, [Replicate(), Shard(1)],
                           src_data_rank=None)
    w2 = distribute_tensor(torch.ones(64, 16), mesh, [Replicate(), Shard(0)],
                           src_data_rank=None)
    with counter:
        y = torch.relu(x @ w1) @ w2
        y = y.redistribute(mesh, [Shard(0), Replicate()])
    return y


def test_op_counter_counts_one_ranks_work_exactly(mesh22):
    c = OpCounter()
    y = _mlp_block(mesh22, c)
    assert tuple(y.to_local().shape) == (4, 16)
    # local products: (4, 16) @ (16, 32) and (4, 32) @ (32, 16)
    assert c.dot_flops == 2 * 4 * 16 * 32 + 2 * 4 * 32 * 16
    # the row-parallel product's pending sum over "model": one all-reduce
    # of the (4, 16) float32 result, counted twice (ring factor)
    assert c.bytes == {"all-reduce": 2 * 4 * 16 * 4}
    assert c.counts == {"all-reduce": 1}
    # plain torch.distributed calls: a gather, a reduce and a halo swap
    c = OpCounter()
    with c:
        t = torch.ones(3, 5)
        dist.all_reduce(t)
        parts = [torch.empty(3, 5) for _ in range(4)]
        dist.all_gather(parts, t)
        out = torch.empty(2, 7, dtype=torch.uint8)
        ops = [dist.P2POp(dist.isend, torch.ones(2, 7, dtype=torch.uint8), 1),
               dist.P2POp(dist.irecv, out, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        a = torch.ones(3, 4)
        b = torch.ones(2, 4, 6)
        a @ torch.ones(4, 2)
        torch.bmm(b.transpose(1, 2), torch.ones(2, 4, 5))
        torch.addmm(torch.ones(3, 2), a, torch.ones(4, 2))
        a * a                                     # elementwise: not counted
    assert c.bytes == {"all-reduce": 2 * 60, "all-gather": 4 * 60,
                       "collective-permute": 14}
    assert c.counts == {"all-reduce": 1, "all-gather": 1,
                        "collective-permute": 1}
    assert c.dot_flops == 2 * 3 * 4 * 2 + 2 * 2 * 6 * 4 * 5 + 2 * 3 * 4 * 2
    r = c.result()
    assert r["collective_bytes_total"] == 2 * 60 + 4 * 60 + 14
    assert set(r) >= {"dot_flops", "collective_bytes", "collective_counts",
                      "collective_bytes_total", "top_collectives"}


def test_op_counter_tracks_live_and_peak_bytes():
    c = OpCounter()
    keep = torch.ones(1000)                        # 4000 B -> 4096
    c.track(keep)
    assert c.live == c.peak == 4096
    with c:
        t = torch.empty(10)                        # 40 B -> 512
        u = t + 1
        del t, u
        v = torch.empty(600, dtype=torch.uint8)    # 600 B -> 1024
    assert c.peak == 4096 + 1024                  # t and u, then v
    assert c.live == 4096 + 1024
    del v


def test_extrapolate_takes_one_trip_to_many():
    one = {"dot_flops": 10.0, "collective_bytes": {"all-reduce": 8.0},
           "collective_counts": {"all-reduce": 1.0},
           "sites": {"all-reduce|int32[1]": [1, 8.0]}}
    two = {"dot_flops": 16.0, "collective_bytes": {"all-reduce": 16.0},
           "collective_counts": {"all-reduce": 2.0},
           "sites": {"all-reduce|int32[1]": [2, 16.0]}}
    r = extrapolate(one, two, 512)
    assert r["dot_flops"] == 4 + 512 * 6
    assert r["collective_bytes"] == {"all-reduce": 512 * 8.0}
    assert r["collective_counts"] == {"all-reduce": 512.0}


def test_mlp_block_matches_hlo_parse(reference, mesh22):
    """The same block's per-device dot FLOPs as ``hlo_parse.analyze`` of
    the reference's compile on four devices; both reduce the row-parallel
    product's partial sums with one all-reduce of the (4, 16) result."""
    c = OpCounter()
    _mlp_block(mesh22, c)
    ref = reference["mlp"]
    assert c.dot_flops == ref["dot_flops"]
    assert dict(c.bytes) == ref["collective_bytes"]
    assert dict(c.counts) == ref["collective_counts"]


def _finished(procs, name: str) -> str:
    stdout, stderr = procs[name].communicate(timeout=300)
    assert procs[name].returncode == 0, stderr[-3000:]
    return stdout


@pytest.fixture(scope="module")
def reduced_counts(reference, port_subprocesses):
    stdout = _finished(port_subprocesses, "reduced")
    line = [ln for ln in stdout.splitlines() if ln.startswith("PORT")]
    return json.loads(line[-1][4:]), reference["reduced"]


@pytest.mark.parametrize("arch,dims", list(REDUCED))
def test_reduced_cells_count_the_references_dot_flops(reduced_counts, arch,
                                                      dims):
    """A reduced train step's dot FLOPs a device against
    ``hlo_parse.analyze`` of the reference's compile of the same
    configuration, shape and mesh: equal where ``REDUCED`` says 1.0,
    else within its factor either way.  Before each ``constrain`` pinned
    its gradient, gemma-7b, qwen2.5-32b and seamless-m4t-large-v2 read
    1.113, 1.075 and 1.075 times the reference's, gemma-2b on 2×4 1.683
    times; before ``hold`` kept the split projections' gradients in
    their shards, zamba2-7b and xlstm-350m 1.080 and 1.113 times."""
    port, ref = reduced_counts
    key = f"{arch}|{list(dims)}"
    factor = REDUCED[(arch, dims)]
    if factor == 1.0:
        assert port[key] == ref[key]
    else:
        assert 1 / factor <= port[key] / ref[key] <= factor, \
            port[key] / ref[key]


def test_trace_profile_dots_sum_to_the_records_dot_flops(port_subprocesses):
    """``trace_profile --dots``: every product's weighted FLOPs, by
    phase, op, local shapes and model-code frame, sum to the record's
    ``hlo_dot_flops_per_device`` (reduced gemma-2b × train_4k on 2×2);
    the attention's, the FFN's and the loss's products are told by their
    frames, forward, backward and the loss chunks' recompute apart."""
    out = json.loads(_finished(port_subprocesses, "dots").splitlines()[-1])
    rows = out["dots"]
    assert out["dots_total"] == out["hlo_dot_flops_per_device"] > 0
    assert sum(r[0] for r in rows) == out["dots_total"]
    assert {r[2] for r in rows} == {"forward", "backward", "recompute"}
    frames = " ".join(r[5] for r in rows)
    for where in ("attention.py", "layers.py", "_flash_bwd", "_chunk_nll",
                  "(MmBackward0)"):
        assert where in frames, where
    assert "?" not in {r[5] for r in rows}


def test_trace_profile_collectives_sum_to_the_records_bytes(
        port_subprocesses):
    """``trace_profile --collectives``: every collective's weighted
    bytes, by phase, kind, result, model-code frame and the sharding
    layer's frame that issued it, sum to the record's
    ``collective_bytes_per_device`` and, by kind, to its
    ``collectives``; the gradients' reductions are told by
    ``_reduce_placed``'s frame."""
    out = json.loads(_finished(port_subprocesses, "dots").splitlines()[-1])
    rows = out["collectives_by_site"]
    assert out["collectives_total"] == out["collective_bytes_per_device"] > 0
    assert sum(r[0] for r in rows) == out["collectives_total"]
    by_kind: dict = {}
    for r in rows:
        by_kind[r[3]] = by_kind.get(r[3], 0) + r[0]
    assert by_kind == pytest.approx(out["collectives"], rel=1e-12)
    assert {r[2] for r in rows} <= {"forward", "backward", "recompute"}
    assert any("partitioning.py" in r[6] and "_reduce_placed" in r[6]
               for r in rows if r[2] == "backward")


@pytest.fixture(scope="module")
def moe_trace(port_subprocesses):
    stdout = _finished(port_subprocesses, "reduced")
    line = [ln for ln in stdout.splitlines() if ln.startswith("MOE")]
    return json.loads(line[-1][3:])


def test_the_sharded_moe_routes_and_combines_each_ranks_own_rows(moe_trace):
    """Reduced deepseek-moe-16b × train_4k (8 × 64 tokens) on a 2×4 fake
    world: each forward router product is the rank's own rows of a chunk
    by the whole d_model (2·B_loc·S·D·E FLOPs a layer and microbatch, a
    chunk at a time), and no tensor or collective result that the MoE's
    chunk code makes, forward or backward, holds the chunk's B·Cs·K
    assignment rows or every expert's slots, of the microbatch's rows or
    of the rank's (the replicated plan made both: the (B, Cs, K, D)
    expanded input, the (E·B·C + 1, D) dispatch buffer and the gathered
    (E, B·C, D) expert outputs)."""
    from repro_torch.models import moe as MOE

    cfg = registry.get_reduced(MOE_CELL[0])
    e, k, d = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    seq, batch = 64, 8
    data, model = map(int, moe_trace["logical_mesh"].split("x"))
    assert (data, model) == MOE_CELL[1]
    rows = batch // moe_trace["accum"]            # a microbatch's B
    own = rows // data                            # B_loc
    cs = min(cfg.moe.router_chunk, seq)
    cap = MOE._capacity(cs * k / e, cfg.moe.capacity_factor)
    chunks = cfg.n_layers * moe_trace["accum"] * seq // cs
    assert moe_trace["router"] == [[[own * cs, d], [d, e]]] * chunks
    assert sum(2 * a[0] * a[1] * b[1] for a, b in moe_trace["router"]) == \
        cfg.n_layers * moe_trace["accum"] * 2 * own * seq * d * e
    # (rows, D) for rows of: the chunk's assignments, every expert's
    # slots (with the dispatch's spare row) of the microbatch or the rank
    whole = {rows * cs * k, e * rows * cap, e * rows * cap + 1,
             e * own * cap, e * own * cap + 1}
    kinds = {kind for kind, _ in moe_trace["made"]}
    assert "tensor" in kinds and "all-gather" in kinds
    for kind, shape in moe_trace["made"]:
        if shape and shape[-1] == d:
            assert math.prod(shape[:-1]) not in whole, (kind, shape)


@pytest.fixture(scope="module")
def cube(port_subprocesses):
    stdout = _finished(port_subprocesses, "cube")
    line = [ln for ln in stdout.splitlines() if ln.startswith("CUBE")]
    return json.loads(line[-1][4:])


@pytest.mark.parametrize("have,want", D.REDUCTIONS)
def test_a_pending_sum_is_reduced_one_mesh_axis_at_a_time(cube, have, want):
    """``partitioning._reduce_placed`` on a 2×2×2 fake world: no
    all-reduce unless ``want`` replicates a mesh dim whose sum is
    pending, and no more collective bytes than one redistribution a mesh
    dim in mesh order.  A pending sum over ("pod", "data") into a dim
    split over both takes two reduce-scatters, where DTensor's one call
    all-reduces the whole tensor over one axis first (32,768 B and a
    reduce-scatter of 8,192 against 12,288).  Into a dim split over all
    three axes that "model" already splits, each step gathers and splits
    again (73,728 B against 114,688 in one call); no model's reduction
    takes that case."""
    row = cube["reductions"][f"{have} -> {want}"]
    placed = row["placed"]
    pending = any(h == "P" and w == "R"
                  for h, w in zip(have.split(), want.split()))
    assert pending or "all-reduce" not in placed["counts"], placed
    assert sum(placed["bytes"].values()) <= \
        sum(row["by_axis"]["bytes"].values()), row
    if f"{have} -> {want}" in REDUCTION_COUNTS:
        assert placed["counts"] == REDUCTION_COUNTS[f"{have} -> {want}"]


@pytest.mark.parametrize("arch", list(CUBE))
def test_reduced_cells_on_a_2x2x2_world(cube, reference, arch):
    """Reduced gemma-2b and deepseek-moe-16b × train_4k (8 × 64) on a
    fake world of 8, a 2×2×2 mesh: collective bytes a device at most
    ``CUBE``'s, dot FLOPs and peak bytes exactly its, and collective
    bytes within ``CUBE_FACTOR`` of the reference's compile of the same
    cell."""
    r = cube["cells"][arch]
    most, flops, peak = CUBE[arch]
    assert r["logical_mesh"] == "2x2x2"
    assert r["collective_bytes_per_device"] <= most
    assert r["hlo_dot_flops_per_device"] == flops
    assert r["bytes_per_device"] == peak
    ratio = r["collective_bytes_per_device"] / reference["cube"][arch]
    assert 1 / CUBE_FACTOR <= ratio <= CUBE_FACTOR, ratio


class _HandBack(torch.autograd.Function):
    """Identity whose backward hands its gradient on placed as
    ``placements``: a consumer whose gradient arrives placed otherwise
    than the constraint in front of it."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # made here, not moved: a pending sum is each rank's own values
        plain = [Replicate() if p.is_partial() else p for p in ctx.placements]
        local = distribute_tensor(torch.ones(g.shape), g.device_mesh, plain,
                                  src_data_rank=None).to_local()
        return DTensor.from_local(local, g.device_mesh, ctx.placements,
                                  run_check=False), None


def _pinned_grad(mesh, dims, free, handed, before=(Shard(0), Replicate())):
    """The gradient that ``constrain(x, dims, free)`` hands ``x`` (placed
    ``before``) when its consumer hands back ``handed``."""
    x = distribute_tensor(torch.ones(8, 16), mesh, list(before),
                          src_data_rank=None).requires_grad_()
    with PT.apply_policy(PT.Policy(mesh, ("data",))):
        y = _HandBack.apply(PT.constrain(x, dims, free), list(handed))
        y.to_local().sum().backward()
    return x.grad


def test_constrain_places_the_gradient_at_its_spec(mesh22):
    """``constrain``'s backward leaves the gradient on the spec's
    placements, as ``with_sharding_constraint``'s transpose constrains
    the cotangent, wherever its consumer hands it back: replicated, or
    a pending sum reduce-scattered; a ``free`` dim keeps the placement
    the gradient arrives with."""
    # the input is split over "data" only; the spec splits both dims
    g = _pinned_grad(mesh22, ("batch", "model"), False,
                     (Replicate(), Replicate()))
    assert tuple(g.placements) == (Shard(0), Shard(1))
    c = OpCounter()
    with c:
        g = _pinned_grad(mesh22, ("batch", "model"), False,
                         (Shard(0), Partial()))
    assert tuple(g.placements) == (Shard(0), Shard(1))
    assert dict(c.counts) == {"reduce-scatter": 1}
    # a replicated spec: the consumer's split and pending sum undone
    g = _pinned_grad(mesh22, (None, None), False, (Shard(1), Partial()))
    assert tuple(g.placements) == (Replicate(), Replicate())
    # free: dim 1's split over "model" kept, the batch pinned
    g = _pinned_grad(mesh22, ("batch", None), True, (Replicate(), Shard(1)))
    assert tuple(g.placements) == (Shard(0), Shard(1))
    # without a policy, or on a plain tensor, nothing is constrained
    t = torch.ones(4, 4, requires_grad=True)
    with PT.apply_policy(PT.Policy(mesh22, ("data",))):
        assert PT.constrain(t, ("batch", "model")) is t
    x = distribute_tensor(torch.ones(8, 16), mesh22, [Shard(0), Replicate()],
                          src_data_rank=None)
    assert PT.constrain(x, ("batch", "model")) is x


def _cli(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
         "cpu", *args], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def test_cli_cells_and_roofline_on_a_small_fake_world(tmp_path):
    out = tmp_path / "dry"
    procs = [
        _cli("--arch", "gemma-2b", "--shape", "train_4k", "--reduced",
             "--mesh", "2x2", "--batch", "8", "--seq-len", "64", "--out",
             str(out)),
        _cli("--arch", "deepseek-moe-16b", "--shape", "decode_32k",
             "--reduced", "--mesh", "2x2", "--batch", "4", "--seq-len", "64",
             "--out", str(out)),
        _cli("--arch", "geodesic2d", "--shape", "img_16k", "--mesh",
             "2x4x4", "--image", "256x256", "--out", str(out)),
    ] + [  # the per-shard scans and the cross block, reduced
        _cli("--arch", arch, "--shape", shape, "--reduced", "--mesh", "2x2",
             "--batch", "4", "--seq-len", "32", "--out", str(out / arch))
        for arch, shape in (("zamba2-7b", "train_4k"),
                            ("xlstm-350m", "train_4k"),
                            ("seamless-m4t-large-v2", "prefill_32k"))]
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stdout + stderr[-3000:]
        assert "1/1 cells OK" in stdout
    rows = {(r["arch"], r["mesh"]): r for r in R.load(str(out))}
    assert len(rows) == 3
    for arch in ("zamba2-7b", "xlstm-350m", "seamless-m4t-large-v2"):
        (r,) = R.load(str(out / arch))
        assert r["ok"] and r["hlo_dot_flops_per_device"] > 0, arch
    train = rows[("gemma-2b", "2x2")]
    assert train["ok"] and train["chips"] == 4 and train["accum"] == 1
    assert train["hlo_dot_flops_per_device"] > 0
    assert 0 < train["arg_bytes"] < train["bytes_per_device"]
    assert train["fits_80g"]
    decode = rows[("deepseek-moe-16b", "2x2")]
    assert decode["ok"] and decode["hlo_dot_flops_per_device"] > 0
    geo = rows[("geodesic2d", "2x4x4")]
    # block (1, 1) of an 8×4 grid of 32×64 blocks: a K-deep halo from
    # each side, rows then row-extended columns, 4096/8 chunks
    k, bh, bw, chunks = 8, 32, 64, 4096 // 8
    assert geo["rank"] == 5 and geo["fuse_k"] == k
    assert geo["collective_counts"] == {"collective-permute": 4 * chunks + 4,
                                        "all-reduce": chunks}
    halo = 2 * k * bw + 2 * k * (bh + 2 * k)
    assert geo["collectives"] == {"collective-permute": halo * (chunks + 1),
                                  "all-reduce": 2 * 4 * chunks}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", str(out)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "| gemma-2b | train_4k | 2x2 |" in proc.stdout


def test_all_runs_a_subprocess_a_cell_and_records_a_late_one(tmp_path,
                                                            monkeypatch):
    """``--all``: every cell in a CLI subprocess of its own, a record
    each; a cell past ``CELL_TIMEOUT_S`` is killed and recorded as
    failed; the records need a directory."""
    for key, value in _env().items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(D, "ARCH_IDS", ())
    monkeypatch.setattr(D, "GEO_SHAPES", {"img_16k": D.GEO_SHAPES["img_16k"]})
    argv = ["--all", "--device", "cpu", "--mesh", "2x4x4", "--image",
            "256x256", "--out"]
    assert D.main(argv + [str(tmp_path / "ok")]) == 0
    (r,) = R.load(str(tmp_path / "ok"))
    assert r["ok"] and r["mesh"] == "2x4x4" and r["image"] == [256, 256]
    monkeypatch.setattr(D, "CELL_TIMEOUT_S", 0)
    assert D.main(argv + [str(tmp_path / "late")]) == 1
    (r,) = R.load(str(tmp_path / "late"))
    assert not r["ok"] and r["error"].startswith("TimeoutError")
    with pytest.raises(SystemExit):
        D.main(argv + [str(tmp_path / "cells.json")])


def test_roofline_equals_the_reference_up_to_the_constants(monkeypatch):
    rows = [
        {"arch": "gemma-2b", "shape": "train_4k", "mesh": "16x16",
         "chips": 256, "ok": True, "bytes_per_device": 9.5e10,
         "hlo_dot_flops_per_device": 6.2e14, "model_flops": 1.5e16,
         "compute_s": 0.06, "memory_s": 0.001, "collective_s": 0.7},
        {"arch": "deepseek-moe-16b", "shape": "decode_32k", "mesh": "16x16",
         "chips": 256, "ok": True, "bytes_per_device": 3e9,
         "hlo_dot_flops_per_device": 0.0, "model_flops": 1e12,
         "compute_s": 0.002, "memory_s": 0.01, "collective_s": 0.001},
        {"arch": "geodesic2d", "shape": "img_16k", "mesh": "2x16x16",
         "chips": 512, "ok": True, "bytes_per_device": 5e6,
         "compute_s": 0.03, "memory_s": 0.002, "collective_s": 0.004,
         "dominant": "compute"},
        {"arch": "gemma-2b", "shape": "prefill_32k", "mesh": "16x16",
         "ok": False, "error": "RuntimeError: no rule"},
    ]
    for r, fits in zip(rows, (False, True, True, None)):
        if fits is not None:
            r["fits_80g"] = r["fits_16g"] = fits
    monkeypatch.setattr(RR, "PEAK_FLOPS", A.PEAK_FLOPS)
    ours = [R.enrich(dict(r)) for r in rows]
    theirs = [RR.enrich(dict(r)) for r in rows]
    assert ours == theirs
    assert R.table(ours) == RR.table(theirs)
    assert R.table(ours, "16x16") == RR.table(theirs, "16x16")
    assert R.hillclimb_candidates(ours) == RR.hillclimb_candidates(theirs)
