"""``repro_torch.launch.{dryrun,op_count,roofline}`` against
``repro.launch.{dryrun,hlo_parse,roofline}``.

The reference's dry-run module sets ``XLA_FLAGS`` to 512 host devices
when it is imported, so its functions run in one subprocess
(``reference``), which also compiles a column- then row-parallel MLP
block on four of those devices for ``hlo_parse.analyze``.  The port's
op counter runs here on a 2×2 mesh of torch's fake process group; the
CLI runs in subprocesses, one fake world each, at reduced sizes with
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
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.launch import roofline as RR
from repro_torch.configs import registry, shapes
from repro_torch.launch import analytic as A
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as R
from repro_torch.launch.op_count import OpCounter, extrapolate

REPO = pathlib.Path(__file__).resolve().parent.parent
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
GEO_K = (1, 8, 64)

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
print("REF" + json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def reference():
    port = {"vpu": A.VPU_OPS, "hbm": A.HBM_BW,
            "bw": A.NVLINK_LINKS * A.NVLINK_BW, "lat": A.NVLINK_LATENCY,
            "ks": GEO_K}
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
