"""Folded loops in the dry run's op counter (``launch.op_count``) against
the same step with every trip traced.

``models.partitioning.scan`` runs the microbatches, the SSD and mLSTM
chunks and the sLSTM tokens.  Under ``OpCounter(fold=True)`` a loop of
n ≥ 5 trips runs trips 0, 1, 2 and n − 1 and counts trip 2 n − 3
times; its dot FLOPs, collectives by kind and peak bytes must equal the
unfolded trace's.  Here the reduced xlstm-350m and zamba2-7b, one
group of layers deep, train with ``accum=5`` and ``remat`` over 5
tokens in chunks of 1 (5 trips of each loop, the inner ones nested in
the microbatches and rerun by the recompute), on plain fake tensors and
on a 2×2 mesh of torch's fake process group (one process standing for
four ranks, as in ``tests/test_torch_dryrun.py``).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.op_count import OpCounter
from repro_torch.models import model as MDL
from repro_torch.models import partitioning as PT
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.optim import adamw
from repro_torch.train import steps as STEPS

REPO = pathlib.Path(__file__).resolve().parent.parent
BATCH, SEQ, CHUNK, ACCUM = 10, 5, 1, 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def head_split():
    """The 2×8 cell of ``test_the_uneven_mlstm_head_split_traces``,
    started with the module so that it runs beside the other tests."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "train_4k", "--reduced", "--mesh", "2x8",
         "--batch", "16", "--seq-len", "64", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture
def small_chunks(monkeypatch):
    """The SSD and mLSTM scans in chunks of ``CHUNK`` tokens."""
    monkeypatch.setitem(SSM.mamba2_apply.__kwdefaults__, "chunk", CHUNK)
    monkeypatch.setitem(XL.mlstm_apply.__kwdefaults__, "chunk", CHUNK)


def _cfg(arch: str, remat: str):
    """One group of layers, recomputed as ``remat`` says: xlstm's mLSTM
    and sLSTM, or a Mamba2 layer and zamba2's shared block."""
    cfg = registry.get_reduced(arch)
    if cfg.shared_attn_period:
        cfg = dataclasses.replace(cfg, n_layers=1, shared_attn_period=1)
    return dataclasses.replace(cfg, n_layers=2 if cfg.n_layers > 1 else 1,
                               remat=remat)


def test_scan_runs_every_trip_without_a_folder():
    seen = []

    def body(i, carry):
        seen.append((i, carry))
        return (carry or 0) + i, i * i

    assert PT.scan(body, 5) == (10, [0, 1, 4, 9, 16])
    assert seen == [(0, None), (1, 0), (2, 1), (3, 3), (4, 6)]
    # a counter that does not fold leaves every trip to run
    seen.clear()
    with FakeTensorMode(), OpCounter():
        PT.scan(body, 5)
    assert [i for i, _ in seen] == [0, 1, 2, 3, 4]


def test_a_folded_loop_runs_three_trips_and_counts_the_rest():
    """A recurrence h = tanh(x_i W + h W) over 6 steps: trips 0, 1, 2
    and 5 run; the FLOPs (forward and backward) and the peak equal the
    unfolded trace's, with and without autograd."""
    def trace(fold: bool, grad: bool):
        trips = []
        with FakeTensorMode():
            w = torch.zeros(16, 16, requires_grad=True)
            x = torch.zeros(4, 6, 16)
            c = OpCounter(fold=fold)
            c.track(w, x)
            with c, torch.set_grad_enabled(grad):
                def body(i, h):
                    trips.append(i)
                    h = torch.zeros(4, 16) if h is None else h
                    h = torch.tanh(x[:, i] @ w + h @ w)
                    return h, h

                h, hs = PT.scan(body, 6)
                assert len(hs) == 6
                assert all(t.shape == (4, 16) for t in hs)
                y = torch.stack(hs, 1).sum()
                if grad:
                    torch.autograd.grad(y, [w])
        return trips, c.dot_flops, c.peak

    for grad in (False, True):
        trips, flops, peak = trace(False, grad)
        folded_trips, folded_flops, folded_peak = trace(True, grad)
        assert trips == [0, 1, 2, 3, 4, 5]
        assert folded_trips == [0, 1, 2, 5]
        assert (folded_flops, folded_peak) == (flops, peak)
    # 2 products a trip forward; backward, W's gradient of each and h's
    # of h W from trip 1 on (trip 0's h is a constant)
    assert flops == (6 * 2 + 6 * 2 + 5) * 2 * 4 * 16 * 16


def _train_step(cfg, fold: bool) -> dict:
    """One train step of ``cfg`` at ``ACCUM`` microbatches on plain fake
    tensors: the counter's totals."""
    with FakeTensorMode():
        model = MDL.Model(cfg, device="cpu")
        batch = {k: torch.zeros((BATCH, SEQ), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        opt_cfg = adamw.AdamWConfig()
        opt = adamw.init_state(opt_cfg, dict(model.named_parameters()))
        step = STEPS.build_train_step(cfg, opt_cfg, q_chunk=8, accum=ACCUM,
                                      device="cpu")
        counter = OpCounter(fold=fold)
        counter.track(model, opt["m"], opt["v"], batch)
        with counter:
            step(model, opt, batch)
    return {"dot_flops": counter.dot_flops, "peak": counter.peak}


def _cell(cfg, step: str, mesh, fold: bool) -> dict:
    counter, args = D.trace_step(cfg, ShapeSpec("cell", SEQ, BATCH, step),
                                 mesh, torch.device("cpu"), fold=fold)
    r = counter.result()
    return {"dot_flops": r["dot_flops"], "bytes": r["collective_bytes"],
            "counts": r["collective_counts"], "peak": counter.peak,
            "args": args}


def train_pair(arch: str, kind: str) -> list:
    """(folded, unfolded) totals of ``arch``'s train step with remat:
    ``kind`` "plain" on plain fake tensors (remat "dots"), "mesh" on a
    2×2 mesh of the fake group (remat "full").  Run by ``python
    tests/test_torch_fold.py ARCH KIND`` in a process of its own (the
    world is the process's default group), beside the other tests."""
    SSM.mamba2_apply.__kwdefaults__["chunk"] = CHUNK
    XL.mlstm_apply.__kwdefaults__["chunk"] = CHUNK
    if kind == "plain":
        return [_train_step(_cfg(arch, "dots"), f) for f in (True, False)]
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = M.make_host_mesh((2, 2), device="cpu")
        # the first trace in a process also holds a constant that the
        # fake tensors lift once (in zamba2's softplus backward), which
        # would count in only one of the pair
        D.trace_step(_cfg(arch, "none"), ShapeSpec("warm", 1, 2, "train"),
                     mesh, torch.device("cpu"))
        D.choose_accum = lambda *a, **k: ACCUM
        return [_cell(_cfg(arch, "full"), "train", mesh, f)
                for f in (True, False)]
    finally:
        dist.destroy_process_group()


TRAIN_RUNS = [(arch, kind) for arch in ("xlstm-350m", "zamba2-7b")
              for kind in ("mesh", "plain")]


@pytest.fixture(scope="module", autouse=True)
def train_runs():
    """``train_pair`` of both models on both kinds of tensor, each in a
    subprocess started with the module."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs = {run: subprocess.Popen(
        [sys.executable, __file__, *run], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for run in TRAIN_RUNS}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def mesh22():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield M.make_host_mesh((2, 2), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_folded_prefill_equals_every_trip_on_a_2x2_mesh(
        small_chunks, mesh22, arch):
    cfg = _cfg(arch, "full")
    folded, unfolded = (_cell(cfg, "prefill", mesh22, f)
                        for f in (True, False))
    assert folded == unfolded
    assert folded["dot_flops"] > 0 and folded["bytes"]


@pytest.mark.parametrize("arch,kind", TRAIN_RUNS)
def test_folded_train_step_equals_every_trip(train_runs, arch, kind):
    """On plain fake tensors, and with DTensor parameters, the
    activation policy and the per-shard scans on 2×2: the same dot
    FLOPs, peak and collectives by kind (bytes and counts)."""
    proc = train_runs[(arch, kind)]
    stdout, stderr = proc.communicate(timeout=600)
    assert proc.returncode == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("PAIR")]
    folded, unfolded = json.loads(line[-1][len("PAIR"):])
    assert folded == unfolded
    assert folded["dot_flops"] > 0
    assert kind == "plain" or folded["bytes"]


def test_the_uneven_mlstm_head_split_traces(head_split):
    """xlstm-350m's 4 heads do not divide a model axis of 8: the merged
    heads' gradient is gathered before it is split into heads
    (``partitioning.merge_heads``)."""
    stdout, stderr = head_split.communicate(timeout=300)
    assert head_split.returncode == 0, stdout + stderr[-3000:]
    assert "1/1 cells OK" in stdout


if __name__ == "__main__":
    print("PAIR" + json.dumps(train_pair(*sys.argv[1:3])), flush=True)
