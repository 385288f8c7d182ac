"""Every gradient on its parameter's placements in the port's sharded
train step: ``partitioning.reduce_grads_to_params`` reduces each one as
the backward makes it (the reference's ``grad_shardings``), and the
float32 microbatch sum keeps those placements.

On a 2×4 mesh of torch's fake process group (one process standing for
eight ranks, as in ``tests/test_torch_dryrun.py``), reduced gemma-2b,
zamba2-7b and deepseek-moe-16b take one train step of 8 × 32 tokens at
1 and 2 microbatches:
every gradient that AdamW is handed has its parameter's placements, no
pending sum, and as many local bytes as the parameter.  Before the
reduction (the code as it was without it; a CPU run, not asserted)
reduced zamba2-7b at 2 microbatches peaked at 3 830 272 B, its
gradients holding 643 736 B of locals against the masters' 113 432;
with it the peak is 3 299 328 B and the gradients hold 113 432 B.

On four gloo ranks (a 2×2 mesh; ``tests/torch_grad_placement_ranks.py``,
run as a subprocess beside the other tests) a column/row-parallel MLP
and reduced gemma-2b and zamba2-7b take the same step on DTensors and
on plain tensors from the same seed, and each rank's shards are held
against the one-rank step's.  So do reduced gemma-2b with three query
heads, which "model" does not divide (its ranks attend for blocks of
the queries, ``partitioning.attend_merged``), and reduced xlstm-350m
with two mLSTM heads on a 1×4 mesh (a head a pair of ranks,
``partitioning.local_shards``); every ``constrain`` pins its gradient.
So do reduced deepseek-moe-16b (its shared expert) at 1 and 2
microbatches and reduced arctic-480b (its dense residual FFN), whose
ranks route, dispatch and combine their own rows for their own experts
(``partitioning.expert_shards``); each MoE case's one-rank step routes
no token within ``ROUTING_MARGIN`` of a tie between its k-th and
(k+1)-th expert, so no difference can come from a flipped choice.
A float64 one-rank step is the witness for the float32 rounding: the
one-rank float32 gradients of the MLP and of gemma-2b lie within 7.4e-7
of their largest element from it, and the sharded ones within 1e-6 of
the one-rank float32 ones.  zamba2-7b's, the two-head xlstm-350m's and
deepseek-moe-16b's in one microbatch one-rank float32 gradients lie
further from it (the SSD's and the xLSTM's float32 cumulative decays;
the MoE by 1.01e-6 of its largest element), so their sharded ones are
held against the float64 step instead (measured for zamba2-7b: at most 2.3
times as far as the one-rank float32 gradient, on a CPU, torch 2.13).
The losses are held alike.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch.configs import registry
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.op_count import local_bytes
from repro_torch.models import partitioning as PT

REPO = pathlib.Path(__file__).resolve().parent.parent
TRACED = [(arch, accum) for arch in ("gemma-2b", "zamba2-7b",
                                    "deepseek-moe-16b")
          for accum in (1, 2)]
#: the MoE cases of ``RANK_CASES``
MOE_CASES = [("deepseek-moe-16b", 1), ("deepseek-moe-16b", 2),
             ("arctic-480b", 1)]
RANK_CASES = [(name, accum) for name in ("mlp", "gemma-2b", "zamba2-7b")
              for accum in (1, 2)] + [("gemma-2b-3-heads", 1),
                                      ("xlstm-350m-2-heads", 1)] + MOE_CASES
#: a MoE case's smallest gap between a token's k-th and (k+1)-th router
#: probability: above it, no float32 rounding flips a top-k choice
ROUTING_MARGIN = 1e-5
#: a gradient against the one-rank step's, and an updated parameter
#: against the one-rank step's, as a share of its largest element
GRAD_TOL = PARAM_TOL = 1e-6
#: the sharded step's loss against the one-rank step's, as a share of it
LOSS_TOL = 1e-6
#: in a case where a one-rank float32 gradient lies further than
#: ``GRAD_TOL`` from the float64 one, each sharded gradient lies at most
#: this many times as far from the float64 one as the one-rank float32
#: gradient (or as ``GRAD_TOL``)
ROUNDING = 4
#: the cases whose one-rank float32 gradients lie further than
#: ``GRAD_TOL`` from the float64 ones (the SSD's and the xLSTM's float32
#: cumulative decays; reduced deepseek-moe-16b in one microbatch, by
#: 1.01e-6 of its largest element)
ROUNDED = {("zamba2-7b", 1), ("zamba2-7b", 2), ("xlstm-350m-2-heads", 1),
           ("deepseek-moe-16b", 1)}
#: AdamW's first update is g / (|g| + eps): where a gradient element is
#: below this share of its largest, a float32 rounding of it can turn
#: its update by up to the learning rate
CONDITIONED = 1e-3


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                OMP_NUM_THREADS="1")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def subprocesses(tmp_path_factory):
    """The four gloo ranks and one dry-run CLI cell, started with the
    module so that they run beside its other tests."""
    tmp = tmp_path_factory.mktemp("grad_placement")
    procs = {
        "ranks": subprocess.Popen(
            [sys.executable, str(REPO / "tests" /
                                 "torch_grad_placement_ranks.py"),
             str(tmp)], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "gemma-2b", "--shape", "train_4k", "--reduced", "--mesh", "2x4",
             "--batch", "8", "--seq-len", "32", "--device", "cpu", "--out",
             str(tmp / "cell.json")], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    yield procs, tmp
    for p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _finished(subprocesses, name: str):
    procs, tmp = subprocesses
    stdout, stderr = procs[name].communicate(timeout=300)
    assert procs[name].returncode == 0, stdout[-2000:] + stderr[-3000:]
    return tmp


@pytest.fixture(scope="module")
def mesh24():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield M.make_host_mesh((2, 4), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,accum", TRACED)
def test_every_gradient_adamw_is_handed_has_its_parameters_placements(
        mesh24, monkeypatch, arch, accum):
    """Traced on fake tensors: the gradients AdamW is handed are placed
    as their parameters, with no ``Partial`` pending, and their local
    bytes equal the float32 masters'; at 2 microbatches that is the
    float32 sum divided by 2 (each microbatch's gradients arrive
    reduced, and the sum and ``/ accum`` keep their placements)."""
    seen = {}
    monkeypatch.setattr(D, "choose_accum", lambda *a, **k: accum)
    cfg = registry.get_reduced(arch)
    D.trace_step(cfg, ShapeSpec("cell", 32, 8, "train"), mesh24,
                 torch.device("cpu"),
                 observe=lambda params, grads: seen.update(
                     params=dict(params), grads=dict(grads)))
    params, grads = seen["params"], seen["grads"]
    assert set(grads) == set(params)
    for name, p in params.items():
        g = grads[name]
        assert isinstance(g, DTensor), name
        assert tuple(g.placements) == tuple(p.placements), name
        assert not any(q.is_partial() for q in g.placements), name
        assert g.dtype == p.dtype == torch.float32, name
    assert local_bytes(grads.values()) == local_bytes(params.values())
    # some parameter is split over the batch axes
    assert any(isinstance(q, Shard) for p in params.values()
               for q in p.placements[:1])


def test_the_record_holds_gradient_and_master_bytes(subprocesses):
    """The dry-run CLI's train record: ``grad_bytes_per_device`` equals
    ``master_bytes_per_device``, beside every key it had."""
    tmp = _finished(subprocesses, "cli")
    (r,) = json.loads((tmp / "cell.json").read_text())
    assert r["ok"] and r["mesh"] == "2x4" and r["accum"] == 1
    assert r["grad_bytes_per_device"] == r["master_bytes_per_device"] > 0
    assert r["master_bytes_per_device"] < r["arg_bytes"] \
        < r["bytes_per_device"]
    assert set(r) >= {"bytes_per_device", "arg_bytes", "temp_bytes",
                      "fits_80g", "hlo_dot_flops_per_device",
                      "collective_bytes_per_device", "collectives",
                      "collective_counts", "top_collectives", "model_flops",
                      "analytic_flops", "compute_s", "memory_s",
                      "collective_s", "dominant", "trace_s"}


def _partial_grad(mesh, policy):
    """(the gradient of (x @ w).sum() with x's rows split over "data" —
    a pending sum over it unless a hook reduces it —, the hooks the
    stand-in registered, w)."""
    w = distribute_tensor(torch.ones(4, 8), mesh, [Shard(0), Replicate()],
                          src_data_rank=None).requires_grad_()
    x = distribute_tensor(torch.ones(6, 4), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    with PT.apply_policy(policy), PT.reduce_grads_to_params([w]) as r:
        hooks = len(r.handles)
        (g,) = torch.autograd.grad((x @ w).sum(), [w])
    assert r.handles == []
    return g, hooks, w


def test_the_stand_in_does_nothing_without_a_policy_or_on_plain_tensors(
        mesh24):
    policy = PT.Policy(mesh24, ("data",))
    g, hooks, _ = _partial_grad(mesh24, None)
    assert hooks == 0 and any(q.is_partial() for q in g.placements)
    g, hooks, w = _partial_grad(mesh24, policy)
    assert hooks == 1 and tuple(g.placements) == tuple(w.placements)
    # plain tensors under a policy: no hook, the same gradient
    w = torch.linspace(-1, 1, 12).reshape(3, 4).requires_grad_()
    x = torch.linspace(0, 2, 6).reshape(2, 3)
    (plain,) = torch.autograd.grad((x @ w).square().sum(), [w])
    with PT.apply_policy(policy), PT.reduce_grads_to_params([w]) as r:
        assert r.handles == []
        (g,) = torch.autograd.grad((x @ w).square().sum(), [w])
    assert torch.equal(g, plain)


def test_the_hooks_go_when_the_block_raises(mesh24):
    policy = PT.Policy(mesh24, ("data",))
    w = distribute_tensor(torch.ones(4, 8), mesh24, [Shard(0), Replicate()],
                          src_data_rank=None).requires_grad_()
    with PT.apply_policy(policy):
        with pytest.raises(RuntimeError, match="inside"):
            with PT.reduce_grads_to_params([w]) as r:
                assert len(r.handles) == 1
                raise RuntimeError("inside")
        assert r.handles == []
        x = distribute_tensor(torch.ones(6, 4), mesh24,
                              [Shard(0), Replicate()], src_data_rank=None)
        (g,) = torch.autograd.grad((x @ w).sum(), [w])
    assert any(q.is_partial() for q in g.placements)


@pytest.fixture(scope="module")
def rank_results(subprocesses):
    tmp = _finished(subprocesses, "ranks")
    out = {}
    for name, accum in RANK_CASES:
        for rank in range(4):
            res = np.load(tmp / f"{name}-{accum}-{rank}.npy",
                          allow_pickle=True).item()
            assert "error" not in res, (name, accum, rank, res.get("error"))
            out[(name, accum, rank)] = res
    return out


@pytest.mark.parametrize("name,accum", RANK_CASES)
def test_the_sharded_loss_equals_the_one_rank_loss_on_four_gloo_ranks(
        rank_results, name, accum):
    """Every rank's loss equals the one-rank step's within ``LOSS_TOL`` of
    it, and lies at most ``ROUNDING`` times as far from the float64
    step's loss as the one-rank float32 loss does (or as ``LOSS_TOL``)."""
    for rank in range(4):
        r = rank_results[(name, accum, rank)]
        one, wide = r["loss_one_rank"], r["loss_float64"]
        assert abs(r["loss"] - one) <= LOSS_TOL * abs(one), (rank, r["loss"],
                                                             one)
        bound = max(abs(one - wide), LOSS_TOL * abs(wide))
        assert abs(r["loss"] - wide) <= ROUNDING * bound, (rank, r["loss"],
                                                           wide)


@pytest.mark.parametrize("name,accum", MOE_CASES)
def test_no_moe_case_routes_a_near_tie(rank_results, name, accum):
    """Each MoE case's one-rank step routes every token with a gap of
    more than ``ROUTING_MARGIN`` between its k-th and (k+1)-th router
    probability, so that a sharded step that differs from it cannot be
    put down to a top-k choice flipped by rounding."""
    for rank in range(4):
        margin = rank_results[(name, accum, rank)]["routing_margin"]
        assert margin > ROUTING_MARGIN, (rank, margin)


@pytest.mark.parametrize("name,accum", RANK_CASES)
def test_the_sharded_step_equals_the_one_rank_step_on_four_gloo_ranks(
        rank_results, name, accum):
    """Each rank's gradient shard is on its parameter's placements and
    equals the one-rank gradient's within ``GRAD_TOL`` of its largest
    element, in a case whose one-rank float32 gradients are all that
    close to the float64 ones; in the others (``ROUNDED``) each lies at
    most ``ROUNDING`` times as far from the float64 gradient as the
    one-rank float32 gradient does.

    Each rank's updated parameters equal the one-rank step's within
    ``PARAM_TOL`` of their largest element: everywhere for the MLP, and
    for a language model wherever the one-rank gradient is at least
    ``CONDITIONED`` of its largest.  Everywhere, they equal the one-rank
    AdamW step taken on the sharded step's own gradients, gathered whole,
    within ``PARAM_TOL``."""
    exact = all(d["grad_rounding"] <= GRAD_TOL * d["grad_max"]
                for d in rank_results[(name, accum, 0)]["params"].values())
    assert exact == ((name, accum) not in ROUNDED)
    for rank in range(4):
        for pname, d in rank_results[(name, accum, rank)]["params"].items():
            tag = (name, accum, rank, pname)
            assert d["is_dtensor"], tag
            assert d["grad_placements"] == d["param_placements"], tag
            assert "Partial" not in "".join(d["grad_placements"]), tag
            gmax, pmax = d["grad_max"], d["param_max"]
            if exact:
                err = np.abs(d["grad"] - d["grad_one_rank"]).max()
                assert err <= GRAD_TOL * gmax, (tag, err / gmax)
            else:
                bound = max(d["grad_rounding"], GRAD_TOL * gmax)
                err = np.abs(d["grad"] - d["grad_float64"]).max()
                assert err <= ROUNDING * bound, (tag, err / bound)
            diff = np.abs(d["param"] - d["param_one_rank"])
            if name != "mlp":
                diff = diff[np.abs(d["grad_one_rank"])
                            >= CONDITIONED * gmax]
            assert diff.max() <= PARAM_TOL * pmax, (tag, diff.max() / pmax)
            err = np.abs(d["param"] - d["param_replay"]).max()
            assert err <= PARAM_TOL * pmax, (tag, err / pmax)
