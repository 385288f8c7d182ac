"""The rank side of ``tests/test_torch_grad_placement.py``, run as
``python tests/torch_grad_placement_ranks.py OUT_DIR [8]`` beside the
module's other tests.  Four spawned processes (eight with ``8``) each
join a gloo group through a ``FileStore``, make a 2×2 mesh ("data",
"model") (1×4 for a case of ``MESHES``; a 2×2×2 mesh ("pod", "data",
"model") on eight) and run
each case's train step twice from the same seed: on plain tensors
without a policy (the one-rank step), and on DTensor parameters under
the activation policy; and once more on plain tensors in float64 (the
witness that a float32 gradient's error is its rounding).  Each saves,
for every parameter, its local shard of the gradient that AdamW was
handed and of the updated parameter, beside the same shards cut from
the one-rank steps'.  On eight ranks, each also reduces a float64
pending sum for every case of ``dryrun.REDUCTIONS`` by
``partitioning._reduce_placed`` and by DTensor's redistribution in one
call, and saves both shards.  It imports torch and ``repro_torch``
only, so the ranks start without JAX.
"""
import contextlib
import copy
import dataclasses
import sys

import numpy as np
import torch
import torch.multiprocessing as mp
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import registry
from repro_torch.core.distributed import file_group
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import model as MDL
from repro_torch.models import moe as MOE
from repro_torch.models import partitioning as PT
from repro_torch.optim import adamw
from repro_torch.train import steps as STEPS

D, F, ROWS = 16, 64, 8


class MLP(nn.Module):
    """A column- then row-parallel MLP block with a replicated scale:
    w1 (D, F) columns over "model", w2 (F, D) rows over "model", each
    also split over the batch axes on its other dim (FSDP)."""

    @staticmethod
    def placements(mesh) -> dict:
        """Each parameter's placements on ``mesh``, whose last dim is
        "model" and whose others are batch axes."""
        fsdp = mesh.ndim - 1
        return {"scale": (Replicate(),) * mesh.ndim,
                "w1": (Shard(0),) * fsdp + (Shard(1),),
                "w2": (Shard(1),) * fsdp + (Shard(0),)}

    def __init__(self, gen: torch.Generator):
        super().__init__()
        self.scale = nn.Parameter(1 + 0.1 * torch.randn(D, generator=gen))
        self.w1 = nn.Parameter(torch.randn(D, F, generator=gen) / D ** 0.5)
        self.w2 = nn.Parameter(torch.randn(F, D, generator=gen) / F ** 0.5)

    @property
    def device(self) -> torch.device:
        return self.w1.device


def mlp_loss(model: MLP, batch: dict, q_chunk: int = 0):
    """``loss_fn``'s contract for the MLP: (mean squared error, its
    metrics)."""
    h = torch.relu((batch["x"] * model.scale) @ model.w1) @ model.w2
    loss = ((h - batch["y"]) ** 2).mean()
    return loss, {"loss": loss.detach(), "aux": loss.detach() * 0}


@contextlib.contextmanager
def loss_of(fn):
    """``MDL.loss_fn`` replaced by ``fn`` while open (the train step calls
    it through the module)."""
    orig = MDL.loss_fn
    MDL.loss_fn = fn
    try:
        yield
    finally:
        MDL.loss_fn = orig


@contextlib.contextmanager
def in_float64():
    """While open, tensors made without a dtype or as float32 by
    ``torch.zeros`` are float64, and ``Tensor.float()`` keeps a float64
    tensor as it is, so that the model's float32 casts, buffers and
    carried states compute in float64."""
    cast, zeros = torch.Tensor.float, torch.zeros
    default = torch.get_default_dtype()

    def wide_zeros(*a, dtype=None, **k):
        return zeros(*a, dtype=torch.float64 if dtype == torch.float32
                     else dtype, **k)

    torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                          else cast(t, *a, **k))
    torch.zeros = wide_zeros
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float, torch.zeros = cast, zeros
        torch.set_default_dtype(default)


@contextlib.contextmanager
def routing_margins(gaps: list):
    """While open, each ``MOE.route`` call appends the smallest gap
    between the k-th and the (k+1)-th router probability of the tokens
    it routes (every token of these cases is real: their 16 tokens make
    one router chunk, with no pad)."""
    route = MOE.route

    def spy(x, router, cfg):
        r = route(x, router, cfg)
        top = r.probs.detach().sort(-1, descending=True).values
        gaps.append(float((top[..., cfg.top_k - 1]
                           - top[..., cfg.top_k]).min()))
        return r

    MOE.route = spy
    try:
        yield gaps
    finally:
        MOE.route = route


def _float64(model: nn.Module) -> nn.Module:
    """A float64 copy of ``model``, a language model computing in
    float64."""
    if isinstance(model, MLP):
        return copy.deepcopy(model).double()
    cfg = dataclasses.replace(model.cfg, param_dtype="float64",
                              activation_dtype="float64")
    out = MDL.Model(cfg, device="meta")
    out.load_state_dict({k: v.double() if v.is_floating_point() else v
                         for k, v in model.state_dict().items()},
                        assign=True)
    return out


def _mlp_case(gen, mesh):
    model = MLP(gen)
    batch = {"x": torch.randn(ROWS, D, generator=gen),
             "y": torch.randn(ROWS, D, generator=gen)}
    rows = (Shard(0),) * (mesh.ndim - 1) + (Replicate(),)
    return model, batch, MLP.placements(mesh), {"x": rows, "y": rows}


#: a case's configuration where it is not its architecture's reduced
#: one, and its mesh where it is not 2×2: three query heads and 511
#: tokens, which a model axis of 2 does not divide (the queries split
#: over it, the gold logits taken on each rank's rows); two mLSTM heads
#: on a model axis of 4 (a head a pair of ranks)
VARIANTS = {"gemma-2b-3-heads": ("gemma-2b", {"n_heads": 3,
                                              "vocab_size": 511}),
            "xlstm-350m-2-heads": ("xlstm-350m",
                                   {"n_heads": 2, "n_kv_heads": 2})}
MESHES = {"xlstm-350m-2-heads": (1, 4)}


def _lm_case(arch: str, gen, mesh):
    base, changes = VARIANTS.get(arch, (arch, {}))
    cfg = dataclasses.replace(registry.get_reduced(base), **changes)
    model = MDL.init_params(cfg, gen, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (ROWS, 16), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    specs = SH.param_specs(cfg, model, mesh)
    bspecs = SH.batch_specs({k: v.shape for k, v in batch.items()}, mesh)
    names = mesh.mesh_dim_names
    return (model, batch,
            {n: tuple(PT.placements_of(specs[n], names))
             for n, _ in model.named_parameters()},
            {k: tuple(PT.placements_of(s, names)) for k, s in bspecs.items()})


OPT = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)


def _step(model, batch, accum: int) -> tuple:
    """One train step of ``model`` in place -> (the gradients AdamW was
    handed, the loss)."""
    opt = adamw.init_state(OPT, dict(model.named_parameters()))
    seen: dict = {}
    step = STEPS.build_train_step(
        registry.get_reduced("gemma-2b"), OPT, q_chunk=8, accum=accum,
        device="cpu", observe=lambda params, grads: seen.update(grads))
    loss = step(model, opt, batch)[2]["loss"]
    if isinstance(loss, DTensor):
        loss = loss.full_tensor()
    return seen, float(loss)


def _place(model: nn.Module, placements: dict, mesh) -> None:
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod.register_parameter(leaf, nn.Parameter(distribute_tensor(
            p.detach(), mesh, list(placements[name]), src_data_rank=None)))


def _shard(t: torch.Tensor, mesh, placements) -> np.ndarray:
    """This rank's shard of the whole tensor ``t`` (the same on every
    rank) under ``placements``."""
    return distribute_tensor(t, mesh, list(placements),
                             src_data_rank=None).to_local().numpy()


def run_case(name: str, accum: int, mesh) -> dict:
    """The steps of one case -> the three steps' losses and
    ``params``: {parameter: arrays and placements}.
    ``grad_float64`` is the one-rank gradient computed in float64, and
    ``grad_rounding`` the one-rank float32 gradient's largest distance
    from it;
    ``param_replay`` is the one-rank AdamW step taken on the sharded
    step's own gradients, gathered whole; ``routing_margin`` (a MoE
    case) the one-rank float32 step's smallest gap between a token's
    k-th and (k+1)-th router probability."""
    gen = torch.Generator().manual_seed(0)
    model, batch, placements, bplacements = (
        _mlp_case(gen, mesh) if name == "mlp" else
        _lm_case(name, gen, mesh))
    sharded, replay = copy.deepcopy(model), copy.deepcopy(model)
    wide = _float64(model)
    loss = loss_of(mlp_loss) if name == "mlp" else contextlib.nullcontext()
    with loss:
        with in_float64():
            grads64, loss64 = _step(wide, {
                k: v.double() if v.is_floating_point() else v
                for k, v in batch.items()}, accum)
        with routing_margins([]) as gaps:
            plain_grads, plain_loss = _step(model, batch, accum)
        _place(sharded, placements, mesh)
        dbatch = {k: distribute_tensor(v, mesh, list(bplacements[k]),
                                       src_data_rank=None)
                  for k, v in batch.items()}
        policy = PT.Policy(mesh, batch_axes(mesh))
        with implicit_replication(), PT.apply_policy(policy):
            grads, loss = _step(sharded, dbatch, accum)
    whole = {n: g.full_tensor() for n, g in grads.items()}
    adamw.apply_updates(OPT, dict(replay.named_parameters()), whole,
                        adamw.init_state(OPT, dict(replay.named_parameters())))
    out = {"loss": loss, "loss_one_rank": plain_loss, "loss_float64": loss64,
           "params": {}}
    if gaps:
        out["routing_margin"] = min(gaps)
    plain = dict(model.named_parameters())
    replayed = dict(replay.named_parameters())
    for n, p in sharded.named_parameters():
        g = grads[n]
        out["params"][n] = {
            "grad_placements": [str(q) for q in g.placements],
            "param_placements": [str(q) for q in p.placements],
            "is_dtensor": isinstance(g, DTensor),
            "grad": g.to_local().detach().numpy(),
            "grad_one_rank": _shard(plain_grads[n].detach(), mesh,
                                    p.placements),
            "grad_max": float(plain_grads[n].abs().max()),
            "grad_float64": _shard(grads64[n].detach(), mesh, p.placements),
            "grad_rounding": float((plain_grads[n].detach().double()
                                    - grads64[n].detach()).abs().max()),
            "param": p.to_local().detach().numpy(),
            "param_one_rank": _shard(plain[n].detach(), mesh, p.placements),
            "param_max": float(plain[n].detach().abs().max()),
            "param_replay": _shard(replayed[n].detach(), mesh, p.placements),
        }
    return out


def run_reductions(mesh) -> dict:
    """``{"have -> want": (this rank's shard by ``_reduce_placed``, by
    DTensor's redistribution in one call)}`` for every case of
    ``dryrun.REDUCTIONS``: a float64 (16, 16, 16) local tensor a rank,
    the same on the ranks that a replicated mesh dim joins."""
    coord = mesh.get_coordinate()
    out = {}
    for k, (have, want) in enumerate(DRY.REDUCTIONS):
        placed, wanted = DRY._placements(have), DRY._placements(want)
        seed = [k] + [0 if isinstance(p, Replicate) else c
                      for p, c in zip(placed, coord)]
        gen = torch.Generator().manual_seed(int("".join(map(str, seed))))
        local = torch.randn(16, 16, 16, generator=gen, dtype=torch.float64)
        x = DTensor.from_local(local, mesh, placed, run_check=False)
        out[f"{have} -> {want}"] = (
            PT._reduce_placed(x, wanted).to_local().numpy(),
            x.redistribute(mesh, wanted).to_local().numpy())
    return out


def run_cases(rank: int, world: int, store: str, cases: list,
              out_dir: str) -> None:
    """``torch.multiprocessing.spawn`` target: every (name, accum) case,
    in order, a ``.npy`` pickle a case and rank (an error's text if the
    case raised); on eight ranks the reductions' case first."""
    torch.set_num_threads(1)
    with file_group(store, rank, world):
        if world == 8:
            cube = make_host_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
            meshes = {None: cube}
            cases = [("reductions", 0)] + cases
        else:
            meshes = {dims: make_host_mesh(dims, ("data", "model"), "cpu")
                      for dims in {(2, 2), *MESHES.values()}}
            meshes[None] = meshes[(2, 2)]
        for name, accum in cases:
            mesh = meshes.get(MESHES.get(name), meshes[None])
            try:
                res = (run_reductions(mesh) if name == "reductions" else
                       run_case(name, accum, mesh))
            except Exception as e:  # noqa: BLE001
                res = {"error": f"{type(e).__name__}: {e}"[:3000]}
            np.save(f"{out_dir}/{name}-{accum}-{rank}.npy",
                    np.array(res, dtype=object), allow_pickle=True)


#: (case, microbatches): the MLP, then reduced gemma-2b and zamba2-7b,
#: gemma-2b and xlstm-350m with heads that do not divide "model", and
#: the MoEs: reduced deepseek-moe-16b (its shared expert) and
#: arctic-480b (its dense residual FFN)
CASES = [(name, accum) for name in ("mlp", "gemma-2b", "zamba2-7b")
         for accum in (1, 2)] + [(name, 1) for name in VARIANTS] + [
             ("deepseek-moe-16b", 1), ("deepseek-moe-16b", 2),
             ("arctic-480b", 1)]
#: on eight ranks, a 2×2×2 mesh: pending sums over ("pod", "data")
#: reduced into dims split over both (the MLP's FSDP gradients, the MoE's
#: slots, the embedding table's)
CASES_8 = [("mlp", 1), ("deepseek-moe-16b", 1)]

if __name__ == "__main__":
    out_dir = sys.argv[1]
    world = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    mp.spawn(run_cases, args=(world, f"{out_dir}/store",
                              CASES_8 if world == 8 else CASES, out_dir),
             nprocs=world, join=True)
