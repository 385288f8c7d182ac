"""The rank side of ``tests/test_torch_compression.py``: each spawned
process joins a four-rank gloo group through a ``FileStore`` and runs
every case of the module; rank 0 saves what the parent checks.  It
imports torch and ``repro_torch`` only, so the ranks start without JAX.
"""
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_reduced
from repro_torch.core import distributed as D
from repro_torch.launch import mesh as MESH
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim.compression import init_error, psum_compressed
from repro_torch.train.steps import (build_compressed_train_step,
                                     build_train_step)

ARCH = "gemma-2b"
#: the reference's convergence test's optimizer and flash chunk
OPT = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=20)
Q_CHUNK = 16


def fresh_model(state: dict):
    """A model holding copies of ``state``'s arrays (the steps update
    their model in place)."""
    model = M.Model(get_reduced(ARCH), device="meta")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in state.items()}, assign=True)
    return model


def compressed_run(mesh, data_axes, state: dict, batch: dict,
                   steps: int) -> tuple:
    """``steps`` compressed steps on ``batch`` from ``state`` -> (the
    parameters after each step, the metrics of each step)."""
    model = fresh_model(state)
    params = dict(model.named_parameters())
    opt = dict(adamw.init_state(OPT, params), err=init_error(params))
    step = build_compressed_train_step(get_reduced(ARCH), OPT, mesh,
                                       data_axes, q_chunk=Q_CHUNK,
                                       device="cpu")
    after, metrics = [], []
    for _ in range(steps):
        model, opt, m = step(model, opt, batch)
        after.append({n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()})
        metrics.append({k: float(v) for k, v in m.items()})
    return after, metrics


def plain_losses(state: dict, batch: dict, steps: int) -> list:
    model = fresh_model(state)
    opt = adamw.init_state(OPT, dict(model.named_parameters()))
    step = build_train_step(get_reduced(ARCH), OPT, q_chunk=Q_CHUNK,
                            device="cpu")
    losses = []
    for _ in range(steps):
        model, opt, m = step(model, opt, batch)
        losses.append(float(m["loss"]))
    return losses


def run(rank: int, world: int, store: str, inputs: dict,
        out_dir: str) -> None:
    """``torch.multiprocessing.spawn`` target: every case, in order."""
    torch.set_num_threads(1)
    out = {}
    with D.file_group(store, rank, world):
        # psum_compressed: this rank's leaves, the default group
        grads = {k: torch.from_numpy(v[rank].copy())
                 for k, v in inputs["grads"].items()}
        errs = {k: torch.from_numpy(v[rank].copy())
                for k, v in inputs["errs"].items()}
        mean, new_err = psum_compressed(grads, errs)
        out["psum"] = ({k: v.numpy() for k, v in mean.items()},
                       {k: v.numpy() for k, v in new_err.items()})

        data = MESH.make_host_mesh(device="cpu")
        pod = MESH.make_host_mesh((2, 2), ("pod", "data"), device="cpu")
        out["batch_axes"] = (MESH.batch_axes(data), MESH.batch_axes(pod))
        try:
            MESH.make_production_mesh(device="cpu")
        except ValueError as e:
            out["production"] = str(e)
        state = inputs["state"]
        out["reference_steps"] = compressed_run(
            data, "data", state, inputs["step_batch"], 2)
        out["pod_steps"] = compressed_run(
            pod, ("pod", "data"), state, inputs["step_batch"], 2)
        two = MESH.make_host_mesh((2, 2), device="cpu")
        out["two_data_steps"] = compressed_run(
            two, "data", state, inputs["step_batch"], 1)
        _, tracked = compressed_run(data, "data", state,
                                    inputs["track_batch"], 5)
        out["tracked"] = [m["loss"] for m in tracked]
        bad = {k: v[:6] for k, v in inputs["step_batch"].items()}
        try:
            compressed_run(data, "data", state, bad, 1)
        except ValueError as e:
            out["indivisible"] = str(e)
        dist.barrier()
    if rank == 0:
        out["plain"] = plain_losses(state, inputs["track_batch"], 5)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
