"""The rank side of ``tests/test_torch_distributed.py``: each spawned
process joins a gloo group through a ``FileStore`` and runs every case
on its block of the grid the case names; group rank 0 of that grid
saves the gathered image.  It imports torch and ``repro_torch`` only,
so the ranks start without JAX.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import distributed as D


def grids(pair) -> dict:
    """The grids of the cases: 2×2 and 4×1 over the whole world, 1×2
    over the two-rank group ``pair`` (global ranks 2 and 3, so a group
    rank is not a global rank)."""
    return {"2x2": D.RankGrid(2, 2), "4x1": D.RankGrid(4),
            "1x2": D.RankGrid(1, 2, group=pair)}


def run_case(case: dict, grid: D.RankGrid, rank: int, inputs: dict):
    """One case on this rank's blocks; returns the local result and the
    chunks a reconstruction ran (None for a chain)."""
    f, m = (torch.from_numpy(a) for a in inputs[case["input"]])
    engine = dict(op=case["op"], backend=case["engine"],
                  fuse_k=case["fuse_k"], device="cpu")
    if case["kind"] == "chain":
        fn = D.distributed_chain(grid, n=case["n"], **engine)
        return fn(D.scatter_blocks(f, grid, rank)), None
    marker = torch.maximum(f, m) if case["op"] == "erode" else torch.minimum(
        f, m)
    rec = D.distributed_reconstruct(grid, max_chunks=case["max_chunks"],
                                    **engine)
    out = rec(D.scatter_blocks(marker, grid, rank),
              D.scatter_blocks(m, grid, rank))
    return out, rec.chunks


def run_cases(rank: int, world: int, store: str, cases: list, inputs: dict,
              out_dir: str) -> None:
    """``torch.multiprocessing.spawn`` target: every case, in order."""
    torch.set_num_threads(1)
    with D.file_group(store, rank, world):
        pair = dist.new_group([2, 3])  # every rank takes part in creating it
        by_name = grids(pair)
        for case in cases:
            grid = by_name[case["grid"]]
            if grid.group is not None and rank not in (2, 3):
                continue
            local, chunks = run_case(case, grid, grid.rank(), inputs)
            image = D.gather_blocks(local, grid)
            if grid.rank() == 0:
                np.savez(f"{out_dir}/{case['name']}.npz", out=image.numpy(),
                         chunks=-1 if chunks is None else chunks)
