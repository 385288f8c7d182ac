"""Distributed geodesic morphology on ``torch.distributed`` with halo
exchange: the paper's pipeline scaled out over a grid of ranks (the
PyTorch/CUDA port's counterpart of ``examples/distributed_morphology.py``).

    PYTHONPATH=src python examples/torch_distributed_morphology.py
        [--device cpu] [--rows 2 --cols 2] [--size 512]

One process per rank.  With ``--device cpu`` the ranks meet in a gloo
group (a 2×2 grid by default); on the GPU (the default) in an NCCL group
with one rank per card (the grid defaults to the cards present).  Each
rank holds one block of the image; rank 0 gathers the results and checks
them against the single-device oracle, as the reference example does.
"""
import argparse
import pathlib
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.core import distributed as D
from repro_torch.core import morphology as M
from repro_torch.data.images import blobs


def rank_main(rank: int, args, store: str) -> None:
    """One rank: its block of each input through the distributed chain
    and reconstruction, then rank 0 compares the gathered images."""
    torch.set_num_threads(1)
    backend = "gloo" if args.device == "cpu" else "nccl"
    device = torch.device("cpu")
    if backend == "nccl":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    grid = D.RankGrid(args.rows, args.cols)
    with D.file_group(store, rank, grid.size, backend):
        f = torch.from_numpy(blobs(args.size, args.size, np.uint8))
        m = torch.from_numpy(blobs(args.size, args.size, np.uint8, seed=9))
        marker = torch.maximum(f, m)

        def block(x):
            return D.scatter_blocks(x, grid, rank).to(device)

        # 64-step chain: halo exchanged once per 16 fused steps (4 times)
        chain = D.distributed_chain(grid, n=64, op="erode", fuse_k=16,
                                    device=device)
        chained = D.gather_blocks(chain(block(f)), grid)
        rec = D.distributed_reconstruct(grid, op="erode", fuse_k=16,
                                        device=device)
        rebuilt = D.gather_blocks(rec(block(marker), block(m)), grid)
        if rank == 0:
            f, m, marker = f.to(device), m.to(device), marker.to(device)
            print(f"grid: {args.rows}x{args.cols} ranks ({backend}, "
                  f"{device.type})")
            print("chain sharded == single-device:",
                  torch.equal(chained, M.erode(f, 64)))
            print("reconstruct sharded == single-device:",
                  torch.equal(rebuilt, M.erode_reconstruct(marker, m)),
                  f"({rec.chunks} chunks)")
            print("per-rank blocks:",
                  tuple(D.scatter_blocks(f, grid, 0).shape))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: NCCL, one rank per card) or "
                         "cpu (gloo)")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--cols", type=int, default=None)
    ap.add_argument("--size", type=int, default=512)
    args = ap.parse_args()
    if args.device not in (None, "cuda", "cpu"):
        ap.error("--device takes cuda or cpu")
    if args.device != "cpu":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu to run the "
                             "ranks on the CPU")
        args.device = "cuda"
    world = 4 if args.device == "cpu" else torch.cuda.device_count()
    if args.rows is None:
        args.rows = max(1, world // 2)
    if args.cols is None:
        args.cols = max(1, world // args.rows)
    size = args.rows * args.cols
    if args.device == "cuda" and size > torch.cuda.device_count():
        raise SystemExit(f"NCCL runs one rank per card: a {args.rows}x"
                         f"{args.cols} grid needs {size} cards, this "
                         f"machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(pathlib.Path(tmp) / "store")
        mp.spawn(rank_main, args=(args, store), nprocs=size, join=True)


if __name__ == "__main__":
    main()
