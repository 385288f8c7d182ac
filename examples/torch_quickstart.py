"""Quickstart of the PyTorch/CUDA port: the paper's geodesic operators
through ``repro_torch``'s public API (the counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--size 256]

Two ways in: the *expression API* (compose a graph, compile once,
execute many times; composites fuse into one padded program) and the
operator sugar, thin wrappers over the same compiles.  ``--device``
defaults to the GPU, where the ``"cuda"`` engine launches the
hand-written kernels; ``--device cpu`` runs their plain PyTorch
versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import E, asf_expr, compile, dome_expr, hmax_expr
from repro_torch.core import operators as OPS
from repro_torch.data.images import blobs
from repro_torch.kernels import ops


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=256)
    args = ap.parse_args()
    dev = args.device

    # a "Male"-like test image: smooth background + multi-scale blobs
    f = torch.from_numpy(blobs(args.size, args.size, np.uint8))
    on = dict(device=dev)

    # --- expression API: compose -> compile -> execute ------------------
    x = E.input("f")
    er64 = compile(x >> E.erode(64), f.shape, f.dtype, **on)(f)
    print("erode_64:   min", int(er64.min()), "max", int(er64.max()))

    open16 = compile(E.opening(16, x), f.shape, f.dtype, **on)(f)
    print("opening_16: mean", float(open16.float().mean()))

    # geodesic reconstruction with kernel-fused convergence detection
    rec_expr = E.reconstruct(E.input("marker"), E.input("mask"),
                             op="erode")
    rec = compile(rec_expr, f.shape, f.dtype, **on)(f.clamp(min=100), f)
    print("reconstruct: fixpoint reached, mean", float(rec.float().mean()))

    # composite graphs fuse end-to-end: ASF_3 is ONE padded program
    asf3 = compile(asf_expr(3), f.shape, f.dtype, **on)
    print("asf_3:      tv-smoothed       ->",
          float(asf3(f).float().std()), "| program:", asf3.stats())

    hm = compile(hmax_expr(40), f.shape, f.dtype, **on)
    dm = compile(dome_expr(40), f.shape, f.dtype, **on)
    print("hmax_40:    maxima suppressed ->", int(hm(f).max()))
    print("dome_40:    residue max       ->", int(dm(f).max()))

    # --- operator sugar (same compiles underneath) ----------------------
    print("hfill:      holes filled      ->", int(OPS.hfill(f, **on).min()))
    print("raobj:      border objs gone  ->", int(OPS.raobj(f, **on).max()))
    d = OPS.qdt(f, **on)
    print("qdt:        max distance      ->", int(d.max()))
    ps = OPS.pattern_spectrum(f, 8, **on)
    print("pattern spectrum (s=0..7):", ps.cpu().numpy().astype(np.int64))
    er = ops.erode(f, 16, **on)  # the engine sugar shares the same cache
    print("kernels.ops.erode(16): mean   ->", float(er.float().mean()))


if __name__ == "__main__":
    main()
