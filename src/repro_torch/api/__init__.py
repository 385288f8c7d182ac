"""repro_torch.api — the morphology expression API on PyTorch/CUDA.

compose → plan → compile → execute::

    from repro_torch.api import E, compile

    f    = E.input("f")
    expr = E.reconstruct(E.sat_sub(f, 40), f, op="dilate")   # HMAX_40
    exe  = compile(expr, image.shape, image.dtype)   # "cuda" engine, GPU
    out  = exe(image)            # (H, W) or (N, H, W), bit-exact
    exe.stats()                  # pads / launches / refills / plan

Layers (mirroring ``repro.api``): ``expr`` (a copy of the graph
vocabulary), ``lower`` (graph → prepare/run/finalize program),
``compile`` (plan binding and the LRU), ``executable`` (one pad, fused
kernel segments, one crop).
"""
from repro_torch.api.compile import cache_stats, clear_cache, compile
from repro_torch.api.executable import Executable
from repro_torch.api.expr import (E, Expr, Pipe, asf_expr, dome_expr,
                                  hfill_expr, hmax_expr,
                                  opening_by_reconstruction_expr,
                                  qdt_l1_expr, raobj_expr)
from repro_torch.api.lower import Program, lower

__all__ = [
    "E", "Expr", "Pipe", "Program", "Executable",
    "compile", "lower", "cache_stats", "clear_cache",
    "hmax_expr", "dome_expr", "hfill_expr", "raobj_expr",
    "opening_by_reconstruction_expr", "asf_expr", "qdt_l1_expr",
]
