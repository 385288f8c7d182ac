"""Where a dry-run cell's trace spends its seconds, and what holds the
bytes at its peak — a diagnostic of ``launch.dryrun`` itself.

    PYTHONPATH=src python -m repro_torch.launch.trace_profile \\
        --arch zamba2-7b --shape train_4k --seq-len 512 --device cpu \\
        [--no-fold] [--peak] [--dots] [--collectives] [--mesh 16x16] \\
        [--reduced]

Prints one JSON line: the cell's record figures, the trace's wall
seconds inside each region (inclusive timers around the microbatch
forward+backward, ``torch.autograd.grad``, the SSD, mLSTM and sLSTM
scans — forward and checkpoint recompute — the flash loop's forward
and backward, AdamW, and DTensor's sharding propagation), and with
``--peak`` the live bytes at the peak by the op (and autograd node)
that made each storage, and by op and shape.  The regions nest (the
scans run inside the microbatches), so their seconds do not add up.

``--dots`` adds the rank's dot FLOPs by product: the op, its local
shapes, the model-code frame that issued it (for a product of
autograd's own backward, the frame whose forward op made the node,
which anomaly mode records), and whether it ran in the forward, the
backward or a checkpoint's recompute.  The counter's fold weights are
applied, so ``dots_total`` equals the record's
``hlo_dot_flops_per_device``.

``--collectives`` adds the rank's collective bytes by kind, result
shape, model-code frame, phase and the frame of the sharding layer
(``models/partitioning.py``) that issued it — for a collective of
autograd's own backward (a redistribution's, say), the frame whose
forward made the node.  ``collectives_total`` equals the record's
``collective_bytes_per_device``.
"""
from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import sys
import time
import weakref

import torch


def _timers(regions: dict) -> None:
    """Wrap each region's function with an inclusive timer (outermost
    call only) that adds to ``regions``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.models import attention, ssm, xlstm
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    depth: dict = collections.Counter()

    def timed(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            depth[name] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[name] -= 1
                if not depth[name]:
                    regions[name] = (regions.get(name, 0.0)
                                     + time.perf_counter() - t0)
        return inner

    for owner, attr, name in (
            (steps, "_grads", "microbatch forward+backward"),
            (torch.autograd, "grad", "backward (autograd.grad)"),
            (ssm, "_ssd", "SSD chunk scan"),
            (xlstm, "_mlstm_scan", "mLSTM chunk scan"),
            (xlstm, "_slstm_scan", "sLSTM token scan"),
            (attention, "_flash_fwd", "flash forward"),
            (attention, "_flash_bwd", "flash backward"),
            (adamw, "apply_updates", "AdamW"),
            (ShardingPropagator, "propagate_op_sharding_non_cached",
             "DTensor sharding propagation (uncached)")):
        setattr(owner, attr, timed(name, getattr(owner, attr)))


def _peak_counter(base):
    """An ``OpCounter`` (``base``) that also keeps, at its peak, which op
    made each live storage."""
    from repro_torch.launch import op_count

    class PeakCounter(base):
        def __init__(self, fold: bool = False):
            super().__init__(fold=fold)
            self.made: dict = {}
            self.alive: set = set()
            self.op = "argument"
            self.at_peak: tuple = ("", "", [])

        def _hold(self, t):
            if t.device.type == "meta":
                return
            st = t.untyped_storage()
            if st in self._storages:
                return
            node = torch._C._current_autograd_node()
            where = node.name() if node is not None else "forward"
            key = id(st)
            self.made[key] = (self.op, where, op_count._block(st.nbytes()),
                              f"{str(t.dtype)[6:]}{list(t.shape)}")
            super()._hold(t)
            self.alive.add(key)
            weakref.finalize(st, self.alive.discard, key)
            if self.live == self.peak:
                self.at_peak = (self.op, where, list(self.alive))

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not any(issubclass(t, op_count.DTensor) for t in types):
                self.op = str(func).replace("aten.", "")
            return super().__torch_dispatch__(func, types, args, kwargs)

    return PeakCounter


#: the model code's frames: a product is told by the innermost of them
_MODEL_CODE = re.compile(
    r"repro_torch[/\\](models|train)[/\\](?!partitioning)")
#: the sharding layer's frames: a collective is told by the innermost
_SHARDING_CODE = re.compile(r"repro_torch[/\\]models[/\\]partitioning\.py$")
_STACK_LINE = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def _frame_here():
    """(the innermost model-code frame on the Python stack, or None;
    whether a checkpoint's recompute is on the stack)."""
    f, found, recompute = sys._getframe(2), None, False
    while f is not None:
        name = f.f_code.co_filename
        if found is None and _MODEL_CODE.search(name):
            found = _where(name, f.f_lineno, f.f_code.co_name)
        recompute |= name.endswith(os.path.join("utils", "checkpoint.py"))
        f = f.f_back
    return found, recompute


def _where(path: str, line: int, func: str) -> str:
    cut = path.replace("\\", "/").rsplit("/src/", 1)[-1]
    return f"{cut}:{line} {func}"


def _node_frame(node, code=_MODEL_CODE) -> str | None:
    """The innermost frame of ``code`` (the model code's by default) in
    the forward stack that made autograd ``node`` (anomaly mode's
    record), with the node's name; None if there is none."""
    for line in reversed(node.metadata.get("traceback_", [])):
        m = _STACK_LINE.search(line)
        if m and code.search(m.group(1)):
            return (f"{_where(m.group(1), int(m.group(2)), m.group(3))} "
                    f"({node.name()})")
    return None


def _frames():
    """(forward, backward or recompute; the innermost model-code frame;
    the innermost sharding-layer frame, or None) of the op running now.
    Autograd's own backward runs under the frame that called it (the
    train step's), not under the model code: an op of it takes the
    frames of the forward that made its node."""
    where, recompute = _frame_here()
    node = torch._C._current_autograd_node()
    phase = ("forward" if node is None else
             "recompute" if recompute else "backward")
    f, site = sys._getframe(1), None
    while f is not None and site is None:
        if _SHARDING_CODE.search(f.f_code.co_filename):
            site = _where(f.f_code.co_filename, f.f_lineno,
                          f.f_code.co_qualname)
        f = f.f_back
    if phase == "backward":
        if where is None or "/models/" not in where:
            where = _node_frame(node) or node.name()
        site = site or _node_frame(node, _SHARDING_CODE)
    return phase, where or "?", site or "-"


def _dots_counter(base):
    """An ``OpCounter`` (``base``) that also sums its weighted dot FLOPs
    by (phase, op, local shapes, model-code frame)."""

    class DotsCounter(base):
        def __init__(self, fold: bool = False):
            super().__init__(fold=fold)
            self.by_dot: collections.Counter = collections.Counter()

        def _on_dot(self, packet, args, flops):
            super()._on_dot(packet, args, flops)
            phase, where, _ = _frames()
            shapes = " x ".join(
                f"{str(a.dtype)[6:]}{list(a.shape)}" for a in args
                if isinstance(a, torch.Tensor))
            self.by_dot[(phase, str(packet).replace("aten.", ""), shapes,
                         where)] += flops

    return DotsCounter


def _collectives_counter(base):
    """An ``OpCounter`` (``base``) that also sums its weighted collective
    bytes by (phase, kind, result, model-code frame, the sharding
    layer's frame that issued it)."""

    class CollectivesCounter(base):
        def __init__(self, fold: bool = False):
            super().__init__(fold=fold)
            self.by_collective: collections.Counter = collections.Counter()

        def _on_collective(self, kind, result, nbytes):
            super()._on_collective(kind, result, nbytes)
            phase, where, site = _frames()
            self.by_collective[(phase, kind, f"{str(result.dtype)[6:]}"
                                f"{list(result.shape)}", where,
                                site)] += nbytes

    return CollectivesCounter


def main(argv=None) -> int:
    from repro_torch.configs.shapes import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--no-fold", action="store_true",
                    help="run every trip of the folded loops")
    ap.add_argument("--peak", action="store_true",
                    help="what holds the bytes at the peak")
    ap.add_argument("--dots", action="store_true",
                    help="dot FLOPs by product, shapes, frame and phase")
    ap.add_argument("--collectives", action="store_true",
                    help="collective bytes by kind, result, frame, phase "
                         "and the sharding layer's site")
    ap.add_argument("--top", type=int, default=40,
                    help="rows of --dots', --collectives' and --peak's "
                         "tables")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced configuration")
    args = ap.parse_args(argv)

    regions: dict = {}
    _timers(regions)
    kept: dict = {}
    counter_cls = dryrun.OpCounter
    if args.peak:
        counter_cls = _peak_counter(counter_cls)
    if args.dots:
        counter_cls = _dots_counter(counter_cls)
    if args.collectives:
        counter_cls = _collectives_counter(counter_cls)
    if args.dots or args.collectives:
        torch.autograd.set_detect_anomaly(True, check_nan=False)
    if counter_cls is not dryrun.OpCounter:
        trace = dryrun.trace_step

        def trace_step(*a, **k):
            dryrun.OpCounter = counter_cls
            kept["counter"], kept["args"] = trace(*a, **k)
            return kept["counter"], kept["args"]

        dryrun.trace_step = trace_step
    base = SHAPES[args.shape]
    shape = ShapeSpec(args.shape, args.seq_len or base.seq_len,
                      args.batch or base.global_batch, base.step)
    r = dryrun.run_cell(args.arch, args.shape, args.multi_pod,
                        device=args.device, shape=shape,
                        mesh_shape=dryrun._dims(args.mesh),
                        reduced=args.reduced, fold=not args.no_fold)
    out = {k: r[k] for k in ("arch", "shape", "mesh", "accum", "trace_s",
                             "bytes_per_device", "arg_bytes",
                             "hlo_dot_flops_per_device",
                             "collective_bytes_per_device", "collectives")}
    out.update(seq_len=shape.seq_len, fold=not args.no_fold,
               regions_s=regions)
    if args.peak:
        c = kept["counter"]
        op, where, keys = c.at_peak
        by_op, by_shape = collections.Counter(), collections.Counter()
        for key in keys:
            made_by, node, nbytes, desc = c.made[key]
            by_op[f"{made_by} @ {node}"] += nbytes
            by_shape[f"{made_by} {desc}"] += nbytes
        out["peak"] = {"at": f"{op} @ {where}",
                       "by_op": by_op.most_common(args.top),
                       "by_shape": by_shape.most_common(args.top)}
    if args.dots:
        by_dot = kept["counter"].by_dot
        total = sum(by_dot.values())
        out["dots_total"] = total
        out["dots"] = [[flops, flops / total if total else 0.0, *key]
                       for key, flops in by_dot.most_common(args.top)]
    if args.collectives:
        by = kept["counter"].by_collective
        total = sum(by.values())
        out["collectives_total"] = total
        out["collectives_by_site"] = [
            [nbytes, nbytes / total if total else 0.0, *key]
            for key, nbytes in by.most_common(args.top)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
