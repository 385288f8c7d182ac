"""Executable: a compiled expression bound to (shape, dtype, backend,
device) — port of ``repro.api.executable``.

The run phase executes the lowered :class:`~repro_torch.api.lower.Program`
as **one padded program per plan group**: every canonical input is
padded to the group's :class:`~repro_torch.core.chain.ChainPlan` once,
all kernel segments run on the vertically stacked ``(N·H_pad, W_pad)``
working arrays (chains through ``chain_step``, fixed geodesic chains
through ``geodesic_chain_step``, reconstructions, the QDT and the gdt
through the requeue scheduler in ``kernels/ops.py`` — the gdt also
through its raster sweeps), and outputs are cropped once.
``refill`` segments re-pad in place where a consumer needs a different
absorbing identity.  Specialized mixed programs re-band between plan
groups exactly as the reference does.

``backend="torch"`` executes the same program with the
``core.morphology`` oracle bodies on unpadded tensors (the reference's
``"xla"`` engine) — bit-exact with the ``"cuda"`` engine.

The program is the one ``compile`` lowered: the optimizer's canonical
graph by default, the source graph with ``rewrite=False``.  The
reference's static verifier is not ported yet.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.api.lower import Program, eval_pointwise
from repro_torch.core import morphology as M
from repro_torch.core import operators as OPS
from repro_torch.core.backend import dtype_name
from repro_torch.kernels import ops as K
from repro_torch.kernels.common import fill_where, ident_for
from repro_torch.kernels.erode_chain import chain_step
from repro_torch.kernels.geodesic_chain import geodesic_chain_step

#: pad-fill name → the op whose lattice identity it is
_FILL_OP = {"hi": "erode", "lo": "dilate"}

#: op → the absorbing pad identity its operands need (dual of _FILL_OP)
_NEED_FILL = {"erode": "hi", "dilate": "lo"}


def _fill_value(fill: str, dtype):
    return ident_for(_FILL_OP[fill], dtype)


def _seg_need_fill(seg) -> str:
    """Pad identity ``seg`` expects of an operand re-entering padded
    form at a group boundary."""
    if seg.kind == "refill":
        return seg.param("fill")
    if seg.kind == "qdt":
        return "hi"  # the QDT iterates erosion
    if seg.kind in ("gdt", "point"):
        # gdt stages its own planes from −inf-marked operands; point
        # outputs are re-masked by a refill before any kernel consumer
        return "lo"
    return _NEED_FILL[seg.param("op")]


class Executable:
    """A lowered program bound to a concrete (N, H, W)/dtype/backend/
    device.

    Call it with the expression's input tensors (or arrays; they move to
    the executable's device) in ``program.input_names`` order to run
    prepare → run → finalize; ``run_batch`` runs the run phase alone on
    canonical inputs.  ``stats()`` reports the static pad/launch/refill
    accounting of the compiled program, key for key as the reference's.
    ``seg_plans`` activates per-group plan specialization: a tuple of
    ``(segment_indices, ChainPlan)`` groups covering the segments.
    ``rewrite_trace`` carries the optimizer's
    :class:`~repro_torch.opt.engine.Applied` steps for this program
    (empty when compiled with ``rewrite=False`` or nothing fired).
    """

    def __init__(self, program: Program, shape3: tuple, dtype, backend: str,
                 plan, max_chunks: int | None, was_2d: bool, device, *,
                 seg_plans=None, rewrite_trace=()):
        self.program = program
        self.n_images, self.height, self.width = shape3
        self.dtype = dtype
        self.backend = backend
        self.plan = plan
        self.max_chunks = max_chunks
        self.was_2d = was_2d
        self.device = torch.device(device)
        self.seg_plans = tuple(seg_plans) if seg_plans else None
        self.rewrite_trace = tuple(rewrite_trace)
        self._mask_cache: dict = {}
        seg_key = (tuple((idxs, p.key) for idxs, p in self.seg_plans)
                   if self.seg_plans is not None else None)
        # every field that can change what a call computes or returns;
        # ``rewrite_trace`` is provenance, not behaviour: the program it
        # produced is already keyed
        self.key = (
            program.run_sig, shape3, dtype_name(dtype), backend,
            plan.key if plan is not None else None,
            max_chunks, was_2d, seg_key, str(self.device),
        )

    # -- public ------------------------------------------------------------

    def __call__(self, *arrays, **named):
        names = self.program.input_names
        if named:
            if arrays:
                raise TypeError("pass inputs positionally or by name, "
                                "not both")
            try:
                arrays = tuple(named.pop(n) for n in names)
            except KeyError as e:
                raise TypeError(f"missing input {e.args[0]!r}") from None
            if named:
                raise TypeError(f"unknown inputs {sorted(named)} "
                                f"(expected {list(names)})")
        if len(arrays) != len(names):
            raise TypeError(
                f"expression takes {len(names)} input(s) {list(names)}, "
                f"got {len(arrays)}"
            )
        outs = self._pipeline(*(self._check(a) for a in arrays))
        return outs[0] if self.program.n_outputs == 1 else outs

    def run_batch(self, *canonical):
        """Run phase only: canonical (N, H, W) inputs → cropped run
        outputs (always a tuple)."""
        return self._run_segments(*canonical)

    def run_batch_stats(self, *canonical):
        """Run phase plus the convergence watchdog's verdict and chunk
        utilization: ``(outputs, converged, busy_chunks, cap_chunks)``.
        ``converged`` is a (N,) bool tensor, False for images whose
        reconstruction, QDT or gdt exhausted the chunk budget;
        ``busy_chunks`` / ``cap_chunks`` count the scheduler chunks the
        images consumed vs the chunks the batch held every image for
        (both 0 without a convergence-driven segment, and for the oracle
        engine, which iterates to its own fixpoint)."""
        all_ok = torch.ones((self.n_images,), dtype=torch.bool)
        if self.plan is None:
            return self._run_torch(canonical), all_ok, 0, 0
        conv: list = []
        util: list = []
        outs = self._run_padded(canonical, conv, util)
        for vec in conv:
            all_ok = all_ok & vec
        return (outs, all_ok, sum(b for b, _ in util),
                sum(c for _, c in util))

    @property
    def all_plans(self) -> tuple:
        """Every ChainPlan this executable runs under (primary first)."""
        if self.seg_plans is not None:
            return tuple(p for _, p in self.seg_plans)
        return (self.plan,) if self.plan is not None else ()

    def stats(self) -> dict:
        """Static accounting of the compiled program, as the reference
        reports it: pad/crop round-trips of one execution, kernel-segment
        launches, refills, fused chain length, plan groups and re-bands,
        and the chunk budgets the convergence watchdog runs under."""
        prog = self.program
        groups = self._exec_groups
        return {
            "backend": self.backend,
            "pads": sum(len(pads) for _, _, pads, _ in groups),
            "crops": sum(len(crops) for _, _, _, crops in groups),
            "launches": len(prog.kernel_segments),
            "refills": sum(1 for s in prog.segments if s.kind == "refill"),
            "fused_chain_len": prog.fused_chain_len,
            "plan_key": self.plan.key if self.plan is not None else None,
            "plans": len(groups),
            "rebands": max(0, len(groups) - 1),
            "convergent": prog.convergent,
            "chunk_budget_rec": (self._budget_rec(self.plan)
                                 if self.plan is not None else None),
            "chunk_budget_qdt": (self._budget_qdt(self.plan)
                                 if self.plan is not None else None),
        }

    def __repr__(self):
        return (f"Executable({self.program.sig_label()}, "
                f"shape=({self.n_images}, {self.height}, {self.width}), "
                f"dtype={dtype_name(self.dtype)}, backend={self.backend!r}, "
                f"device={str(self.device)!r})")

    # -- internals ---------------------------------------------------------

    def _check(self, a) -> torch.Tensor:
        a = torch.as_tensor(a, device=self.device)
        want = ((self.height, self.width) if self.was_2d
                else (self.n_images, self.height, self.width))
        if tuple(a.shape) != want:
            raise ValueError(
                f"input shape {tuple(a.shape)} does not match the compiled "
                f"shape {want}"
            )
        if a.dtype != self.dtype:
            raise ValueError(
                f"input dtype {a.dtype} does not match the compiled "
                f"dtype {self.dtype}"
            )
        return a

    def _budget_rec(self, plan) -> int:
        return (self.max_chunks if self.max_chunks is not None
                else (self.height * self.width) // plan.fuse_k + 2)

    def _budget_qdt(self, plan) -> int:
        return (self.max_chunks if self.max_chunks is not None
                else max(self.height, self.width) // plan.fuse_k + 2)

    def _pipeline(self, *inputs):
        prog = self.program
        env = dict(zip(prog.input_names, inputs))
        canonical = [eval_pointwise(e, env, {}, {}) for e in prog.prepare]
        cropped = self._run_segments(*canonical)
        kernel_vals = {
            (node, i): cropped[j]
            for j, (node, i, _) in enumerate(prog.kernel_outputs)
        }
        memo = {}
        return tuple(eval_pointwise(e, env, kernel_vals, memo)
                     for e in prog.result_exprs())

    def _run_segments(self, *canonical):
        if self.plan is None:
            return self._run_torch(canonical)
        return self._run_padded(canonical)

    # -- torch engine: the oracle bodies, unpadded -------------------------

    def _run_torch(self, canonical):
        vals = dict(zip(self.program.run_input_slots, canonical))
        for seg in self.program.segments:
            if seg.kind == "refill":       # no padding exists to refill
                vals[seg.dsts[0]] = vals[seg.srcs[0]]
            elif seg.kind == "chain":
                body = M.erode if seg.param("op") == "erode" else M.dilate
                vals[seg.dsts[0]] = body(vals[seg.srcs[0]], seg.param("n"))
            elif seg.kind == "geodesic":
                step = (M.geodesic_erode if seg.param("op") == "erode"
                        else M.geodesic_dilate)
                vals[seg.dsts[0]] = step(vals[seg.srcs[0]],
                                         vals[seg.srcs[1]], seg.param("n"))
            elif seg.kind == "reconstruct":
                rec = (M.erode_reconstruct if seg.param("op") == "erode"
                       else M.dilate_reconstruct)
                vals[seg.dsts[0]] = rec(vals[seg.srcs[0]], vals[seg.srcs[1]])
            elif seg.kind == "qdt":
                vals[seg.dsts[0]], vals[seg.dsts[1]] = OPS.qdt_raw(
                    vals[seg.srcs[0]])
            elif seg.kind == "gdt":
                # Jacobi advances every shortest path by at least one
                # edge per iteration; H·W bounds any simple path
                vals[seg.dsts[0]] = K.gdt_fixpoint(
                    vals[seg.srcs[0]], vals[seg.srcs[1]], seg.param("lamb"),
                    seg.param("nu"), self.height * self.width + 2)
            elif seg.kind == "point":
                env = {f"__p{j}": vals[s]
                       for j, s in enumerate(seg.srcs)}
                vals[seg.dsts[0]] = eval_pointwise(
                    seg.param("expr"), env, {}, {})
            else:  # pragma: no cover - compile() refuses other kinds
                raise AssertionError(seg.kind)
        return tuple(vals[s] for s in self.program.run_outputs)

    # -- cuda engine: one padded program per plan group --------------------

    @property
    def _groups(self) -> tuple:
        """``(segment_indices, plan)`` plan groups, in execution order."""
        if self.seg_plans is not None:
            return self.seg_plans
        if self.plan is None:
            return ()
        return ((tuple(range(len(self.program.segments))), self.plan),)

    @functools.cached_property
    def _exec_groups(self) -> tuple:
        """Static execution schedule: per group, the ``(slot, fill)``
        pads to apply on entry (first-consume order) and the dst slots
        to crop back to unpadded form on exit (consumed by a later
        group, or a run output)."""
        prog = self.program
        segs = prog.segments
        groups = self._groups
        fill_state: dict = dict(zip(prog.run_input_slots, prog.run_fills))
        for seg in segs:
            for d in seg.dsts:
                fill_state[d] = (seg.param("fill") if seg.kind == "refill"
                                 else None)
        out = []
        for gi, (idxs, plan) in enumerate(groups):
            local: set = set()
            pad_map: dict = {}
            for i in idxs:
                seg = segs[i]
                for s in seg.srcs:
                    if s in local or s in pad_map:
                        continue
                    pad_map[s] = fill_state.get(s) or _seg_need_fill(seg)
                local.update(seg.dsts)
            later: set = set(prog.run_outputs)
            for idxs2, _ in groups[gi + 1:]:
                for i in idxs2:
                    later.update(segs[i].srcs)
            crops = tuple(d for i in idxs for d in segs[i].dsts
                          if d in later)
            out.append((tuple(idxs), plan, tuple(pad_map.items()), crops))
        return tuple(out)

    def _image_mask(self, plan):
        """(TOTAL_H, W_pad) bool: True inside the real image regions."""
        mask = self._mask_cache.get(plan.key)
        if mask is None:
            rows = (torch.arange(plan.n_images * plan.height_pad,
                                 device=self.device)
                    % plan.height_pad) < self.height
            cols = torch.arange(plan.width_pad,
                                device=self.device) < self.width
            mask = rows[:, None] & cols[None, :]
            self._mask_cache[plan.key] = mask
        return mask

    def _run_padded(self, canonical, conv: list | None = None,
                    util: list | None = None):
        prog = self.program
        vals3 = {
            slot: (x[None] if x.ndim == 2 else x)
            for slot, x in zip(prog.run_input_slots, canonical)
        }
        for idxs, plan, pads, crops in self._exec_groups:
            vals2 = {}
            for s, fill in pads:
                x3 = vals3[s]
                vals2[s] = K._stacked(K._pad(x3, plan,
                                             _fill_value(fill, x3.dtype)))
            for i in idxs:
                self._cuda_seg(prog.segments[i], vals2, plan, conv, util)
            for d in crops:
                vals3[d] = K._crop3(vals2[d], self.n_images, self.height,
                                    self.width)
        outs = tuple(vals3[s] for s in prog.run_outputs)
        return tuple(o[0] if self.was_2d else o for o in outs)

    def _cuda_seg(self, seg, vals, plan, conv: list | None = None,
                  util: list | None = None):
        if seg.kind == "refill":
            x2 = vals[seg.srcs[0]]
            vals[seg.dsts[0]] = fill_where(
                ~self._image_mask(plan), x2,
                _fill_value(seg.param("fill"), x2.dtype))
        elif seg.kind == "chain":
            vals[seg.dsts[0]] = self._chain2(
                vals[seg.srcs[0]], seg.param("op"), seg.param("n"), plan)
        elif seg.kind == "geodesic":
            vals[seg.dsts[0]] = self._geodesic2(
                vals[seg.srcs[0]], vals[seg.srcs[1]],
                seg.param("op"), seg.param("n"), plan)
        elif seg.kind == "reconstruct":
            out, it, _, _, img_conv, state = K._scheduled_reconstruct(
                vals[seg.srcs[0]], vals[seg.srcs[1]], plan,
                seg.param("op"), self._budget_rec(plan), False,
            )
            vals[seg.dsts[0]] = out
            if conv is not None:
                conv.append(img_conv)
            if util is not None:
                # busy = chunks each image consumed; capacity = chunks
                # the batch held every image for
                util.append((int(state[1].sum()), it * plan.n_images))
        elif seg.kind == "qdt":
            _, r, d, img_conv, state = K._scheduled_qdt(
                vals[seg.srcs[0]], plan, self._budget_qdt(plan))
            vals[seg.dsts[0]], vals[seg.dsts[1]] = d, r
            if conv is not None:
                conv.append(img_conv)
            if util is not None:
                # capacity: the longest image's chunks, for every image
                util.append((int(state[1].sum()),
                             int(state[1].max()) * plan.n_images))
        elif seg.kind == "gdt":
            d0, ip, sp = K.gdt_stage(vals[seg.srcs[0]], vals[seg.srcs[1]],
                                     seg.param("nu"))
            lamb, budget = seg.param("lamb"), self._budget_rec(plan)
            if plan.schedule == "raster":
                d, rounds, img_conv = K._raster_gdt(d0, ip, sp, plan, lamb,
                                                    budget)
                if util is not None:
                    # the sweeps run every image every round: no slack
                    util.append((rounds * plan.n_images,
                                 rounds * plan.n_images))
            else:
                d, img_conv, state = K._scheduled_gdt(d0, ip, sp, plan, lamb,
                                                      budget)
                if util is not None:
                    util.append((int(state[1].sum()),
                                 int(state[1].max()) * plan.n_images))
            vals[seg.dsts[0]] = d
            if conv is not None:
                conv.append(img_conv)
        elif seg.kind == "point":
            env = {f"__p{j}": vals[s] for j, s in enumerate(seg.srcs)}
            vals[seg.dsts[0]] = eval_pointwise(seg.param("expr"), env, {}, {})
        else:  # pragma: no cover - compile() refuses other kinds
            raise AssertionError(seg.kind)

    def _chain2(self, x2, op, n, plan):
        # the remainder past the full K-chunks runs on the kernel too, at
        # smaller K (``chain_chunks``); the reference runs it on its oracle
        for k in K.chain_chunks(n, plan):
            x2 = chain_step(x2, op=op, fuse_k=k, band_h=plan.band_h,
                            bands_per_image=plan.n_bands)
        return x2

    def _geodesic2(self, f2, m2, op, n, plan):
        for k in K.chain_chunks(n, plan):
            f2, _ = geodesic_chain_step(
                f2, m2, op=op, fuse_k=k, band_h=plan.band_h,
                bands_per_image=plan.n_bands)
        return f2
