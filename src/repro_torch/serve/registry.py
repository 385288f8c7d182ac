"""Operator registry: every servable op is an expression, and its
pipeline stages are *derived* from the lowered program (port of
``repro.serve.registry``; the same names, schemas and derivation).

The implementations stay where they live — ``core.operators``,
``kernels.ops`` and ``gdt`` each export a ``SERVE_OPS`` hook tuple
(name + param schema + expression builder next to the code).  This
module lowers the expression (``repro_torch.api.lower``) and reads the
three pipeline stages off the
:class:`~repro_torch.api.lower.Program` mechanically:

``prepare``
    the program's prepare exprs, evaluated per-request on the
    *unpadded* images as CPU tensors on the host — marker derivation
    (so per-image reductions like ``hfill_marker``'s interior max never
    see bucket padding), staged into the bucket's host buffer;
``run``
    the program's run phase, compiled per bucket via
    ``repro_torch.api.compile`` — the serve cache key **is**
    ``Executable.key`` (lowered run signature + bucket shape/dtype/
    backend + plan key + device), the same object the compile cache
    uses;
``finalize``
    the program's finalize region, evaluated per request on the cropped
    run outputs on the service's device (DOME's ``f - hmax``, the QDT
    η-regularization).

Pad-to-bucket safety is derived too: single-kernel-segment programs are
pad-safe under their lowered fills; multi-phase programs (ASF,
opening-by-reconstruction) get exact-shape buckets (see
``docs/ARCHITECTURE.md`` for the exactness argument).

Because the bucket identity is the lowered *run signature* rather than
the op name, different operators whose run phases coincide — HMAX,
DOME and RAOBJ are all one dilate-reconstruction — co-batch into one
compiled bucket program (cross-op bucket packing).

Custom :class:`OpSpec` objects with a hand-written ``run`` callable are
still accepted by :func:`register` (tests and extensions use this);
they bucket by (name, params) as before.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.api.expr import KERNEL_KINDS
from repro_torch.api.lower import eval_pointwise, lower
from repro_torch.opt import rewrite_traced

_TYPES = {"int": int, "float": float, "str": str}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Schema for one operator parameter (declared as data in the hooks)."""

    type: str = "float"
    default: Any = None
    required: bool = False
    choices: tuple | None = None
    min: Any = None

    def coerce(self, op: str, name: str, value):
        try:
            value = _TYPES[self.type](value)
        except (TypeError, ValueError):
            raise ValueError(
                f"op {op!r}: param {name!r} expects {self.type}, got {value!r}"
            ) from None
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"op {op!r}: param {name!r} must be one of {self.choices}, "
                f"got {value!r}"
            )
        if self.min is not None and value < self.min:
            raise ValueError(
                f"op {op!r}: param {name!r} must be >= {self.min}, "
                f"got {value!r}"
            )
        return value

    def sample(self):
        """A representative value (used once at registration to derive
        arity/outputs from the lowered sample expression)."""
        if self.default is not None:
            return self.default
        if self.choices:
            return self.choices[0]
        if self.type == "int":
            return max(1, self.min or 1)
        if self.type == "float":
            return float(self.min) if self.min is not None else 1.0
        return ""


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """A servable operator: expression-derived or custom.

    For expression ops only ``name``/``params``/``expr_builder`` are
    declared; everything else is derived from the lowered program.  The
    remaining fields exist for custom (hand-written ``run``) specs.
    """

    name: str
    params: Mapping[str, ParamSpec]
    expr_builder: Callable | None = None   # params dict -> Expr
    run: Callable | None = None    # custom: (inputs, params, backend, plan)
    arity: int = 1           # image inputs per request (user-facing)
    n_inputs: int | None = None  # canonical inputs after prepare (None=arity)
    n_outputs: int = 1
    dtypes: str = "uif"      # supported NumPy dtype kinds
    pad_safe: bool = True
    pad_fills: Callable | None = None      # params dict -> ("hi"|"lo", ...)
    prepare: Callable | None = None        # custom per-request stage
    finalize: Callable | None = None       # custom: (out, images, params)
    plan_builder: Callable | None = None   # custom: (n, h, w, dtype, params)

    def canonical_params(self, params: Mapping | None) -> tuple:
        """Validate + normalize params into a sorted hashable tuple
        (the form bucket and cache keys embed)."""
        given = dict(params or {})
        out = []
        for name in sorted(self.params):
            spec = self.params[name]
            if name in given:
                val = spec.coerce(self.name, name, given.pop(name))
            elif spec.required:
                raise ValueError(
                    f"op {self.name!r}: missing required param {name!r}"
                )
            else:
                val = spec.default
            out.append((name, val))
        if given:
            raise ValueError(
                f"op {self.name!r}: unknown params {sorted(given)} "
                f"(schema: {sorted(self.params)})"
            )
        return tuple(out)

    def build_expr(self, canon: tuple):
        return self.expr_builder(dict(canon))

    def prepare_inputs(self, images: tuple, params: tuple) -> tuple:
        """Per-request prepare stage on the unpadded images (NumPy
        arrays), evaluated on the host as CPU tensors."""
        if self.expr_builder is not None:
            info = request_info(self.name, params)
            env = dict(zip(info.program.input_names,
                           (torch.from_numpy(np.ascontiguousarray(im))
                            for im in images)))
            memo: dict = {}
            return tuple(eval_pointwise(e, env, {}, memo)
                         for e in info.program.prepare)
        if self.prepare is None:
            return images
        return self.prepare(images, dict(params))


@dataclasses.dataclass(frozen=True)
class RunInfo:
    """Everything the service needs to bucket/stage one request."""

    expr: Any                # canonical (rewritten) Expr; None for custom
    program: Any             # lowered Program (None for custom)
    sig: tuple               # bucket identity of the run phase
    label: str               # human tag for metrics bucket labels
    n_inputs: int            # canonical run inputs to stage
    n_outputs: int
    fills: tuple             # "hi"/"lo" per canonical input
    pad_safe: bool
    source: Any = None       # pre-rewrite Expr (None for custom)
    n_rewrites: int = 0      # optimizer rules applied to reach ``expr``


@functools.lru_cache(maxsize=2048)
def request_info(op: str, canon: tuple) -> RunInfo:
    """Derive (and memoize) the staging/bucketing info for one
    (op, canonical params) pair."""
    spec = get(op)
    if spec.expr_builder is None:
        n_inputs = spec.n_inputs or spec.arity
        fills = (tuple(spec.pad_fills(dict(canon))) if spec.pad_fills
                 else ("hi",) * n_inputs)
        p = ",".join(f"{k}={v}" for k, v in canon if v is not None)
        return RunInfo(
            expr=None, program=None, sig=("custom", spec.name, canon),
            label=f"{spec.name}({p})" if p else spec.name,
            n_inputs=n_inputs, n_outputs=spec.n_outputs, fills=fills,
            pad_safe=spec.pad_safe,
        )
    source = spec.build_expr(canon)
    # canonicalize with the expression optimizer so staging, bucketing
    # and compilation all see one graph — ``api.compile`` re-derives
    # the same canonical form (memoized), so the compiled program's
    # prepare/fills match what is staged here
    rewritten = rewrite_traced(source)
    expr = rewritten.expr
    prog = lower(expr)
    return RunInfo(
        expr=expr, program=prog, sig=prog.run_sig, label=prog.sig_label(),
        n_inputs=len(prog.run_fills), n_outputs=prog.n_outputs,
        fills=prog.run_fills, pad_safe=prog.pad_safe,
        source=source, n_rewrites=rewritten.n_applied,
    )


@functools.lru_cache(maxsize=2048)
def request_finalize(op: str, canon: tuple) -> Callable | None:
    """Per-request finalize callable ``(outputs, images) -> outputs``,
    or None when the run outputs are the results (identity)."""
    spec = get(op)
    if spec.expr_builder is None:
        if spec.finalize is None:
            return None

        def legacy(outs, images, _spec=spec, _canon=canon):
            return tuple(_spec.finalize(o, images, dict(_canon))
                         for o in outs)

        return legacy
    prog = request_info(op, canon).program
    if prog.expr.kind in KERNEL_KINDS:
        return None  # root is the kernel output itself

    def finalize(outs, images, _prog=prog):
        kernel_vals = {
            (node, i): outs[j]
            for j, (node, i, _) in enumerate(_prog.kernel_outputs)
        }
        env = dict(zip(_prog.input_names, images))
        memo: dict = {}
        return tuple(eval_pointwise(e, env, kernel_vals, memo)
                     for e in _prog.result_exprs())

    return finalize


def _specs(op_name: str, schema: Mapping) -> dict[str, ParamSpec]:
    return {name: ParamSpec(**field) for name, field in schema.items()}


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, OpSpec] = {}


def register(spec: OpSpec) -> OpSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"op {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> OpSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown op {name!r}; registered: {', '.join(names())}"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _from_hook(hook) -> OpSpec:
    """Build an OpSpec from a SERVE_OPS hook: lower a sample expression
    once to derive the shape of the op (arity, outputs, pad-safety)."""
    params = _specs(hook["name"], hook["params"])
    sample = {name: p.sample() for name, p in params.items()}
    prog = lower(hook["expr"](sample))
    # gdt iterates a float distance lattice — programs containing it
    # only compile for float dtypes (see api/compile.py's gate)
    dtypes = ("f" if any(s.kind == "gdt" for s in prog.segments)
              else "uif")
    return OpSpec(
        name=hook["name"], params=params, expr_builder=hook["expr"],
        arity=len(prog.input_names), n_inputs=len(prog.run_fills),
        n_outputs=prog.n_outputs, dtypes=dtypes, pad_safe=prog.pad_safe,
    )


def _install_hooks():
    from repro_torch import gdt as G
    from repro_torch.core import operators as OPS
    from repro_torch.kernels import ops as K

    for hook in (*K.SERVE_OPS, *OPS.SERVE_OPS, *G.SERVE_OPS):
        register(_from_hook(hook))


_install_hooks()
