"""Sharding policy: parameter/optimizer/batch/cache specs — the port of
``repro/launch/sharding.py``, for DTensor placements.

Policy (MaxText-style FSDP+TP):
  * "model" axis = tensor parallel: attention heads, FFN hidden, MoE
    experts, vocab.
  * batch axes ("pod","data") = FSDP: every weight is additionally
    sharded on its largest remaining dim; optimizer moments inherit the
    param spec => ZeRO-3.
  * activations: batch over ("pod","data"); for batch-1 decode cells the
    KV-cache sequence dim takes the batch axes instead (sequence
    parallelism over the cache).

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dimension: ``None``, an axis name, or a tuple of names
(``tuple(P(...))`` compares equal to it).  ``to_placements`` turns a
tree of specs into one DTensor placement a mesh dimension.  The specs
need only the mesh's axis names and sizes: a ``DeviceMesh`` or a
stand-in whose ``shape`` is ``{axis: size}`` and ``axis_names`` the
names, as the reference's tests use.

Every rule is divisibility-guarded: if a dim doesn't divide by the axis
size the axis is dropped (e.g. seamless's vocab 256206 is indivisible by
16 — its embedding shards on d_model instead).  Rules are name-based:
the reference's regexes on the port's parameter names with ``.`` read
as ``/`` (``layers.3.attn.wq`` -> ``layers/3/attn/wq``); unknown leaves
fall back to greedy largest-dim assignment.  The port keeps one module a
layer (``models/convert.py``), so no leaf carries the reference's
scanned group dimension and nothing is skipped for it.
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.partitioning import axis_sizes, placements_of


def _axis_size(sizes: dict, axes) -> int:
    if axes is None or axes == ():
        return 1
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def _assign(shape, sizes: dict, prefs) -> tuple:
    """prefs: [(dim, [axis-candidates in priority order]), ...] —
    divisibility-guarded greedy assignment."""
    spec: list[Any] = [None] * len(shape)
    used: set[str] = set()
    for dim, candidates in prefs:
        if dim >= len(shape):
            continue
        for axes in candidates:
            flat = (axes,) if isinstance(axes, str) else tuple(axes)
            if not flat or any(a in used for a in flat):
                continue
            if shape[dim] % _axis_size(sizes, axes) == 0:
                # a one-name tuple reads as the name, as in PartitionSpec
                spec[dim] = flat[0] if len(flat) == 1 else axes
                used.update(flat)
                break
    return tuple(spec)


def _param_prefs(name: str, nd: int, fsdp, model, heads_ok=True, kv_ok=True):
    """Returns (dim, candidates) prefs for a parameter of ``nd`` dims.

    heads_ok/kv_ok: whether the (q / kv) head count divides the model
    axis — if not, the projection must NOT be sharded on its head dim
    (sharding head_dim instead would force per-tile all-gathers of the
    attention accumulators; MQA replicates KV instead)."""
    both = tuple((fsdp if isinstance(fsdp, tuple) else (fsdp,))) + (model,)
    if re.search(r"embed/table$", name):
        # (V, D): vocab->model, d->fsdp; indivisible vocab falls through
        # to sharding D over everything
        return [(0, [model]), (1, [fsdp, both])]
    if re.search(r"lm_head/w$", name):
        return [(1, [model]), (0, [fsdp])]
    if re.search(r"(attn|cross)/wq$", name):
        return [(1, [model]), (0, [fsdp])] if heads_ok else [(0, [fsdp])]
    if re.search(r"(attn|cross)/w[kv]$", name):
        return [(1, [model]), (0, [fsdp])] if kv_ok else [(0, [fsdp])]
    if re.search(r"(attn|cross)/wo$", name):
        return [(0, [model]), (1, [fsdp])] if heads_ok else [(1, [fsdp])]
    if re.search(r"(attn|cross)/bq$", name):
        return [(0, [model])] if heads_ok else []
    if re.search(r"(attn|cross)/b[kv]$", name):
        return [(0, [model])] if kv_ok else []
    if re.search(r"moe/router$", name):
        return [(0, [fsdp])]
    # Expert weights: experts -> model (EP) and the expert hidden dim ->
    # batch axes (TP-style), not FSDP on d_model: FSDP would all-gather
    # the full expert set 3×accum times per step (fwd/bwd/remat); sharding
    # F keeps weights resident and moves only (E,C,D) partial sums.
    if re.search(r"moe/(gate|up)$", name):          # (E, D, F)
        return [(0, [model]), (2, [fsdp])]
    if re.search(r"moe/down$", name):               # (E, F, D)
        return [(0, [model]), (1, [fsdp])]
    if re.search(r"(mlp|shared|dense)/(gate|up)$", name):
        return [(1, [model]), (0, [fsdp])]
    if re.search(r"(mlp|shared|dense)/down$", name):
        return [(0, [model]), (1, [fsdp])]
    if re.search(r"mamba/in_proj$", name):
        return [(1, [model]), (0, [fsdp])]
    if re.search(r"mamba/out_proj$", name):
        return [(0, [model]), (1, [fsdp])]
    if re.search(r"mamba/conv_[wb]$", name):
        return [(nd - 1, [model])]
    if re.search(r"mamba/(A_log|D|dt_bias)$", name):
        return [(0, [model])]
    if re.search(r"(mlstm/qkv|mlstm/ogate|slstm/wx)$", name):
        return [(1, [model]), (0, [fsdp])]
    if re.search(r"(mlstm|slstm)/out$", name):
        return [(0, [model]), (1, [fsdp])]
    if re.search(r"slstm/r$", name):                # (H, P, 4P)
        return [(2, [model]), (1, [fsdp])]
    if re.search(r"mlstm/gates$", name):
        return [(0, [fsdp])]
    if re.search(r"(norm|scale|bias)", name):
        return []
    # fallback: greedy largest dims
    return None


def _shapes(params) -> dict:
    """``{name: shape}`` of a module's parameters, or of a dict of
    tensors or shapes."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {n: tuple(getattr(v, "shape", v)) for n, v in params.items()}


def param_specs(cfg: ModelConfig, params_shape, mesh,
                fsdp_enabled: bool = True, attn_tp: bool = True) -> dict:
    """``{parameter name: spec}`` for a ``Model`` (or a dict of its
    parameters' tensors or shapes).

    fsdp_enabled=False (decode/serving): weights are sharded on the
    model axis only and *replicated* across the batch axes — a decode
    step touches every weight, so FSDP would re-gather the full model
    per generated token.
    """
    sizes = axis_sizes(mesh)
    fsdp = batch_axes(mesh) if fsdp_enabled else ()
    fsdp = fsdp[0] if len(fsdp) == 1 else fsdp
    model = "model"
    msize = sizes["model"]
    heads_ok = cfg.n_heads % msize == 0 and attn_tp
    kv_ok = cfg.n_kv_heads % msize == 0 and attn_tp

    def spec_for(name, shape):
        path = name.replace(".", "/")
        prefs = _param_prefs(path, len(shape), fsdp, model, heads_ok, kv_ok)
        if prefs is None:
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            prefs = []
            if order:
                prefs.append((order[0], [model]))
            if len(order) > 1:
                prefs.append((order[1], [fsdp]))
        return _assign(shape, sizes, prefs)

    return {n: spec_for(n, s) for n, s in _shapes(params_shape).items()}


def opt_state_specs(cfg: ModelConfig, pspecs) -> dict:
    """AdamW's moments take their parameter's spec; ``step`` is a host
    int."""
    return {"m": pspecs, "v": pspecs, "step": ()}


def batch_specs(batch_shape: dict, mesh) -> dict:
    """``{input name: spec}``: the leading (batch) dim over the batch
    axes, or over their inner suffix where the batch does not divide
    the product (batch 32 on ("pod","data") = 2×32 -> "data")."""
    sizes = axis_sizes(mesh)
    axes = batch_axes(mesh)

    def spec_for(shape):
        cand = axes
        while cand and (not shape or shape[0] % _axis_size(sizes, cand)):
            cand = cand[1:]
        if not cand:
            return ()
        return (cand if len(cand) > 1 else cand[0],)

    return {k: spec_for(tuple(getattr(v, "shape", v)))
            for k, v in batch_shape.items()}


def _cache_prefs(last: str, base, fsdp, fsdp_n: int) -> list:
    if last in ("k", "v", "ck", "cv"):              # (B, S, KV, hd)
        # batch -> fsdp axes (sequence for batch-1 long-context);
        # kv-heads -> model when divisible, else sequence -> model
        # (paired with attn_tp=False weights so attention einsums
        # never regather the cache)
        if base[0] % fsdp_n == 0:
            return [(0, [fsdp]), (2, ["model"]), (1, ["model"])]
        return [(1, [fsdp]), (2, ["model"]), (1, ["model"])]
    if last == "state":                              # mamba (B, H, P, N)
        return [(0, [fsdp]), (1, ["model"])]
    if last == "conv":                               # (B, K-1, conv_dim)
        return [(0, [fsdp]), (2, ["model"])]
    if last in ("c", "n", "h", "m"):                 # xlstm states
        return [(0, [fsdp])] + ([(2, ["model"])] if len(base) >= 3 else [])
    if last == "enc_out":                            # (B, S, D)
        return [(0, [fsdp]), (2, ["model"])]
    return []


def cache_specs(cfg: ModelConfig, cache_shape: dict, mesh) -> dict:
    """The port's cache (``decode.init_cache``: ``layers``, one entry a
    layer, ``shared``, ``enc_out``, ``pos``) with a spec in place of
    each tensor and ``()`` for the host int ``pos``.  KV caches:
    batch->fsdp axes when divisible, else sequence->fsdp
    (sequence-parallel cache for batch-1 long-context decode);
    kv-heads / ssm-heads -> model."""
    sizes = axis_sizes(mesh)
    fsdp = batch_axes(mesh)
    fsdp = fsdp[0] if len(fsdp) == 1 else fsdp
    fsdp_n = _axis_size(sizes, fsdp)

    def spec_for(last, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        shape = tuple(leaf.shape)
        return _assign(shape, sizes, _cache_prefs(last, shape, fsdp, fsdp_n))

    def entries(es):
        return [{k: spec_for(k, v) for k, v in e.items()} for e in es]

    out = {}
    for key, val in cache_shape.items():
        if key in ("layers", "shared"):
            out[key] = entries(val)
        else:
            out[key] = spec_for(key, val)
    return out


def to_placements(tree_specs, mesh):
    """The same tree with each spec as its DTensor placements on
    ``mesh`` (one ``Shard(d)`` or ``Replicate()`` a mesh dimension; a
    dim split over several axes shards in the spec's row-major order,
    which must be the mesh's)."""
    if isinstance(tree_specs, dict):
        return {k: to_placements(v, mesh) for k, v in tree_specs.items()}
    if isinstance(tree_specs, list):
        return [to_placements(v, mesh) for v in tree_specs]
    return placements_of(tree_specs, mesh.mesh_dim_names)
