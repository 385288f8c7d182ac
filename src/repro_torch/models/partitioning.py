"""Activation-sharding constraints (logical axes -> mesh axes) on DTensor
— the port of ``repro/models/partitioning.py``.

The reference marks intermediates with ``with_sharding_constraint`` so
that XLA's propagation does not replicate what it cannot infer.  Here a
sharded trace is a DTensor program (``repro_torch.launch.dryrun``): the
parameters and inputs are DTensors on a ``DeviceMesh``, each op
propagates placements by its sharding rule, and ``constrain``
redistributes a tensor to the placements the reference's
``PartitionSpec`` names, and its gradient on the way back, as the
reference's constraint constrains the cotangent.  Where DTensor has no
rule for an op, the model code runs it on each rank's shard through a
stand-in below.  The launcher installs a policy (mesh + batch axes);
model code marks intermediates with logical dims:

    x = constrain(x, ("batch", None, "model"))

Every placement decision of the port lives in this module: the model
code calls ``constrain`` and the named stand-ins below (per-shard
loops, vocab lookups, the MoE's dispatch and combine, the attention
cache's placement and writes) and never reads a placement itself.
Each is a no-op without a policy.

Every constraint is divisibility-guarded: a logical axis whose dim size
doesn't divide the mesh-axis size is dropped (e.g. MQA's single KV head
is replicated rather than sharded).  Without an installed policy (unit
tests, single-device runs), or on a plain tensor, ``constrain`` is a
no-op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

#: the installed policy and loop folder: one a process, not one a
#: thread, because the autograd engine runs a CUDA backward (and the
#: recompute of a checkpointed region) on a thread of its own
_STATE = {"policy": None, "folder": None}

#: a free dimension's spec entry: keep whatever placement it has (the
#: reference's ``P.UNCONSTRAINED``; DTensor has no such placement).
FREE = "<free>"


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of a stand-in whose
    ``shape`` is already that dict (as the reference's tests build)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Policy:
    mesh: Any
    batch_axes: tuple    # mesh axes used for batch/fsdp
    model_axis: str = "model"

    def axis_size(self, logical: str) -> int:
        sizes = axis_sizes(self.mesh)
        if logical == "batch":
            return math.prod(sizes[a] for a in self.batch_axes)
        if logical == "model":
            return sizes[self.model_axis]
        return 1

    def mesh_axes(self, logical: str):
        if logical == "batch":
            return (self.batch_axes if len(self.batch_axes) > 1
                    else self.batch_axes[0])
        if logical == "model":
            return self.model_axis
        return None


def set_policy(policy: Policy | None):
    _STATE["policy"] = policy


def get_policy() -> Policy | None:
    return _STATE["policy"]


class apply_policy:
    """Context manager used by launchers around a sharded trace."""

    def __init__(self, policy: Policy | None):
        self.policy = policy

    def __enter__(self):
        self.prev = get_policy()
        set_policy(self.policy)
        return self.policy

    def __exit__(self, *exc):
        set_policy(self.prev)


def set_folder(folder) -> None:
    """Install (or, with ``None``, remove) the object whose
    ``fold(body, n)`` runs ``scan``'s loops: the dry run's op counter
    (``launch.op_count.OpCounter(fold=True)``) while it counts."""
    _STATE["folder"] = folder


def scan(body, n: int):
    """``carry = None; for i in range(n): carry, out = body(i, carry)``
    -> (the last carry, the ``n`` outputs in order): the reference's
    ``lax.scan`` over the microbatches, SSD and mLSTM chunks and sLSTM
    tokens.  The first trip gets ``None`` and makes the initial carry.

    Every trip runs, unless a folder is installed (``set_folder``) and
    ``n`` ≥ 5: then the folder runs trips 0, 1, 2 and n − 1 and counts
    trip 2 n − 3 times, for itself and the trips it skips (the
    reference's ``hlo_parse`` counts a ``while`` body once and
    multiplies it by its trip count)."""
    folder = _STATE["folder"]
    if folder is not None and n >= 5:
        return folder.fold(body, n)
    carry, outs = None, []
    for i in range(n):
        carry, out = body(i, carry)
        outs.append(out)
    return carry, outs


def spec_of(pol: Policy, dims, shape, free: bool = False) -> tuple:
    """The reference's ``PartitionSpec`` for logical ``dims`` over
    ``shape``, as a tuple: ``None``, an axis name, a tuple of names, or
    ``FREE`` (``free=True``'s unpinned dims)."""
    if len(dims) != len(shape):
        raise ValueError(f"dims {dims} vs shape {tuple(shape)}")
    sizes = axis_sizes(pol.mesh)
    fill = FREE if free else None
    used = set()
    spec = []
    for d, size in zip(dims, shape):
        if d is None or d in used:
            spec.append(fill)
            continue
        if d == "batch":
            # suffix fallback: a batch smaller than the full batch-axes
            # product still shards over the inner axes (e.g. global
            # batch 32 on ("pod","data")=64 -> shard over "data")
            axes = pol.batch_axes
            while axes and size % math.prod(sizes[a] for a in axes):
                axes = axes[1:]
            if not axes:
                spec.append(fill)
                continue
            spec.append(axes if len(axes) > 1 else axes[0])
            used.add(d)
        elif size % pol.axis_size(d) == 0:
            spec.append(pol.mesh_axes(d))
            used.add(d)
        else:
            spec.append(fill)
    return tuple(spec)


def placements_of(spec, mesh_dim_names, current=None) -> list:
    """One placement a mesh dimension for ``spec`` (a ``PartitionSpec``
    as a tuple): ``Shard(d)`` where tensor dim ``d`` names that mesh
    axis, else ``Replicate()`` — or, where ``current`` is given, the
    mesh dimension's current placement if ``spec`` is ``FREE`` on the
    tensor dim it shards, or if it is not a ``Shard`` at all (a pending
    ``Partial`` under a free spec).

    A tensor dim split over several axes shards in the spec's row-major
    order; DTensor splits a dim over several mesh dims in mesh order, so
    the spec must name them in mesh order (``ValueError`` otherwise)."""
    names = list(mesh_dim_names)
    out: list = [Replicate()] * len(names)
    claimed = set()
    for d, entry in enumerate(spec):
        if entry is None or entry == FREE:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} names its axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
            claimed.add(i)
    if current is not None:
        for i, p in enumerate(current):
            if i in claimed:
                continue
            if isinstance(p, Shard):
                if p.dim < len(spec) and spec[p.dim] == FREE:
                    out[i] = p
            elif not isinstance(p, Replicate) and FREE in spec:
                out[i] = p
    return out


def _pin(x: DTensor, spec: tuple) -> DTensor:
    """``x`` on ``spec``'s placements (``FREE`` dims as they are), each
    pending sum reduced in ``_reduce_placed``'s order."""
    free = FREE in spec
    want = tuple(placements_of(spec, x.device_mesh.mesh_dim_names,
                               x.placements if free else None))
    return _reduce_placed(x, want)


class _Constrain(torch.autograd.Function):
    """The value and its gradient both on ``spec``'s placements: the
    transpose of ``with_sharding_constraint`` puts the same constraint on
    the cotangent.  DTensor's own ``redistribute`` takes the gradient
    from wherever it arrives to the input's placements, which leaves the
    backward's placements to DTensor's op-by-op choice.  ``spec`` None
    keeps the value as it is and places the gradient as the value is
    (``hold``)."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        if spec is None:
            ctx.want = tuple(Replicate() if p.is_partial() else p
                             for p in x.placements)
            return x.view_as(x)
        y = _pin(x, spec)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            g = (_reduce_placed(g, ctx.want) if ctx.spec is None
                 else _pin(g, ctx.spec))
        return g, None


def _pinnable(x) -> bool:
    return (get_policy() is not None and isinstance(x, DTensor)
            and x.requires_grad and torch.is_grad_enabled())


def hold(x):
    """``x`` as it is, its gradient brought back to ``x``'s placements
    (a pending sum replicated) before it passes on: in front of a
    reshape whose gradient arrives placed where DTensor cannot undo the
    reshape (a merged dim split where its heads do not divide)."""
    return _Constrain.apply(x, None) if _pinnable(x) else x


def constrain(x, dims, free: bool = False):
    """dims: per-axis logical name ("batch" | "model" | None).

    free=True leaves unpinned dims as they are placed (the reference's
    UNCONSTRAINED: XLA may shard them as it likes) instead of forcing
    replication — used for tensors whose best extra sharding is
    architecture-dependent (e.g. flash-attention accumulators when the
    head count doesn't divide the model axis).

    The gradient is placed by the same spec as it passes back (its free
    dims as it arrives), as the reference's constraint pins the
    cotangent."""
    pol = get_policy()
    if pol is None or not isinstance(x, DTensor):
        return x
    spec = spec_of(pol, dims, x.shape, free)
    return _Constrain.apply(x, spec) if _pinnable(x) else _pin(x, spec)


def gather(x, dims):
    """``x`` on the placements of logical ``dims`` (a DTensor under a
    policy; else ``x``) by a plain redistribution: its gradient goes
    back to ``x``'s own placements (a pending sum reduce-scattered),
    where ``constrain`` would pin it at ``dims``.  The MoE gathers its
    expert slots over the batch axes so for the expert products, and
    each rank keeps the gradient of its own rows' slots only."""
    pol = get_policy()
    if pol is None or not isinstance(x, DTensor):
        return x
    want = placements_of(spec_of(pol, dims, x.shape),
                         x.device_mesh.mesh_dim_names)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _split_along(x, dim: int) -> bool:
    """Whether ``x`` is a DTensor split along its dim ``dim``."""
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim
        for p in x.placements)


def last_mean(x):
    """``x.mean(-1, keepdim=True)``.  Where ``x`` is a DTensor split along
    its last dim (the Mamba2 and mLSTM gated norms' width over
    "model"), the ranks' sums are reduced in place, as XLA does:
    DTensor would scatter the sequence to reduce a mean."""
    if not _split_along(x, -1):
        return x.mean(-1, keepdim=True)
    s = x.sum(-1, keepdim=True)
    want = [Replicate() if p.is_partial() else p for p in s.placements]
    if want != list(s.placements):
        s = s.redistribute(s.device_mesh, want)
    return s / x.shape[-1]


def row_mean(x, dims: tuple):
    """``x.mean(dims)`` over dims that include dim 0, the batch rows.
    Where ``x`` is a DTensor whose rows are split (evenly, as
    ``constrain`` splits them; the MoE's router probabilities and
    choices), each rank takes the mean of its own rows as its share of a
    pending sum over the splitting mesh dims: DTensor's own mean expands
    its gradient over every row on every rank, then reduce-scatters it."""
    if not _split_along(x, 0):
        return x.mean(dims)
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = [isinstance(p, Shard) and p.dim % x.ndim == 0
            for p in x.placements]
    in_p = [Shard(0) if r else Replicate() for r in rows]
    ways = math.prod(mesh.size(i) for i, r in enumerate(rows) if r)
    return local_map(lambda t: t.mean(dims) / ways,
                     out_placements=[Partial() if r else Replicate()
                                     for r in rows],
                     in_placements=(in_p,), device_mesh=mesh)(
                         x.redistribute(mesh, in_p))


def _grad_placements(in_p, args) -> tuple:
    """The placements of the local gradients that ``local_map``'s
    backward hands each argument (its ``in_grad_placements``).  Where an
    argument is replicated over a mesh dim that splits another argument,
    each rank along it computes with other data: its gradient there is a
    pending sum, not a replica (a vocab-split table's rows gathered for
    tokens split over the batch axes, an SSD's per-head ``A`` beside rows
    split over them).  An integer argument has no gradient and keeps its
    placements."""
    split = {i for p in in_p if p is not None
             for i, q in enumerate(p) if isinstance(q, Shard)}
    return tuple(
        None if p is None else
        tuple(p) if not (torch.is_tensor(a) and a.is_floating_point()) else
        tuple(Partial() if isinstance(q, Replicate) and i in split else q
              for i, q in enumerate(p))
        for p, a in zip(in_p, args))


def _mesh_of(args):
    """The ``DeviceMesh`` of the first DTensor in ``args``, or None."""
    return next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)


def _resolve(pol: Policy, in_dims, args) -> dict:
    """{logical axis: the mesh axes ``constrain`` would give it}, the same
    for every argument (None where two of them disagree)."""
    resolved: dict = {}
    for a, dims in zip(args, in_dims):
        if dims is None:
            continue
        for name, entry in zip(dims, spec_of(pol, dims, a.shape)):
            if name is not None:
                resolved[name] = (entry if resolved.get(name, entry) == entry
                                  else None)
    return resolved


def local_shards(fn, in_dims, out_dims, *args):
    """``fn(*args)`` on each rank's shard (``local_map``) for a function
    that is independent along its logical dims — attention, the SSD and
    mLSTM chunk scans are, per batch row and head; the MoE's routing, per
    batch row.  ``in_dims`` gives each argument's logical dims (``None``
    for a non-tensor), ``out_dims`` each output's (one tuple for a single
    output).  A logical axis maps to the mesh axes ``constrain`` would
    give it, the same for every argument (dropped for all where one of
    them does not divide).  The arguments are redistributed there first.
    Without a policy, or with no DTensor argument, this is
    ``fn(*args)``.

    Where the "model" dims (``n`` heads) do not divide the model axis but
    ``n`` divides it, each group of ranks along it runs one head
    (``_head_groups``), as XLA splits such heads (the mLSTM's 4 on 16),
    in place of every rank running every head.

    DTensor has no rule for these loops' einsums once two of their
    batch dims are split (they flatten (B, H) into one dim split twice,
    which it cannot place); per shard they are plain tensor ops."""
    pol, mesh = get_policy(), _mesh_of(args)
    if pol is None or mesh is None:
        return fn(*args)
    resolved = _resolve(pol, in_dims, args)
    n = {a.shape[d] for a, dims in zip(args, in_dims) if dims is not None
         for d, name in enumerate(dims) if name == "model"}
    m = pol.axis_size("model")
    if (resolved.get("model", pol.model_axis) is None
            and len(n) == 1 and 1 < min(n) < m and m % min(n) == 0):
        fn = _head_groups(fn, in_dims, out_dims, _single(out_dims),
                          min(n), m, mesh, pol)
        return _on_shards(fn, in_dims, out_dims, args, mesh, pol, resolved,
                          pending=True)
    return _on_shards(fn, in_dims, out_dims, args, mesh, pol, resolved)


def _single(out_dims) -> bool:
    """Whether ``out_dims`` is one output's dims (not a tuple of them)."""
    return not out_dims or not isinstance(out_dims[0], tuple)


def _on_shards(fn, in_dims, out_dims, args, mesh, pol: Policy,
               resolved: dict, pending: bool = False):
    """``local_map`` of ``fn`` with each logical axis on its ``resolved``
    mesh axes.  ``pending``: each rank along the model axis computes a
    share, so every output and every floating argument that the model
    axis does not split has a pending sum over it (the output, and the
    argument's gradient)."""
    from torch.distributed.tensor.experimental import local_map

    def place(dims) -> list:     # a list: local_map reads a tuple as
        return placements_of(    # one placement list an output
            tuple(None if n is None else resolved.get(n) for n in dims),
            mesh.mesh_dim_names)

    in_p, local = [], []
    for a, dims in zip(args, in_dims):
        if dims is None:
            in_p.append(None)
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim)
        in_p.append(place(dims))
        # placed already: no redistribution, whose backward would reduce
        # a pending gradient here rather than where it is next placed
        local.append(a if tuple(a.placements) == tuple(in_p[-1])
                     else a.redistribute(mesh, in_p[-1]))
    single = _single(out_dims)
    out_p = place(out_dims) if single else tuple(place(d) for d in out_dims)
    grad_p = _grad_placements(in_p, local)
    if pending:
        axis = mesh.mesh_dim_names.index(pol.model_axis)

        def summed(p):             # the model axis a pending sum
            return [Partial() if i == axis and isinstance(q, Replicate)
                    else q for i, q in enumerate(p)]

        out_p = summed(out_p) if single else tuple(map(summed, out_p))
        grad_p = tuple(g if g is None or not a.is_floating_point()
                       else tuple(summed(g)) for g, a in zip(grad_p, local))
    return local_map(fn, out_placements=out_p, in_placements=tuple(in_p),
                     in_grad_placements=grad_p, device_mesh=mesh)(*local)


def expert_shards(fn, n_experts: int, in_dims, out_dims, *args):
    """``fn(first, count, *args)`` on each rank's shard, for the MoE's
    dispatch into its experts' slots and its combine out of them (an
    ``index_copy_`` and an indexed gather, which DTensor has no rule
    for).  The rank holds ``count`` experts from ``first``: its slice of
    ``n_experts`` along "model" where they divide it (a "model" dim is
    such a slice), else all of them.  Its batch rows are those its
    arguments' "batch" dims hold (``local_shards``' placement), and a
    "batch" dim of an output (the slots' ``B·C``) is split as the rows
    are.  Where the experts are split, each rank dispatches and
    combines only the assignments to its own: an output or a floating
    argument without a "model" dim has a pending sum over the model
    axis.  Without a policy, or with no DTensor argument, this is
    ``fn(0, n_experts, *args)``."""
    pol, mesh = get_policy(), _mesh_of(args)
    if pol is None or mesh is None:
        return fn(0, n_experts, *args)
    resolved = _resolve(pol, in_dims, args)
    m = pol.axis_size("model")
    if m == 1 or n_experts % m:
        resolved["model"] = None
        return _on_shards(lambda *xs: fn(0, n_experts, *xs), in_dims,
                          out_dims, args, mesh, pol, resolved)
    resolved["model"] = pol.model_axis
    count = n_experts // m
    first = count * mesh.get_coordinate()[
        mesh.mesh_dim_names.index(pol.model_axis)]
    return _on_shards(lambda *xs: fn(first, count, *xs), in_dims, out_dims,
                      args, mesh, pol, resolved, pending=True)


def _head_groups(fn, in_dims, out_dims, single: bool, n: int, m: int, mesh,
                 pol):
    """``fn`` run on one of ``n`` heads, the one of this rank's group of
    ``m / n`` ranks along the model axis, its outputs whole along the
    heads with the others zero; only the group's first rank keeps them,
    the rest hand on zeros, so the outputs are exact pending sums over
    the model axis (and so are the arguments' gradients)."""
    c = mesh.get_coordinate()[mesh.mesh_dim_names.index(pol.model_axis)]
    j, first = c // (m // n), c % (m // n) == 0

    def at(dims):
        return None if dims is None or "model" not in dims else \
            dims.index("model")

    def whole(t, d):
        if d is None:
            return t
        pad = list(t.shape)
        before, pad[d] = pad[d] * j, pad[d] * (n - j - 1)
        t = torch.cat([t.new_zeros(t.shape[:d] + (before,) + t.shape[d + 1:]),
                       t, t.new_zeros(pad)], dim=d)
        return t if first else torch.where(
            torch.zeros((), dtype=torch.bool, device=t.device), t, 0)

    def run(*xs):
        xs = [x if at(dims) is None else x.narrow(at(dims), j, 1)
              for x, dims in zip(xs, in_dims)]
        out = fn(*xs)
        if single:
            return whole(out, at(out_dims))
        return tuple(whole(o, at(d)) for o, d in zip(out, out_dims))

    return run


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
    (``logsigmoid``): on each rank's shard, placed as ``x`` is (a pending
    sum reduced first)."""
    if not isinstance(x, DTensor):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map

    p = [q if isinstance(q, (Shard, Replicate)) else Replicate()
         for q in x.placements]
    x = x.redistribute(x.device_mesh, p)
    return local_map(fn, out_placements=p, in_placements=(p,),
                     device_mesh=x.device_mesh)(x)


def _vocab_slice(src: DTensor, dim: int):
    """(mesh dims that split ``src`` along ``dim``, in mesh order) ->
    this rank's first index along ``dim`` and its local length."""
    mesh, coord = src.device_mesh, src.device_mesh.get_coordinate()
    split = [i for i, p in enumerate(src.placements)
             if isinstance(p, Shard) and p.dim % src.ndim == dim % src.ndim]
    index, ways = 0, 1
    for i in split:
        index, ways = index * mesh.size(i) + coord[i], ways * mesh.size(i)
    n = src.shape[dim] // ways
    return split, index * n, n


def vocab_take(src, index, dim: int, take):
    """``take(src, index)`` — a lookup along ``src``'s vocab dim ``dim``
    (a table's rows, ``dim`` 0, or logits' last dim) — where ``src`` may
    be a DTensor split along ``dim``.  Then each rank looks up the
    indices its slice holds, the others read 0, and the result is a
    pending sum over the splitting mesh dims.  DTensor's own masked
    lookup checks its mask against the data on the host, which a fake
    tensor cannot answer, and its mask does not survive a later select.

    ``take(local_src, local_index)`` is the plain op; ``index`` is
    placed like ``src`` on every other mesh dim (a table is first
    gathered whole along its other dims).  Logits whole along the vocab
    (one that does not divide "model") take their gold entries on each
    rank's rows too: DTensor's own gather would gather the rows whole,
    and its backward scatter into logits of every row (seamless's
    256206-entry vocabulary: 50 GB a rank)."""
    if not isinstance(src, DTensor):
        return take(src, index)
    split, lo, n = _vocab_slice(src, dim)
    from torch.distributed.tensor.experimental import local_map

    if not split:
        rows = tuple(src.placements)
        if dim == 0 or any(p.is_partial() or isinstance(p, Shard) and
                           p.dim % src.ndim >= index.ndim for p in rows):
            return take(src, index)
        if not isinstance(index, DTensor):
            index = DTensor.from_local(index, src.device_mesh,
                                       [Replicate()] * src.device_mesh.ndim)
        index = index.redistribute(src.device_mesh, rows)
        return local_map(take, out_placements=list(rows),
                         in_placements=(rows, rows),
                         device_mesh=src.device_mesh)(src, index)

    mesh = src.device_mesh
    if dim == 0:          # a table: whole along its width on every rank
        src = src.redistribute(mesh, [p if i in split else Replicate()
                                      for i, p in enumerate(src.placements)])
    if not isinstance(index, DTensor):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim)
    idx_p = [Replicate() if i in split else p
             for i, p in enumerate(src.placements if dim != 0
                                   else index.placements)]
    index = index.redistribute(mesh, idx_p)
    out_p = [Partial() if i in split else p for i, p in enumerate(idx_p)]

    def local(s, ix):
        rel = ix - lo
        hit = (rel >= 0) & (rel < n)
        out = take(s, rel.clamp(0, n - 1))
        hit = hit.reshape(hit.shape + (1,) * (out.ndim - hit.ndim))
        return torch.where(hit, out, torch.zeros((), dtype=out.dtype,
                                                 device=out.device))

    in_p = (tuple(src.placements), tuple(idx_p))
    return local_map(local, out_placements=out_p, in_placements=in_p,
                     in_grad_placements=_grad_placements(in_p, (src, index)),
                     device_mesh=mesh)(src, index)


# ---------------------------------------------------------------------------
# attention and its cache
# ---------------------------------------------------------------------------

#: (B, S, heads, hd) per shard: rows over the batch axes, heads over
#: "model" where both head counts divide it (else every model rank
#: attends with every head, as XLA does with heads it cannot split)
HEADS = ("batch", None, "model", None)


def split_heads(x, n: int, hd: int):
    """(B, S, n·hd) -> (B, S, n, hd), heads over "model" where they
    divide it (unconstrained otherwise).  Under a policy whose model
    axis ``n`` heads do not divide, the merged dim is first replicated
    over it: DTensor cannot unflatten a dim sharded unevenly.  That step
    is no constraint of the reference's, so its gradient goes back to
    the merged dim's own placement (a pending sum reduce-scattered)."""
    pol = get_policy()
    if pol is not None and isinstance(x, DTensor) and \
            n % pol.axis_size("model"):
        x = x.redistribute(x.device_mesh, placements_of(
            spec_of(pol, ("batch", None, None), x.shape),
            x.device_mesh.mesh_dim_names))
    return constrain(x.reshape(x.shape[0], x.shape[1], n, hd), HEADS,
                     free=True)


def merge_heads(x):
    """(B, S, n, hd) -> (B, S, n·hd), the merged dim over "model" where
    it divides it, and so its gradient.  Where ``n`` heads do not divide
    the model axis, the heads come whole and DTensor cannot split such
    a gradient back into heads: ``hold`` gathers it whole first."""
    b, s = x.shape[:2]
    return constrain(hold(x.reshape(b, s, -1)), ("batch", None, "model"))


def per_head(fn, q, k, v):
    """``fn(q, k, v)`` — attention over (B, S, heads, hd) — on each rank's
    shard of rows and heads (``local_shards``)."""
    return local_shards(fn, (HEADS,) * 3, HEADS, q, k, v)


def _zigzag(s: int, m: int, device) -> torch.Tensor:
    """The positions of ``s`` in the order that gives rank ``c`` of ``m``
    blocks ``c`` and ``2m − 1 − c`` of ``2m``: each rank's causal
    queries then need the same number of key tiles."""
    n = s // (2 * m)
    return torch.cat([torch.arange(b * n, (b + 1) * n, device=device)
                      for c in range(m) for b in (c, 2 * m - 1 - c)])


def attend_merged(fn, q, k, v):
    """``fn(q, k, v)`` over (B, S, heads, hd) -> (B, S, heads·hd), the
    merged dim on "model" (``merge_heads``), ``fn`` taking the first
    query's position as ``q_start``.

    Where a head count does not divide "model", the reference leaves the
    heads free and XLA splits other dims over "model"; here the queries
    are: each model rank attends with every head for two blocks of
    ``S / 2m`` queries, ``c`` and ``2m − 1 − c`` (so the causal work is
    the same on every rank), against the whole keys and values.  The
    queries are permuted into that order where each rank holds them
    whole, split, and the output comes back by an all-to-all onto the
    merged dim, where each rank holds the sequence whole again and
    undoes the permutation.  Otherwise this is ``per_head`` then
    ``merge_heads``."""
    pol = get_policy()
    mesh = q.device_mesh if isinstance(q, DTensor) else None
    m = pol.axis_size("model") if pol is not None else 1
    b, s, h, hd = q.shape
    if (mesh is None or m == 1 or s % (2 * m)
            or (h % m == 0 and k.shape[2] % m == 0)):
        return merge_heads(per_head(fn, q, k, v))
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    axis = names.index(pol.model_axis)
    rows = placements_of(spec_of(pol, HEADS[:1] + (None,) * 3, q.shape),
                         names)
    split = [Shard(1) if i == axis else p for i, p in enumerate(rows)]
    merged = [Shard(2) if i == axis else p for i, p in enumerate(rows)]
    q, k, v = (t.redistribute(mesh, rows) for t in (q, k, v))
    n, c = s // (2 * m), mesh.get_coordinate()[axis]

    def permute(t, inverse=False):
        order = _zigzag(s, m, t.device)
        if inverse:
            order = torch.argsort(order)
        return t.index_select(1, order)

    def blocks(ql, kl, vl):
        return torch.cat([fn(ql[:, :n], kl, vl, q_start=c * n),
                          fn(ql[:, n:], kl, vl, q_start=(2 * m - 1 - c) * n)],
                         dim=1)

    q = local_map(permute, out_placements=rows, in_placements=(rows,),
                  device_mesh=mesh)(q).redistribute(mesh, split)
    in_p = (split, rows, rows)
    out = local_map(blocks, out_placements=split, in_placements=in_p,
                    in_grad_placements=_grad_placements(in_p, (q, k, v)),
                    device_mesh=mesh)(q, k, v)
    out = out.reshape(b, s, h * hd).redistribute(mesh, merged)
    out = local_map(lambda t: permute(t, inverse=True),
                    out_placements=merged, in_placements=(merged,),
                    device_mesh=mesh)(out)
    return constrain(out, ("batch", None, "model"))


def cache_attend(fn, q, k_cache, v_cache):
    """Decode attention ``fn(q, k_cache, v_cache)``: a cache whole along
    its sequence runs ``per_head``; a sequence-split cache (a batch-1
    long context, or KV heads that do not divide "model") runs as
    DTensor places it: its scores stay split, the softmax gathers them
    and the value product sums over the ranks."""
    if _split_along(k_cache, 1):
        return fn(q, k_cache, v_cache)
    return per_head(fn, q, k_cache, v_cache)


def constrain_cache(t):
    """A (B, S, KV, hd) cache ``t`` on its placement under the installed
    policy: batch over the batch axes where it divides them, else the
    sequence (a batch-1 long-context cache); KV heads over "model"
    where they divide it, else the sequence."""
    pol = get_policy()
    if pol is None:
        return t
    bdim = "batch" if t.shape[0] % pol.axis_size("batch") == 0 else None
    sdim = None if bdim else "batch"
    if t.shape[2] % pol.axis_size("model") == 0:
        return constrain(t, (bdim, sdim, "model", None))
    return constrain(t, (bdim, sdim or "model", None, None))


def write_slot(cache, pos: int, val) -> None:
    """``cache[:, pos] = val`` in place.  A DTensor cache whose sequence
    dim is sharded (``constrain_cache``) is written on the local shard
    of the rank that holds ``pos``: DTensor's ``select`` of a sharded
    dim would gather the whole cache to write one slot, into a copy."""
    seq = [i for i, p in enumerate(getattr(cache, "placements", ()))
           if isinstance(p, Shard) and p.dim == 1]
    if not seq:
        cache[:, pos] = val
        return
    # val (B, KV, hd) takes the cache's placements less the sequence dim
    want = [Replicate() if i in seq else
            Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard) else p
            for i, p in enumerate(cache.placements)]
    local = val.redistribute(cache.device_mesh, want).to_local()
    mesh, coord = cache.device_mesh, cache.device_mesh.get_coordinate()
    index, ways = 0, 1
    for i in seq:                # the mesh dims split S, outermost first
        index, ways = index * mesh.size(i) + coord[i], ways * mesh.size(i)
    size = cache.shape[1] // ways
    if index * size <= pos < (index + 1) * size:
        cache.to_local()[:, pos - index * size] = local


def microbatches(x, n: int) -> list:
    """``x`` cut along dim 0 into ``n`` equal microbatches, each on the
    batch's placement (the reference's ``reshape`` to (n, B / n, ...)
    and its scan over them).  Where ``x`` is split along dim 0, a slice
    of it would gather it whole on every rank first (a vision cell's
    (B, S, D) embeddings: 17 GB); the split moves to the first other dim
    that no mesh dim splits yet and that it divides (an all-to-all),
    where each rank's part of a microbatch is local, and each
    microbatch moves back to the batch's placement (another)."""
    m = x.shape[0] // n
    dims = ("batch",) + (None,) * (x.ndim - 1)
    if get_policy() is not None and _split_along(x, 0):
        mesh = x.device_mesh
        ways = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                         if isinstance(p, Shard) and p.dim == 0)
        to = next((d for d in range(1, x.ndim) if not _split_along(x, d)
                   and x.shape[d] % ways == 0), None)
        if to is not None:
            x = x.redistribute(mesh, [
                Shard(to) if isinstance(p, Shard) and p.dim == 0 else p
                for p in x.placements])
    return [constrain(x[i * m:(i + 1) * m], dims) for i in range(n)]


def constrain_tree(tree, dims_fn):
    """Constrain every tensor leaf; dims_fn(leaf) -> dims tuple."""
    return torch.utils._pytree.tree_map_only(
        torch.Tensor, lambda x: constrain(x, dims_fn(x)), tree)


# ---------------------------------------------------------------------------
# gradients on their parameters' placements
# ---------------------------------------------------------------------------

def _reduce_placed(g: DTensor, want: tuple) -> DTensor:
    """``g`` on ``want`` by the collectives that move the fewest bytes:
    first every step that shrinks the local tensor (a pending sum
    reduce-scattered into a ``Shard``, a replicated dim split locally),
    then the pending sums that ``want`` replicates (all-reduced at that
    smaller size), last the gathers (a ``Shard`` that ``want`` places
    otherwise).  DTensor's own order gathers first where one call holds
    both."""
    have = tuple(g.placements)
    if have == want:
        return g
    mesh = g.device_mesh
    shrink = tuple(w if isinstance(w, Shard) and not isinstance(h, Shard)
                   else h for h, w in zip(have, want))
    if shrink != have:
        g = g.redistribute(mesh, shrink)
    reduced = tuple(w if h.is_partial() else h
                    for h, w in zip(g.placements, want))
    if reduced != tuple(g.placements):
        g = g.redistribute(mesh, reduced)
    return g.redistribute(mesh, want) if tuple(g.placements) != want else g


class reduce_grads_to_params:
    """Context manager: while it is open, each DTensor parameter of
    ``params`` has its gradient reduced to its placements as the
    backward makes it, by a hook on the leaf — the reference's
    ``grad_shardings``, where XLA keeps each gradient sharded as its
    parameter.  DTensor leaves a parameter's gradient a pending sum over
    the batch axes, whole along the dims that the parameter shards over
    them; reduced only when the optimizer reads it, every such gradient
    would be live at once.  The hooks are removed on exit, also when an
    exception is raised.

    Without a policy, or for a plain tensor, it does nothing, as
    ``constrain`` does."""

    def __init__(self, params):
        self.params = list(params)
        self.handles: list = []

    def __enter__(self):
        if get_policy() is None:
            return self
        for p in self.params:
            if isinstance(p, DTensor) and p.requires_grad:
                self.handles.append(p.register_hook(
                    lambda g, want=tuple(p.placements): _reduce_placed(g, want)
                    if isinstance(g, DTensor) else g))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles.clear()
