"""Per-device dot FLOPs and collective bytes of one traced step — the
port's counterpart of ``repro/launch/hlo_parse.py``.

There is no ``hlo_parse`` counterpart: an eager PyTorch step has no HLO
text to parse.  ``OpCounter`` is a dispatch mode that sees the ops one
rank runs while the step runs.  On DTensors it steps aside
(``NotImplemented``), so DTensor's dispatch runs and the counter sees
the local ops it turns into — the shapes of one device's shard — and
the collectives its redistributions issue; the ops DTensor's sharding
propagation runs on global shapes (under its own fake mode) are not
counted.  DTensor runs that propagation under the fake mode already
active, the dry run's own, so the counter also marks the span of
``ShardingPropagator._propagate_tensor_meta_non_cached`` (patched while
a counter is active) and counts nothing inside it.  The collectives of plain ``torch.distributed`` calls
(``core.distributed``'s ``batch_isend_irecv``, ``all_reduce`` and
``all_gather``) reach it as ``c10d`` ops, on any process group,
the fake one included.

What it counts, as ``hlo_parse.analyze`` does:

  * dot FLOPs: matrix products only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``mv``, ``dot``; an einsum or a ``matmul`` reaches it
    as these), 2 · |result| · |contracted dims|; elementwise work is not
    counted;
  * collective bytes and counts under the reference's five kinds: the
    result's bytes on one device, times 2 for an all-reduce and 1
    otherwise; a send/receive pair is one ``collective-permute``, counted
    at its receive buffer.

It also keeps the rank's live tensor bytes and their peak: each storage
an op creates (on a device, not ``meta``) counts, rounded up to the CUDA caching allocator's
512-byte blocks, from the op that makes it until it is freed; the
step's arguments count from ``track``.

Loops.  An eager loop runs every trip, so by default every trip is
counted as it runs.  ``OpCounter(fold=True)`` folds the loops that the
model code runs through ``models.partitioning.scan`` (the microbatches,
the SSD and mLSTM chunks, the sLSTM tokens), as ``hlo_parse`` counts a
``while`` body once and multiplies it by its trip count.  A folded loop
of n ≥ 5 trips runs four of them:

  * trip 0, which may differ (an empty initial state, no gradient sum
    yet), and trip 1, whose backward frees what trip 0's outputs left
    pending (the gradient their sum keeps whole);
  * trip 2, counted n − 3 times: its forward ops, and the backward ops
    of the autograd nodes it created (a node's ``_sequence_nr`` falls in
    the trip's range), a checkpoint's recompute included (it runs
    inside such a node; the loops it folds multiply their weights into
    the node's);
  * trip n − 1, whose final carry no later trip reads.

The n − 4 trips between stand as ``_stand_ins``: their per-trip outputs
as tensors of trip 2's shapes, and the rest of what trip 2 left live
(what autograd, or a checkpoint's recompute, saved) as one block, held
until the backward has passed trip 2 (``_Bridge``, ``_Release``).  The
backward runs the nodes in the reverse of their creation order, so the
live bytes follow the unfolded trace's at every point: the dot FLOPs,
the collectives by kind and the peak equal it (``tests/
test_torch_fold.py``).  The flash tile loop and the layer stack are not
folded; a loop that a trace cuts short is extrapolated by its caller
(``dryrun.run_geodesic_cell``).
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from collections import defaultdict

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten
from torch.utils.weak import WeakIdKeyDictionary

_aten = torch.ops.aten

#: the sequence number of an autograd node that has none (AccumulateGrad)
_NO_SEQUENCE_NR = 2 ** 64 - 1


def _mm(a, b, *_):
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]


def _bmm(a, b, *_):
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


DOTS = {
    _aten.mm: _mm,
    _aten.addmm: lambda bias, a, b, *_: _mm(a, b),
    _aten.bmm: _bmm,
    _aten.baddbmm: lambda bias, a, b, *_: _bmm(a, b),
    _aten.mv: lambda a, v, *_: 2.0 * a.shape[0] * a.shape[1],
    _aten.dot: lambda a, b, *_: 2.0 * a.shape[0],
}


#: DTensor's move of a split from one dim to another (its own op), or
#: None in a torch without it.  Its fake result is a view into a buffer
#: as large as the group's whole input (a chunk of everything gathered):
#: the counter keeps a copy of the result's own size in its place
_ALLTOALL = getattr(torch.ops._dtensor, "shard_dim_alltoall", None)


def _kinds() -> dict:
    """op overload packet -> (kind, where its result is: "out" or the
    first argument)."""
    kinds = {}
    fn = torch.ops._c10d_functional
    for name, kind in (("all_reduce", "all-reduce"),
                       ("all_reduce_coalesced", "all-reduce"),
                       ("all_gather_into_tensor", "all-gather"),
                       ("all_gather_into_tensor_coalesced", "all-gather"),
                       ("reduce_scatter_tensor", "reduce-scatter"),
                       ("reduce_scatter_tensor_coalesced", "reduce-scatter"),
                       ("all_to_all_single", "all-to-all")):
        if hasattr(fn, name):
            kinds[getattr(fn, name)] = (kind, "out")
    if _ALLTOALL is not None:
        kinds[_ALLTOALL] = ("all-to-all", "out")
    auto = getattr(torch.ops, "_c10d_functional_autograd", None)
    for name, kind in (("all_reduce", "all-reduce"),
                       ("all_gather_into_tensor", "all-gather"),
                       ("reduce_scatter_tensor", "reduce-scatter"),
                       ("all_to_all_single", "all-to-all")):
        if auto is not None and hasattr(auto, name):
            kinds[getattr(auto, name)] = (kind, "out")
    c10d = torch.ops.c10d
    for name, kind in (("allreduce_", "all-reduce"),
                       ("allreduce_coalesced_", "all-reduce"),
                       ("allgather_", "all-gather"),
                       ("_allgather_base_", "all-gather"),
                       ("allgather_coalesced_", "all-gather"),
                       ("allgather_into_tensor_coalesced_", "all-gather"),
                       ("reduce_scatter_", "reduce-scatter"),
                       ("_reduce_scatter_base_", "reduce-scatter"),
                       ("reduce_scatter_tensor_coalesced_", "reduce-scatter"),
                       ("alltoall_", "all-to-all"),
                       ("alltoall_base_", "all-to-all"),
                       ("recv_", "collective-permute")):
        if hasattr(c10d, name):
            kinds[getattr(c10d, name)] = (kind, "arg")
    return kinds


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _block(nbytes: int) -> int:
    """``nbytes`` rounded up to the caching allocator's 512-byte
    blocks."""
    return -(-nbytes // 512) * 512


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t``: a DTensor's local tensor, else ``t``."""
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tensors) -> int:
    """The bytes that ``tensors`` hold on this rank."""
    return sum(local_tensor(t).nbytes for t in tensors)


def _describe(x) -> str:
    t = next(_tensors(x), None)
    if t is None:
        return "?"
    dt = str(t.dtype).replace("torch.", "")
    return f"{dt}[{','.join(map(str, t.shape))}]"


_PROPAGATING = [0]      # depth of DTensor's output-metadata propagation
_PATCHED: list = []     # the original method, then one entry a counter


def _watch_propagation() -> None:
    """Mark DTensor's metadata propagation (``_PROPAGATING``) while any
    counter is active: it runs the op on global-shape fake tensors under
    whatever fake mode is active, which is not this rank's work."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    if not _PATCHED:
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        @functools.wraps(orig)
        def marked(self, *args, **kwargs):
            _PROPAGATING[0] += 1
            try:
                return orig(self, *args, **kwargs)
            finally:
                _PROPAGATING[0] -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        _PATCHED.append(orig)
    _PATCHED.append(None)


def _unwatch_propagation() -> None:
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    _PATCHED.pop()
    if len(_PATCHED) == 1:
        ShardingPropagator._propagate_tensor_meta_non_cached = _PATCHED.pop()


class _Trip:
    """A weighted trip that is running (compared by identity)."""
    __slots__ = ("weight", "in_backward")

    def __init__(self, weight: float, in_backward: bool):
        self.weight, self.in_backward = weight, in_backward


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step()`` -> ``c.result()``, with the keys
    of ``hlo_parse.analyze``'s result."""

    def __init__(self, fold: bool = False):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self.dot_flops = 0.0
        self.bytes: dict[str, float] = defaultdict(float)
        self.counts: dict[str, float] = defaultdict(float)
        self.sites: dict[tuple, list] = defaultdict(lambda: [0, 0.0])
        self._kinds = _kinds()
        self.fold_loops = fold
        self._trips: list[_Trip] = []
        # [first, end (None while it runs)] sequence numbers of the
        # autograd nodes a weighted forward trip created, and their weight
        self._ranges: list = []
        self._node_weights: dict = {}

    def track(self, *held) -> None:
        """Count the storages of ``held`` (tensors, DTensors, modules'
        parameters and buffers, or containers of them) as live."""
        for x in held:
            if isinstance(x, torch.nn.Module):
                self.track(*x.parameters(), *x.buffers())
            elif isinstance(x, torch.Tensor):
                self._hold(local_tensor(x))
            elif isinstance(x, (list, tuple, dict)):
                self.track(*tree_leaves(x))

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":       # shapes only, nothing allocated
            return
        st = t.untyped_storage()
        if st in self._storages:
            return
        size = _block(st.nbytes())
        self._storages[st] = weakref.ref(st, functools.partial(
            self._free, size))
        self.live += size
        self.peak = max(self.peak, self.live)

    def _free(self, size: int, _ref) -> None:
        self.live -= size

    def __enter__(self):
        from repro_torch.models import partitioning

        # ops that run under another fake mode than the one active here
        # are DTensor's sharding propagation, on global shapes
        self._fake = active_fake_mode()
        _watch_propagation()
        if self.fold_loops:
            partitioning.set_folder(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.models import partitioning

        try:
            return super().__exit__(*exc)
        finally:
            if self.fold_loops:
                partitioning.set_folder(None)
            _unwatch_propagation()

    # -- folded loops -------------------------------------------------------

    def fold(self, body, n: int):
        """``partitioning.scan(body, n)`` folded (``n`` ≥ 5): trips 0, 1,
        2 and n − 1 run, trip 2 weighted n − 3, ``_stand_ins`` for the
        n − 4 trips between."""
        carry, first = body(0, None)
        carry, second = body(1, carry)
        mark = _Release.after(carry)
        before = self.live
        with self._weighted(n - 3):
            carry, out = body(2, carry)
        # the live bytes the n − 3 middle trips leave, as trip 2 did
        target = before + (n - 3) * (self.live - before)
        between, hold = _stand_in_trips(self, mark, carry, out, n - 4,
                                        target)
        carry, last = body(n - 1, carry)
        del hold
        return carry, [first, second, out, *between, last]

    @contextlib.contextmanager
    def _weighted(self, weight: float):
        """Count the ops that run inside as ``weight`` times (times the
        weights around them), and, in a forward, the backward of the
        autograd nodes created inside."""
        in_backward = torch._C._current_autograd_node() is not None
        trip = _Trip(weight, in_backward)
        nodes = None
        if not in_backward and torch.is_grad_enabled():
            # open while the trip runs: a microbatch's backward runs in it
            nodes = [torch._C._autograd._get_sequence_nr(), None,
                     self._forward_weight() * weight]
            self._ranges.append(nodes)
        self._trips.append(trip)
        try:
            yield
        finally:
            self._trips.remove(trip)
            if nodes is not None:
                nodes[1] = torch._C._autograd._get_sequence_nr()

    def _forward_weight(self) -> float:
        w = 1.0
        for trip in self._trips:
            w *= trip.weight
        return w

    def _node_weight(self, node) -> float:
        """The weight of the forward trip that created ``node`` (the
        innermost one whose sequence numbers hold its own; 1 if none)."""
        seq = node._sequence_nr()
        w = self._node_weights.get(seq)
        if w is None:
            inner = max(((lo, w) for lo, hi, w in self._ranges
                         if lo <= seq and (hi is None or seq < hi)),
                        default=(0, 1.0))
            w = inner[1]
            # a leaf's gradient hook runs in its AccumulateGrad node,
            # which has no sequence number of its own (the largest):
            # it belongs to the trips open now, so it is not cached
            if seq != _NO_SEQUENCE_NR:
                self._node_weights[seq] = w
        return w

    def _weight(self) -> float:
        """How many times the op dispatched now counts: in a forward, the
        product of the weighted trips around it; in a backward, its
        node's weight times the trips entered inside that backward (a
        recompute's folded loops)."""
        if not self._trips and not self._ranges:
            return 1.0
        node = torch._C._current_autograd_node()
        if node is None:
            return self._forward_weight()
        w = self._node_weight(node)
        for trip in self._trips:
            if trip.in_backward:
                w *= trip.weight
        return w

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING[0] or active_fake_mode() is not self._fake:
            return out
        if func._overloadpacket is _ALLTOALL and \
                out.untyped_storage().nbytes() > out.nbytes:
            out = out.clone()       # the real collective's own buffer
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        packet = func._overloadpacket
        if packet in DOTS:
            flops = DOTS[packet](*args) * self._weight()
            self.dot_flops += flops
            self._on_dot(packet, args, flops)
        elif packet in self._kinds:
            kind, where = self._kinds[packet]
            result = out if where == "out" else args[0]
            w = self._weight()
            payload = _nbytes(result) * (2.0 if kind == "all-reduce" else 1.0)
            self.bytes[kind] += payload * w
            self.counts[kind] += w
            site = self.sites[(kind, _describe(result))]
            site[0] += w
            site[1] += payload * w
        return out

    def _on_dot(self, packet, args, flops: float) -> None:
        """Called with each matrix product and its weighted FLOPs (a
        hook for ``launch.trace_profile --dots``)."""

    def result(self) -> dict:
        """Per-device totals: ``dot_flops``, ``collective_bytes`` and
        ``collective_counts`` by kind, ``collective_bytes_total``,
        ``top_collectives``."""
        return summary(self.dot_flops, self.bytes, self.counts, self.sites)


def _stand_ins(counter: OpCounter, carry, out, trips: int, target: int):
    """(the outputs of ``trips`` folded trips, flat, trip by trip, as
    trip 2's ``out``; a block) such that the live bytes reach
    ``target``.  An output that is also part of the carry (the sLSTM's
    h) lies in the block, as the later trips keep each carry alive;
    another lies in a storage of its own, one for all the trips, freed
    when their list goes.  The block holds the rest of what the folded
    trips would have left live.  Each storage is cut into the trips'
    tensors by one ``unbind``, however many trips there are."""
    carried = {local_tensor(t).untyped_storage()._cdata for t in carry}
    shared = [local_tensor(t).untyped_storage()._cdata in carried for t in out]
    sizes = [_block(t.numel() * t.element_size()) for t in out]
    leaves = [None if tied else _fresh(t, trips, n)
              for t, n, tied in zip(out, sizes, shared)]
    views = trips * sum(n for n, tied in zip(sizes, shared) if tied)
    block = torch.empty(max(views, target - counter.live), dtype=torch.uint8,
                        device=(*carry, *out)[0].device)
    at = 0
    for j, (t, n) in enumerate(zip(out, sizes)):
        if shared[j]:
            leaves[j] = _cut(block[at:at + trips * n], t, trips, n)
            at += trips * n
    return [leaves[j][k] for k in range(trips) for j in range(len(out))], block


def _fresh(like: torch.Tensor, trips: int, nbytes: int):
    """``trips`` new tensors like ``like`` (each ``nbytes``, as the
    allocator rounds it)."""
    if isinstance(like, DTensor):          # the microbatches' metrics
        return [torch.empty_like(like) for _ in range(trips)]
    return _cut(torch.empty(trips * nbytes, dtype=torch.uint8,
                            device=like.device), like, trips, nbytes)


def _cut(raw: torch.Tensor, like: torch.Tensor, trips: int, nbytes: int):
    """``trips`` tensors of ``like``'s shape and dtype in the bytes
    ``raw``, one each ``nbytes``."""
    strides, step = [], 1
    for d in reversed(like.shape):
        strides.insert(0, step)
        step *= d
    return raw.view(like.dtype).as_strided(
        (trips, *like.shape), (nbytes // like.element_size(), *strides)
    ).unbind(0)


class _Release(torch.autograd.Function):
    """A node created between trips 1 and 2 of a folded loop.  The
    backward runs the nodes in the reverse of their creation order, so
    this one runs after trip 2's and before trip 1's: it frees the
    folded trips' block (``_Bridge``), as the unfolded backward has freed
    the saved tensors of the trips between by the time it reaches trip
    1.  Its output is an empty mark that the bridge takes in."""

    @staticmethod
    def forward(ctx, held, *carry):
        ctx.held, ctx.n_carry = held, len(carry)
        return carry[0].new_empty(0)

    @staticmethod
    def backward(ctx, _):
        ctx.held.clear()
        return (None,) * (1 + ctx.n_carry)

    @classmethod
    def after(cls, carry):
        """(the mark, the list the node empties) on trip 1's ``carry``
        where autograd records it, else ``None``."""
        tensors = [t for t in tree_leaves(carry)
                   if isinstance(t, torch.Tensor)]
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            return None
        held: list = []
        return cls.apply(held, *tensors), held


class _Bridge(torch.autograd.Function):
    """The n − 4 folded trips of a loop where autograd records: their
    outputs and block are ``_stand_ins``' (trip n − 1 takes trip 2's
    carry itself, so its backward adds the carry's gradient where trip
    n − 2's would).  Created between trips 2 and n − 1, the node runs in
    the backward between theirs.  The block is saved for the backward
    (under a checkpoint, the recompute's block is held by the checkpoint
    until this node unpacks it) and handed to ``_Release``'s list, which
    frees it after trip 2's backward, where trip n − 2's would have run
    with the trips between still saved."""

    @staticmethod
    def forward(ctx, counter, held, target, trips, n_mark, n_carry,
                *tensors):
        carry = tensors[n_mark:n_mark + n_carry]
        out = tensors[n_mark + n_carry:]
        between, block = _stand_ins(counter, carry, out, trips, target)
        ctx.save_for_backward(block[:0])
        ctx.held, ctx.n_in = held, len(tensors)
        return tuple(between)

    @staticmethod
    def backward(ctx, *_):
        block = ctx.saved_tensors
        if ctx.held is not None:
            ctx.held.extend(block)
        del block
        return (None,) * (6 + ctx.n_in)


def _stand_in_trips(counter: OpCounter, mark, carry, out, trips: int,
                    target: int):
    """(the ``trips`` folded trips' outputs, the block where no autograd
    node holds it: to hold while trip n − 1 runs)."""
    c_t = [t for t in tree_leaves(carry) if isinstance(t, torch.Tensor)]
    o_leaves, o_spec = tree_flatten(out)
    o_idx = [i for i, t in enumerate(o_leaves) if isinstance(t, torch.Tensor)]
    o_t = [o_leaves[i] for i in o_idx]
    hold = None
    if torch.is_grad_enabled() and any(t.requires_grad for t in o_t):
        # the mark ties _Release's node to this one; the gradients this
        # node returns (to the mark, trip 2's carry and outputs) are None
        marks, held = ((mark[0],), mark[1]) if mark else ((), None)
        flat = _tuple(_Bridge.apply(counter, held, target, trips, len(marks),
                                    len(c_t), *marks, *c_t, *o_t))
    else:
        with torch.no_grad():
            flat, hold = _stand_ins(counter, c_t, o_t, trips, target)
    between = []
    for k in range(trips):
        leaves = list(o_leaves)
        for j, i in enumerate(o_idx):
            leaves[i] = flat[k * len(o_idx) + j]
        between.append(tree_unflatten(leaves, o_spec))
    return between, hold


def _tuple(res) -> tuple:
    """A custom Function's result as a tuple (one output comes bare)."""
    return (res,) if isinstance(res, torch.Tensor) else tuple(res)


def summary(dot_flops, coll_bytes, coll_counts, sites) -> dict:
    top = sorted(((b, f"{kind} x{n:.0f} {shape}")
                  for (kind, shape), (n, b) in sites.items()), reverse=True)
    return {
        "dot_flops": float(dot_flops),
        "collective_bytes": dict(coll_bytes),
        "collective_bytes_total": float(sum(coll_bytes.values())),
        "collective_counts": dict(coll_counts),
        "top_collectives": [f"{b / 1e9:.2f}GB {d}" for b, d in top[:10]],
        "sites": {f"{k}|{s}": list(v) for (k, s), v in sites.items()},
    }


def extrapolate(one: dict, two: dict, trips: float) -> dict:
    """A loop traced for one trip (``one``) and for two (``two``), taken
    to ``trips`` trips: what runs once (before the loop) plus ``trips``
    times one trip (the difference)."""
    def ext(a, b):
        return a + (trips - 1) * (b - a)

    sites = {}
    for key in set(one["sites"]) | set(two["sites"]):
        a = one["sites"].get(key, [0, 0.0])
        b = two["sites"].get(key, [0, 0.0])
        kind, shape = key.split("|", 1)
        sites[(kind, shape)] = [ext(a[0], b[0]), ext(a[1], b[1])]
    kinds = set(one["collective_bytes"]) | set(two["collective_bytes"])
    return summary(
        ext(one["dot_flops"], two["dot_flops"]),
        {k: ext(one["collective_bytes"].get(k, 0.0),
                two["collective_bytes"].get(k, 0.0)) for k in kinds},
        {k: ext(one["collective_counts"].get(k, 0.0),
                two["collective_counts"].get(k, 0.0)) for k in kinds},
        sites)

