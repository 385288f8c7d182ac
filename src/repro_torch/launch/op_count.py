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

Eager loops unroll (the flash tile loop, the SSD chunks, the sLSTM
tokens), so every trip is counted as it runs and there is no
``dynamic_trip``; a loop that a trace cuts short is extrapolated by its
caller (``dryrun.run_geodesic_cell``).
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

_aten = torch.ops.aten


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


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


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


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: step()`` -> ``c.result()``, with the keys
    of ``hlo_parse.analyze``'s result."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._storages = WeakIdKeyDictionary()
        self.dot_flops = 0.0
        self.bytes: dict[str, float] = defaultdict(float)
        self.counts: dict[str, float] = defaultdict(float)
        self.sites: dict[tuple, list] = defaultdict(lambda: [0, 0.0])
        self._kinds = _kinds()

    def track(self, *held) -> None:
        """Count the storages of ``held`` (tensors, DTensors, modules'
        parameters and buffers, or containers of them) as live."""
        for x in held:
            if isinstance(x, torch.nn.Module):
                self.track(*x.parameters(), *x.buffers())
            elif isinstance(x, torch.Tensor):
                self._hold(_local(x))
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
        # ops that run under another fake mode than the one active here
        # are DTensor's sharding propagation, on global shapes
        self._fake = active_fake_mode()
        _watch_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _unwatch_propagation()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING[0] or active_fake_mode() is not self._fake:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        packet = func._overloadpacket
        if packet in DOTS:
            self.dot_flops += DOTS[packet](*args)
        elif packet in self._kinds:
            kind, where = self._kinds[packet]
            result = out if where == "out" else args[0]
            payload = _nbytes(result) * (2.0 if kind == "all-reduce" else 1.0)
            self.bytes[kind] += payload
            self.counts[kind] += 1
            site = self.sites[(kind, _describe(result))]
            site[0] += 1
            site[1] += payload
        return out

    def result(self) -> dict:
        """Per-device totals: ``dot_flops``, ``collective_bytes`` and
        ``collective_counts`` by kind, ``collective_bytes_total``,
        ``top_collectives``."""
        return summary(self.dot_flops, self.bytes, self.counts, self.sites)


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

