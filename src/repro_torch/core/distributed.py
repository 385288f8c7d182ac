"""Distributed geodesic morphology on ``torch.distributed`` (port of
``repro.core.distributed``): the paper's pipeline, scaled out.

The image is split in contiguous row/column blocks over a
:class:`RankGrid` of ranks, one process per rank (SPMD): each rank holds
its block and calls the same function on it.  Rank ``r·cols + c`` holds
block ``(r, c)``, the row-major device order of the reference's
``jax.make_mesh((rows, cols))`` with ``P("r", "c")``.

Every K fused elementary steps each rank exchanges a K-deep halo with
its grid neighbours (the reference's ``ppermute``): K rows first, then
K columns of the *row-extended* block, so the corner data arrives
through the column neighbour (two-phase exchange).  The fused kernels
then run K steps on the halo-extended block (``ops.morph_chain`` →
``chain_step``, ``ops.geodesic_chain`` → ``geodesic_chain_step``) and
the halo is cropped off.  Global edges get the lattice identity, so
the result equals the single-device chain bit for bit.

Convergence of the reconstruction is an ``all_reduce`` of the ranks'
changed flags (the reference's ``psum``) read once a chunk on the host.

Transport follows the group's backend: NCCL carries CUDA blocks as
they are (one rank per GPU, after ``torch.cuda.set_device``); gloo
carries host tensors, so a CUDA block's halo strips go through host
buffers while the compute stays on the card.  Nothing falls back to
the CPU: the entry points take ``device=`` like every port entry point
(``None`` is the GPU and raises without one).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import morphology as M
from repro_torch.core.backend import resolve_device
from repro_torch.core.chain import plan_chain
from repro_torch.kernels import ops
from repro_torch.kernels.common import (as_bits, bits_value, from_bits,
                                        ident_for)


@dataclasses.dataclass(frozen=True)
class RankGrid:
    """A ``rows × cols`` grid of the ranks of ``group`` (the default
    group when None); the counterpart of ``(mesh, row_axes, col_axes)``.

    ``cols=None`` is the reference's ``col_axes=None``: blocks are full
    width and get no column halo.  The grid is a description: it touches
    the process group only when a rank runs a function on it.
    """

    rows: int
    cols: int | None = None
    group: object = None

    def __post_init__(self):
        if self.rows < 1 or (self.cols is not None and self.cols < 1):
            raise ValueError(f"grid must be at least 1x1, got "
                             f"{self.rows}x{self.cols}")

    @property
    def shape(self) -> tuple[int, int]:
        return self.rows, self.cols or 1

    @property
    def size(self) -> int:
        return self.rows * (self.cols or 1)

    def coords(self, rank: int) -> tuple[int, int]:
        """Block ``(r, c)`` of group rank ``rank``."""
        return divmod(rank, self.shape[1])

    def rank(self) -> int:
        """This process's rank in the grid's group (raises outside it or
        when the group does not have ``rows × cols`` ranks)."""
        if not dist.is_initialized():
            raise RuntimeError("RankGrid: torch.distributed is not "
                               "initialized (init_process_group first)")
        rank = dist.get_rank(self.group)
        if rank < 0:
            raise RuntimeError("RankGrid: this process is not in the "
                               "grid's group")
        world = dist.get_world_size(self.group)
        if world != self.size:
            raise ValueError(f"RankGrid {self.rows}x{self.cols} needs "
                             f"{self.size} ranks, the group has {world}")
        return rank

    def peer(self, r: int, c: int) -> int:
        """The global rank of block ``(r, c)``, as ``P2POp`` takes it."""
        rank = r * self.shape[1] + c
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)


def _split(shape, grid: RankGrid) -> tuple[int, int]:
    h, w = shape[-2:]
    rows, cols = grid.shape
    if h % rows or w % cols:
        raise ValueError(f"image {h}x{w} does not split into a "
                         f"{rows}x{cols} grid of equal blocks")
    return h // rows, w // cols


def scatter_blocks(image, grid: RankGrid, rank: int):
    """Block of group rank ``rank`` of a whole (H, W) ``image`` (a view:
    nothing is copied or sent)."""
    bh, bw = _split(image.shape, grid)
    r, c = grid.coords(rank)
    return image[r * bh:(r + 1) * bh, c * bw:(c + 1) * bw]


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


def on_host(group, device: torch.device) -> bool:
    """Whether ``group`` (None: the default group) carries ``device``'s
    tensors through host buffers (gloo with a CUDA tensor).  Raises
    where it cannot carry them at all."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group carries CUDA tensors only; "
                             f"the tensor is on {device}")
        return False
    if backend == "gloo":
        return device.type == "cuda"
    if backend == "fake":
        # torch's fake group (the dry run's): takes any tensor, moves
        # nothing
        return False
    raise ValueError(f"repro_torch's collectives run on gloo or nccl "
                     f"groups, got {backend!r}")


def _wire(x: torch.Tensor, host: bool) -> torch.Tensor:
    """``x`` as the contiguous bytes a group sends (every dtype, uint16
    included, travels as uint8)."""
    x = x.contiguous()
    return (x.cpu() if host else x).view(torch.uint8)


def _exchange_axis(local: torch.Tensor, k: int, grid: RankGrid, rank: int,
                   fill, axis: int, host: bool) -> torch.Tensor:
    """Attach a k-deep halo along ``axis`` from the grid neighbours
    (global edges get ``fill``); an axis of one rank only pads."""
    n = grid.shape[axis]
    bits = as_bits(local)
    edge = list(bits.shape)
    edge[axis] = k
    from_prev = torch.full(edge, bits_value(fill, local.dtype),
                           dtype=bits.dtype, device=local.device)
    from_next = from_prev.clone()
    if n > 1:
        rc = list(grid.coords(rank))
        idx = rc[axis]

        def peer(step):
            at = list(rc)
            at[axis] += step
            return grid.peer(*at)

        p2p, recv = [], {}
        # my head goes to the previous block, whose tail comes back; my
        # tail goes to the next block, whose head comes back
        for side, step, start in (("prev", -1, 0),
                                  ("next", 1, local.shape[axis] - k)):
            if not 0 <= idx + step < n:
                continue
            sent = _wire(bits.narrow(axis, start, k), host)
            recv[side] = torch.empty_like(sent)
            p2p += [dist.P2POp(dist.isend, sent, peer(step), grid.group,
                               tag=axis),
                    dist.P2POp(dist.irecv, recv[side], peer(step),
                               grid.group, tag=axis)]
        for req in dist.batch_isend_irecv(p2p):
            req.wait()
        strips = {side: buf.to(local.device).view(bits.dtype).reshape(edge)
                  for side, buf in recv.items()}
        from_prev = strips.get("prev", from_prev)
        from_next = strips.get("next", from_next)
    return from_bits(torch.cat([from_prev, bits, from_next], dim=axis),
                     local.dtype)


def exchange_halo(local: torch.Tensor, k: int, grid: RankGrid,
                  fill) -> torch.Tensor:
    """Two-phase 2-D halo exchange (rows, then row-extended columns);
    every rank of the grid calls it together."""
    _check_depth(k, local.shape, grid)
    rank = grid.rank()
    host = on_host(grid.group, local.device)
    out = _exchange_axis(local, k, grid, rank, fill, 0, host)
    if grid.cols is not None:
        out = _exchange_axis(out, k, grid, rank, fill, 1, host)
    return out


def _crop(ext: torch.Tensor, k: int, has_cols: bool) -> torch.Tensor:
    if has_cols:
        return ext[k:-k, k:-k]
    return ext[k:-k, :]


def gather_blocks(local: torch.Tensor, grid: RankGrid) -> torch.Tensor:
    """The whole image on every rank, from each rank's block (an
    ``all_gather``; a collective every rank of the grid calls)."""
    grid.rank()
    host = on_host(grid.group, local.device)
    wire = _wire(local, host)
    parts = [torch.empty_like(wire) for _ in range(grid.size)]
    dist.all_gather(parts, wire, group=grid.group)
    bits = as_bits(local)
    blocks = [p.to(local.device).view(bits.dtype).reshape(local.shape)
              for p in parts]
    rows, cols = grid.shape
    image = torch.cat([torch.cat(blocks[r * cols:(r + 1) * cols], dim=1)
                       for r in range(rows)], dim=0)
    return from_bits(image, local.dtype)


def _local(local, device) -> torch.Tensor:
    x = torch.as_tensor(local, device=resolve_device(device))
    if x.ndim != 2:
        raise ValueError(f"expected a local (h, w) block, got shape "
                         f"{tuple(x.shape)}")
    return x


def _check_depth(k: int, shape, grid: RankGrid) -> None:
    """A halo is cut from the neighbour's block: it cannot be deeper
    (checked before any collective, so every rank raises alike)."""
    rows, cols = grid.shape
    if (rows > 1 and k > shape[0]) or (cols > 1 and k > shape[1]):
        raise ValueError(f"a halo of k={k} is deeper than the local block "
                         f"{tuple(shape)}; pass a smaller fuse_k or use "
                         "fewer ranks")


# ---------------------------------------------------------------------------
# distributed fixed-length chains
# ---------------------------------------------------------------------------


def distributed_chain(grid: RankGrid, *, n: int, op: str = "erode",
                      backend: str | None = None, fuse_k: int | None = None,
                      device=None):
    """An n-step elementary chain over ``grid``: returns ``fn(local) ->
    local``, which every rank calls on its (h, w) block.

    ``backend`` is the port's engine (``None`` is ``"cuda"``, which
    launches ``chain_step`` on CUDA blocks and runs its plain version on
    CPU blocks); ``device=None`` is the GPU.
    """
    def run(local):
        x = _local(local, device)
        k = fuse_k or plan_chain(x.shape[0], x.shape[1], x.dtype, n).fuse_k
        fill = ident_for(op, x.dtype)
        # n // k chunks of k steps, then the remainder as one shallower
        # chunk (the reference runs it on its oracle; the engine's
        # chains are exact at any depth)
        for depth in [k] * (n // k) + [n % k] * bool(n % k):
            ext = exchange_halo(x, depth, grid, fill)
            ext = ops.morph_chain(ext, depth, op, backend, device=x.device)
            x = _crop(ext, depth, grid.cols is not None)
        return x

    return run


# ---------------------------------------------------------------------------
# distributed reconstruction (geodesic, to convergence)
# ---------------------------------------------------------------------------


def distributed_reconstruct(grid: RankGrid, *, op: str = "erode",
                            backend: str | None = None,
                            fuse_k: int | None = None,
                            max_chunks: int | None = None, device=None):
    """ε_rec / δ_rec over ``grid``: returns ``fn(marker, mask) ->
    local``, which every rank calls on its blocks.  After a call,
    ``fn.chunks`` is the number of K-chunks it ran.

    The loop ends when no rank's block changed in a chunk, or after
    ``max_chunks`` chunks (``(H·W) // K + 2`` of the whole image when
    None).  As in the reference, a NaN pixel counts as changed in every
    chunk (``nxt != x``), so an image with NaN runs to the limit.
    """
    def run(marker, mask):
        x, m = _local(marker, device), _local(mask, device)
        if x.shape != m.shape:
            raise ValueError(f"marker block {tuple(x.shape)} != mask block "
                             f"{tuple(m.shape)}")
        k = fuse_k or plan_chain(x.shape[0], x.shape[1], x.dtype, None,
                                 n_images_resident=2).fuse_k
        fill = ident_for(op, x.dtype)
        # the mask halo is constant: exchange it once, reuse every chunk
        m_ext = exchange_halo(m, k, grid, fill)
        limit = max_chunks
        if limit is None:
            # pixel-count bound, like kernels.ops.reconstruct: geodesic
            # paths under a serpentine mask can exceed the H+W diameter
            rows, cols = grid.shape
            limit = (x.shape[0] * rows * x.shape[1] * cols) // k + 2
        host = on_host(grid.group, x.device)
        it, changed = 0, True
        while changed and it < limit:
            ext = exchange_halo(x, k, grid, fill)
            ext = ops.geodesic_chain(ext, m_ext, k, op, backend,
                                     device=x.device)
            nxt = _crop(ext, k, grid.cols is not None)
            flag = M.not_equal(nxt, x).any().to(torch.int32).reshape(1)
            flag = flag.cpu() if host else flag
            dist.all_reduce(flag, group=grid.group)
            changed = bool(flag.item() > 0)  # the chunk's one host read
            x, it = nxt, it + 1
        run.chunks = it
        return x

    run.chunks = 0
    return run


@contextlib.contextmanager
def file_group(path, rank: int, world_size: int, backend: str = "gloo"):
    """This process as rank ``rank`` of a ``world_size``-rank default
    group that meets through a ``FileStore`` at ``path`` (no port to
    pick, so parallel runs cannot collide); destroyed on exit."""
    store = dist.FileStore(str(path), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
