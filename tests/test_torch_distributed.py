"""``repro_torch.core.distributed`` against the reference, on the CPU.

Four ranks are spawned once (``torch.multiprocessing.spawn``, gloo, a
``FileStore`` in ``tmp_path``) and run every case of the module on
2×2, 4×1 (``cols=None``) and 1×2 grids (the 1×2 one on a two-rank
subgroup): erosion and dilation chains of n = 9 with ``fuse_k=4`` and
of n = 40 with the plan's K (each with a remainder chunk), and both
reconstructions, in uint8 and float32, on both engines (``"torch"``,
and ``"cuda"`` whose wrappers run their plain versions on CPU blocks).
Each gathered image must equal ``repro.core.morphology`` on the same
numpy inputs, as the reference's own ``tests/test_distributed.py``
holds its ``distributed_*``.  One case with NaN and ``max_chunks=3`` is held
against the reference's ``distributed_reconstruct`` itself, run in a
subprocess with four fake XLA devices.  The ranks never build a kernel:
CPU blocks take the plain versions.
"""
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core import morphology as RM
from repro_torch.core import distributed as D

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
WORLD = 4
SIZE = 96
NAN_CHUNKS = 3


def _inputs() -> dict:
    rng = np.random.default_rng(3)
    u8 = [rng.integers(0, 256, (SIZE, SIZE), np.uint8) for _ in range(2)]
    f32 = [rng.normal(size=(SIZE, SIZE)).astype(np.float32)
           for _ in range(2)]
    nan = [a.copy() for a in f32]
    nan[0][rng.random((SIZE, SIZE)) < 0.01] = np.nan
    return {"uint8": u8, "float32": f32, "nan": nan}


def _cases() -> list:
    cases = []
    for grid in ("2x2", "4x1", "1x2"):
        for dtype in ("uint8", "float32"):
            for op in ("erode", "dilate"):
                for engine in ("torch", "cuda"):
                    tail = f"{grid}-{op}-{dtype}-{engine}"
                    cases.append(dict(name=f"chain-{tail}", kind="chain",
                                      grid=grid, input=dtype, op=op,
                                      engine=engine, n=9, fuse_k=4))
                    cases.append(dict(name=f"rec-{tail}", kind="rec",
                                      grid=grid, input=dtype, op=op,
                                      engine=engine, fuse_k=4,
                                      max_chunks=None))
    for dtype in ("uint8", "float32"):  # K from the plan (32 / 16)
        cases.append(dict(name=f"chain-plan-k-{dtype}", kind="chain",
                          grid="2x2", input=dtype, op="erode",
                          engine="cuda", n=40, fuse_k=None))
        cases.append(dict(name=f"rec-plan-k-{dtype}", kind="rec",
                          grid="2x2", input=dtype, op="erode",
                          engine="cuda", fuse_k=None, max_chunks=None))
    for engine in ("torch", "cuda"):
        cases.append(dict(name=f"rec-nan-{engine}", kind="rec", grid="2x2",
                          input="nan", op="erode", engine=engine, fuse_k=4,
                          max_chunks=NAN_CHUNKS))
    return cases


CASES = {c["name"]: c for c in _cases()}

#: The reference's own distributed reconstruction on the NaN inputs.
REFERENCE_NAN = """
    import sys
    import numpy as np, jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core import distributed as D

    marker, mask = np.load(sys.argv[1]), np.load(sys.argv[2])
    mesh = jax.make_mesh((2, 2), ("r", "c"))
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("r", "c")))
    rec = D.distributed_reconstruct(mesh, "r", "c", op="erode",
                                    backend="xla", fuse_k=4,
                                    max_chunks={chunks})
    np.save(sys.argv[3], np.asarray(rec(put(marker), put(mask))))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's gathered image and chunk count, from one spawn of
    four ranks, and the reference's NaN result (its subprocess runs
    beside the ranks)."""
    tmp = tmp_path_factory.mktemp("dist")
    inputs = _inputs()
    f, m = inputs["nan"]
    np.save(tmp / "marker.npy", np.maximum(f, m))
    np.save(tmp / "mask.npy", m)
    env = dict(os.environ, PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c",
         textwrap.dedent(REFERENCE_NAN.format(chunks=NAN_CHUNKS)),
         str(tmp / "marker.npy"), str(tmp / "mask.npy"),
         str(tmp / "ref_nan.npy")],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_spawn_target(), args=(WORLD, str(tmp / "store"),
                                        list(CASES.values()), inputs,
                                        str(tmp)),
                 nprocs=WORLD, join=True)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    out = {}
    for name in CASES:
        with np.load(tmp / f"{name}.npz") as z:
            out[name] = (z["out"], int(z["chunks"]))
    return out, np.load(tmp / "ref_nan.npy"), inputs


def _spawn_target():
    import torch_distributed_ranks  # tests/ is on sys.path under pytest

    return torch_distributed_ranks.run_cases


def _expected(case: dict, inputs: dict) -> np.ndarray:
    f, m = (jnp.asarray(a) for a in inputs[case["input"]])
    if case["kind"] == "chain":
        body = RM.erode if case["op"] == "erode" else RM.dilate
        return np.asarray(body(f, case["n"]))
    if case["op"] == "erode":
        return np.asarray(RM.erode_reconstruct(jnp.maximum(f, m), m))
    return np.asarray(RM.dilate_reconstruct(jnp.minimum(f, m), m))


@pytest.mark.parametrize("name", [n for n in CASES if "nan" not in n])
def test_distributed_equals_the_reference(runs, name):
    results, _, inputs = runs
    case = CASES[name]
    got, chunks = results[name]
    want = _expected(case, inputs)
    assert got.dtype == want.dtype and got.shape == (SIZE, SIZE)
    assert np.array_equal(got, want)
    if case["kind"] == "rec":  # converged well inside the pixel bound
        k = case["fuse_k"] or (32 if case["input"] == "uint8" else 16)
        assert 0 < chunks < SIZE * SIZE // k + 2


@pytest.mark.parametrize("engine", ("torch", "cuda"))
def test_nan_never_settles_as_in_the_reference(runs, engine):
    """A NaN pixel keeps ``nxt != x`` true, so the loop runs to
    ``max_chunks``; the truncated result equals the reference's."""
    results, ref, _ = runs
    got, chunks = results[f"rec-nan-{engine}"]
    assert chunks == NAN_CHUNKS
    assert np.isnan(ref).any()
    assert np.array_equal(got, ref, equal_nan=True)


# ---------------------------------------------------------------------------
# single-process cases
# ---------------------------------------------------------------------------


def test_halo_deeper_than_the_block_raises():
    """Checked before any collective (no process group here)."""
    x = torch.zeros((16, 16), dtype=torch.uint8)
    chain = D.distributed_chain(D.RankGrid(2, 2), n=40, fuse_k=20,
                                device="cpu")
    with pytest.raises(ValueError, match=r"k=20 .* \(16, 16\)"):
        chain(x)
    # the plan's K for uint8 reconstruction is 32
    rec = D.distributed_reconstruct(D.RankGrid(1, 2), device="cpu")
    with pytest.raises(ValueError, match=r"k=32 .* \(16, 16\)"):
        rec(x, x)


def test_indivisible_image_and_bad_grids_raise():
    with pytest.raises(ValueError, match="does not split"):
        D.scatter_blocks(np.zeros((5, 8)), D.RankGrid(2, 2), 0)
    with pytest.raises(ValueError, match="does not split"):
        D.scatter_blocks(np.zeros((8, 6)), D.RankGrid(1, 4), 3)
    with pytest.raises(ValueError, match="at least 1x1"):
        D.RankGrid(0)
    block = D.scatter_blocks(np.arange(48).reshape(6, 8), D.RankGrid(3), 2)
    assert block.tolist() == np.arange(32, 48).reshape(2, 8).tolist()
    with pytest.raises(RuntimeError, match="not initialized"):
        D.RankGrid(1, 1).rank()


def test_groups_that_cannot_carry_the_block_raise(monkeypatch):
    """NCCL carries CUDA blocks as they are, gloo carries host tensors
    (a CUDA block through host buffers); nothing else is taken."""
    grid = D.RankGrid(1, 2)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    monkeypatch.setattr(D.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="NCCL group carries CUDA"):
        D.on_host(grid.group, cpu)
    assert not D.on_host(grid.group, cuda)
    monkeypatch.setattr(D.dist, "get_backend", lambda group=None: "mpi")
    with pytest.raises(ValueError, match="gloo or nccl"):
        D.on_host(grid.group, cpu)
    monkeypatch.setattr(D.dist, "get_backend", lambda group=None: "gloo")
    assert D.on_host(grid.group, cuda) and not D.on_host(grid.group, cpu)


def test_one_rank_group_runs_on_the_cpu_and_wants_the_gpu_by_default(
        tmp_path):
    """In a one-rank gloo group: ``device="cpu"`` runs (a 1×1 grid only
    pads), ``device=None`` is the GPU and raises without one, and a grid
    larger than the group raises."""
    rng = np.random.default_rng(5)
    f = rng.integers(0, 256, (20, 30), np.uint8)
    with D.file_group(tmp_path / "store", 0, 1):
        grid = D.RankGrid(1, 1)
        got = D.distributed_chain(grid, n=5, op="dilate", device="cpu")(
            torch.from_numpy(f))
        assert np.array_equal(got.numpy(),
                              np.asarray(RM.dilate(jnp.asarray(f), 5)))
        assert torch.equal(D.gather_blocks(got, grid), got)
        with pytest.raises(ValueError, match="needs 2 ranks"):
            D.distributed_chain(D.RankGrid(2), n=2, fuse_k=2,
                                device="cpu")(torch.from_numpy(f))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                D.distributed_chain(grid, n=5)(torch.from_numpy(f))
            with pytest.raises(RuntimeError, match="no CUDA device"):
                D.distributed_reconstruct(grid)(torch.from_numpy(f),
                                                torch.from_numpy(f))
