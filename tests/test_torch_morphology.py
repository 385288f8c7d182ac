"""The port's oracles (``repro_torch.core.morphology``) against the
reference's (``repro.core.morphology``): same seeded NumPy inputs,
``array_equal`` on the outputs, uint8/uint16/float32 on 2-D images and
(N, H, W) stacks.  float64 is held against the port's own oracle,
because the reference computes float64 as float32 (no x64 in JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import morphology as RM
from repro_torch.core import chain as TC
from repro_torch.core import morphology as TM
from repro_torch.kernels import ops as TO

DTYPES = (np.uint8, np.uint16, np.float32)
SHAPES = ((13, 17), (2, 9, 11))
#: every dtype on a stack, uint8 on a 2-D image too
CASES = [(np.uint8, SHAPES[0]), *((d, SHAPES[1]) for d in DTYPES)]
CASE_IDS = ["uint8-2d", "uint8-3d", "uint16-3d", "float32-3d"]


def _rand(rng, shape, dtype):
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape,
                        endpoint=True).astype(dtype)


def _same(ref, port):
    return np.array_equal(np.asarray(ref), port.numpy(), equal_nan=True)


@pytest.mark.parametrize("dtype,shape", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("name,args", [
    ("erode3", ()), ("dilate3", ()), ("erode3_direct", ()),
    ("dilate3_direct", ()), ("erode", (3,)), ("dilate", (4,)),
    ("opening", (2,)), ("closing", (2,)),
])
def test_unary_oracles_match_reference(name, args, dtype, shape):
    x = _rand(np.random.default_rng(1), shape, dtype)
    ref = getattr(RM, name)(jnp.asarray(x), *args)
    port = getattr(TM, name)(torch.from_numpy(x), *args)
    assert port.dtype == torch.from_numpy(x).dtype
    assert _same(ref, port)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("axis", (-1, -2))
def test_one_dimensional_passes_match_reference(dtype, axis):
    x = _rand(np.random.default_rng(2), SHAPES[1], dtype)
    for name in ("erode1d", "dilate1d"):
        assert _same(getattr(RM, name)(jnp.asarray(x), axis),
                     getattr(TM, name)(torch.from_numpy(x), axis))


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_geodesic_and_reconstruction_match_reference(dtype, shape):
    rng = np.random.default_rng(3)
    mask = _rand(rng, shape, dtype)
    lo = np.minimum(_rand(rng, shape, dtype), mask)   # marker ≤ mask
    hi = np.maximum(_rand(rng, shape, dtype), mask)   # marker ≥ mask
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    for name, f in (("geodesic_dilate", lo), ("geodesic_erode", hi)):
        assert _same(getattr(RM, name)(jnp.asarray(f), jm, 3),
                     getattr(TM, name)(torch.from_numpy(f), tm, 3))
    for name, f in (("dilate_reconstruct", lo), ("erode_reconstruct", hi)):
        assert _same(getattr(RM, name)(jnp.asarray(f), jm),
                     getattr(TM, name)(torch.from_numpy(f), tm))
        ref, ref_it = getattr(RM, name + "_with_iters")(jnp.asarray(f), jm)
        port, port_it = getattr(TM, name + "_with_iters")(
            torch.from_numpy(f), tm)
        assert _same(ref, port) and int(ref_it) == int(port_it)
    # a truncated reconstruction stops after exactly max_iters steps
    ref, ref_it = RM.dilate_reconstruct_with_iters(jnp.asarray(lo), jm, 2)
    port, port_it = TM.dilate_reconstruct_with_iters(torch.from_numpy(lo),
                                                     tm, 2)
    assert _same(ref, port) and int(ref_it) == int(port_it)


@pytest.mark.parametrize("dtype", DTYPES + (np.float64,),
                         ids=lambda d: np.dtype(d).name)
def test_lattice_identities_match_reference(dtype):
    td = torch.from_numpy(np.zeros(1, dtype)).dtype
    if dtype == np.float64:   # the reference's float64 is float32
        assert TM.lattice_top(td).item() == float("inf")
        assert TM.lattice_bottom(td).item() == float("-inf")
        return
    assert TM.lattice_top(td).item() == RM.lattice_top(dtype).item()
    assert TM.lattice_bottom(td).item() == RM.lattice_bottom(dtype).item()


def test_nan_propagates_like_jnp():
    x = np.arange(30, dtype=np.float32).reshape(5, 6)
    x[2, 3] = np.nan
    m = np.full_like(x, 4.0)
    assert _same(RM.erode3(jnp.asarray(x)), TM.erode3(torch.from_numpy(x)))
    assert _same(RM.geodesic_dilate1(jnp.asarray(x), jnp.asarray(m)),
                 TM.geodesic_dilate1(torch.from_numpy(x), torch.from_numpy(m)))


def test_uint16_extremes_survive_widening():
    x = np.array([[0, 65535, 1], [65534, 2, 65535]], np.uint16)
    assert _same(RM.dilate3(jnp.asarray(x)), TM.dilate3(torch.from_numpy(x)))
    assert _same(RM.erode3(jnp.asarray(x)), TM.erode3(torch.from_numpy(x)))


@pytest.mark.parametrize("op", ("erode", "dilate"))
def test_float64_kernel_path_matches_own_oracle(op):
    """float64 runs natively in the port: the padded engine (plain kernel
    versions on the CPU) against the port's float64 oracle."""
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.standard_normal((2, 21, 30)))
    plan = TC.ChainPlan(16, 8, 128, 32, 2, 3, n_images=2)
    got = TO.morph_chain(f, 19, op, "cuda", plan=plan, device="cpu")
    want = TM.erode(f, 19) if op == "erode" else TM.dilate(f, 19)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    m = f + 0.5 if op == "dilate" else f - 0.5
    marker = m - 1.0 if op == "dilate" else m + 1.0
    got = TO.geodesic_chain(marker, m, 11, op, "cuda", plan=plan,
                            device="cpu")
    step = TM.geodesic_dilate if op == "dilate" else TM.geodesic_erode
    assert torch.equal(got, step(marker, m, 11))


@pytest.mark.parametrize("n", (1, 7, 23, 47))
def test_chain_remainder_runs_as_kernel_steps(n):
    """A fixed chain's remainder past its full K-chunks runs as kernel
    steps of powers of two that divide ``band_h`` (here fuse_k = 24, so
    16 does not divide the 72-row bands), and the padded engine still
    equals the reference's oracle."""
    plan = TC.ChainPlan(72, 24, 128, 72, 1, 2, n_images=2)
    ks = TO.chain_chunks(n, plan)
    assert sum(ks) == n
    assert all(k <= plan.fuse_k and plan.band_h % k == 0 for k in ks)
    rng = np.random.default_rng(n)
    f = torch.from_numpy(rng.integers(0, 256, (2, 60, 100)).astype(np.uint8))
    got = TO.morph_chain(f, n, "erode", "cuda", plan=plan, device="cpu")
    assert _same(RM.erode(jnp.asarray(f.numpy()), n), got)
    marker = torch.minimum(f, torch.full_like(f, 90))
    got = TO.geodesic_chain(marker, f, n, "dilate", "cuda", plan=plan,
                            device="cpu")
    assert _same(RM.geodesic_dilate(jnp.asarray(marker.numpy()),
                                    jnp.asarray(f.numpy()), n), got)
