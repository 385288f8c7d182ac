"""The port's operators with a per-image threshold ``h`` against the
reference: ``hmax`` and ``dome`` with a (2, 1, 1) ``h``, given as a
torch tensor and as a numpy array, on uint8, uint16 and float32 stacks,
on both port engines against the reference's matching engine (``"torch"``
against ``"xla"``, ``"cuda"`` against ``"pallas"``) and against per-image
scalar calls; ``sat_sub``/``sat_add`` with an array ``h`` against the
reference's.  Tiny shapes; the port runs on the CPU (``device="cpu"``).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as ROPS
from repro_torch.core import operators as TOPS

DTYPES = (np.uint8, np.uint16, np.float32)
IDS = [d.__name__ for d in DTYPES]
ENGINES = {"torch": "xla", "cuda": "pallas"}  # port engine: reference's
H_KINDS = {"tensor": torch.as_tensor, "numpy": np.asarray}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (see test_torch_qdt.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(dtype, seed=3):
    """A (2, 32, 32) stack and its (2, 1, 1) thresholds, one an image."""
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        f = rng.random((2, 32, 32)).astype(dtype)
        h = np.array([0.15, 0.4]).reshape(2, 1, 1)
    else:
        hi = 200 if dtype == np.uint8 else 60000
        f = rng.integers(0, hi, (2, 32, 32)).astype(dtype)
        h = np.array([hi // 10, hi // 3]).reshape(2, 1, 1)
    return f, h


@pytest.fixture(scope="module")
def reference():
    """The reference's hmax and dome of each stack on each engine."""
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for dtype in DTYPES:
            f, h = _stack(dtype)
            for op in ("hmax", "dome"):
                for engine in ENGINES.values():
                    out[op, dtype, engine] = np.asarray(getattr(ROPS, op)(
                        jnp.asarray(f), jnp.asarray(h), backend=engine))
    return out


@pytest.mark.parametrize("kind", H_KINDS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("op", ["hmax", "dome"])
def test_per_image_h_matches_reference(op, dtype, engine, kind, reference):
    f, h = _stack(dtype)
    got = getattr(TOPS, op)(torch.as_tensor(f), H_KINDS[kind](h),
                            backend=engine, device="cpu")
    assert got.dtype == torch.as_tensor(f).dtype
    assert np.array_equal(got.numpy(), reference[op, dtype, ENGINES[engine]])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("op", ["hmax", "dome"])
def test_per_image_h_matches_scalar_calls(op, dtype, engine):
    f, h = _stack(dtype)
    fn = getattr(TOPS, op)
    got = fn(torch.as_tensor(f), torch.as_tensor(h), backend=engine,
             device="cpu")
    for i in range(2):
        one = fn(torch.as_tensor(f[i]), h[i].item(), backend=engine,
                 device="cpu")
        assert torch.equal(got[i], one)
    # a 0-d tensor is a scalar: it embeds in the graph like h.item()
    zero_d = fn(torch.as_tensor(f), torch.tensor(h[1].item()),
                backend=engine, device="cpu")
    assert torch.equal(zero_d, fn(torch.as_tensor(f), h[1].item(),
                                  backend=engine, device="cpu"))


def test_per_image_h_folds_leading_dims():
    """A (2, 2, 32, 32) stack with a (2, 2, 1, 1) h: the leading
    dimensions fold into one stack and back, as in the reference."""
    f, _ = _stack(np.uint8)
    f4 = np.stack([f, f[::-1]])
    h4 = np.array([[20, 50], [70, 5]]).reshape(2, 2, 1, 1)
    want = np.asarray(ROPS.hmax(jnp.asarray(f4), jnp.asarray(h4)))
    got = TOPS.hmax(torch.as_tensor(f4), torch.as_tensor(h4),
                    backend="torch", device="cpu")
    assert got.shape == f4.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", H_KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("op", ["sat_sub", "sat_add"])
def test_saturating_ops_broadcast_array_h(op, dtype, kind):
    f, h = _stack(dtype)
    if dtype != np.float32:  # thresholds that saturate both ways
        h = h * np.array([1, 3]).reshape(2, 1, 1)
    want = np.asarray(getattr(ROPS, op)(jnp.asarray(f), jnp.asarray(h)))
    got = getattr(TOPS, op)(torch.as_tensor(f), H_KINDS[kind](h))
    assert got.dtype == torch.as_tensor(f).dtype
    assert np.array_equal(got.numpy(), want)
