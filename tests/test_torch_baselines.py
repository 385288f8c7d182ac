"""``repro_torch.baselines`` against ``repro.baselines``: the naive
per-filter chain and reconstruction, van Herk/Gil-Werman, the pixel pump
and the queue reconstruction give the reference's arrays on small seeded
images (uint8, uint16, float32), and ``vhgw`` at s equals the port's
s-step chain of 3×3 filters on both engines (the (2s+1)² window).  The
port runs on the CPU (``device="cpu"``); without it, the naive baseline
raises instead of running there.
"""
import numpy as np
import pytest
import torch

from repro.baselines import naive as RN
from repro.baselines import pixel_pump as RP
from repro.baselines import queue_reconstruction as RQ
from repro.baselines import vhgw as RV
from repro_torch.api import E, compile
from repro_torch.baselines import naive as TN
from repro_torch.baselines import pixel_pump as TP
from repro_torch.baselines import queue_reconstruction as TQ
from repro_torch.baselines import vhgw as TV

DTYPES = (np.uint8, np.uint16, np.float32)
IDS = [d.__name__ for d in DTYPES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (see
    ``tests/test_torch_api.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(dtype, shape=(2, 19, 27), seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.random(shape).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, shape, endpoint=True,
                        dtype=dtype)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("op", ("erode", "dilate"))
def test_naive_chain_equals_the_reference(dtype, op):
    f = _image(dtype)
    got = TN.chain(_t(f), 5, op, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(RN.chain(f, 5, op)))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("op", ("erode", "dilate"))
def test_naive_reconstruct_equals_the_reference(dtype, op):
    m = _image(dtype, seed=1)
    top = 1.0 if dtype == np.float32 else float(np.iinfo(dtype).max)
    h = 0.2 * top
    # HMAX's marker (m - h) for a dilation, HMIN's (m + h) for an erosion
    marker = m.astype(np.float64) + (-h if op == "dilate" else h)
    f = np.clip(marker, 0.0, top).astype(dtype)
    got = TN.reconstruct(_t(f), _t(m), op, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(RN.reconstruct(f, m, op)))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("s", (0, 1, 2, 5, 13))
def test_vhgw_equals_the_reference(dtype, s):
    f = _image(dtype, shape=(2, 23, 31), seed=s)
    for op in ("erode", "dilate"):
        got = TV.minmax_filter(_t(f), s, op)
        assert got.dtype == _t(f).dtype
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(RV.minmax_filter(f, s, op)))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
@pytest.mark.parametrize("s", (1, 3, 7))
def test_vhgw_equals_the_chain(dtype, s):
    """s elementary 3×3 steps give the (2s+1)² window: the O(1) filter
    and the port's chains agree on both engines."""
    f = _t(_image(dtype, shape=(2, 40, 45), seed=7))
    want = TV.erode(f, s)
    for backend in ("cuda", "torch"):
        exe = compile(E.erode(s, E.input("f")), f.shape, f.dtype, backend,
                      device="cpu")
        assert torch.equal(exe(f), want), backend
    assert torch.equal(TV.dilate(f, s), compile(
        E.dilate(s, E.input("f")), f.shape, f.dtype, device="cpu")(f))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_pixel_pump_equals_the_reference(dtype):
    f = _image(dtype, shape=(17, 23), seed=3)
    for s in (1, 3):
        for op in ("erode", "dilate"):
            np.testing.assert_array_equal(TP.minmax_filter(f, s, op),
                                          RP.minmax_filter(f, s, op))
    np.testing.assert_array_equal(TP.chain(f, 2), RP.chain(f, 2))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_queue_reconstruction_equals_the_reference(dtype):
    m = _image(dtype, shape=(15, 21), seed=4)
    f = np.zeros_like(m)
    f[7, 10] = m[7, 10]
    np.testing.assert_array_equal(TQ.dilate_reconstruct(f, m),
                                  RQ.dilate_reconstruct(f, m))
    g = np.full_like(m, m.max())
    g[3, 4] = m[3, 4]
    np.testing.assert_array_equal(TQ.erode_reconstruct(g, m),
                                  RQ.erode_reconstruct(g, m))


def test_naive_runs_on_the_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default runs there")
    x = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.chain(x, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.reconstruct(x, x)
    assert TN.chain(x, 2, device="cpu").device.type == "cpu"
