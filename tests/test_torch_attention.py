"""The port's attention (``repro_torch.models.attention``) against the
reference's (``repro.models.attention``) on the same seeded numpy
inputs: ``flash_attention`` on the cases of ``tests/test_attention.py``
(GQA causal, MQA with a sliding window, cross attention with ragged
lengths, a length that is not a multiple of the chunk) and
``decode_attention`` at several positions, with and without a window.

Tolerance in float32: max |port − reference| ≤ 1e-4 × max |reference|
(measured at most 3.3e-7 of it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch.models import attention as A

TOL = 1e-4

CASES = [
    (64, 64, 4, 2, 16, True, None, 16),     # GQA causal
    (64, 64, 4, 1, 16, True, 16, 16),       # MQA sliding window
    (48, 32, 4, 4, 8, False, None, 16),     # cross, ragged
    (100, 100, 8, 2, 32, True, None, 32),   # non-multiple length
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    on one machine otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got: torch.Tensor, ref, tol: float = TOL) -> None:
    ref = np.asarray(ref, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def qkv_inputs(seed, b, sq, sk, h, kv, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd))]


@pytest.mark.parametrize("sq,sk,h,kv,hd,causal,window,qc", CASES)
def test_flash_attention_equals_reference(sq, sk, h, kv, hd, causal, window,
                                          qc):
    q, k, v = qkv_inputs(0, 2, sq, sk, h, kv, hd)
    ref = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window, q_chunk=qc,
                             kv_chunk=qc)
    got = A.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            window=window, q_chunk=qc, kv_chunk=qc)
    assert_close(got, ref)


def test_flash_tiles_are_the_reference_list():
    """Lower triangle, two-block band (block 0's first tile a
    placeholder), full grid."""
    assert A.flash_tiles(3, 3, True, None) == [
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (2, 0, 1), (2, 1, 1), (2, 2, 1)]
    assert A.flash_tiles(3, 3, True, 16) == [
        (0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (2, 1, 1), (2, 2, 1)]
    assert A.flash_tiles(2, 3, False, None) == [
        (0, 0, 1), (0, 1, 1), (0, 2, 1), (1, 0, 1), (1, 1, 1), (1, 2, 1)]


@pytest.mark.parametrize("window,q_chunk,kv_chunk", [
    (32, 16, 16), (16, 16, 32)])
def test_flash_window_needs_window_le_kv_chunk_eq_q_chunk(window, q_chunk,
                                                          kv_chunk):
    q, k, v = (torch.from_numpy(a) for a in qkv_inputs(1, 1, 64, 64, 2, 1,
                                                        8))
    with pytest.raises(ValueError, match="window <= kv_chunk == q_chunk"):
        A.flash_attention(q, k, v, window=window, q_chunk=q_chunk,
                          kv_chunk=kv_chunk)


@pytest.mark.parametrize("pos", [0, 5, 37, 63])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1)])
def test_decode_attention_equals_reference(pos, window, h, kv):
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 1, h, 16), dtype=np.float32)
    kc = rng.standard_normal((2, 64, kv, 16), dtype=np.float32)
    vc = rng.standard_normal((2, 64, kv, 16), dtype=np.float32)
    ref = RA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.int32(pos), window)
    got = A.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), pos, window)
    assert_close(got, ref)
