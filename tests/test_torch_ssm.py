"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the CPU.

One reference parameter tree at the reduced zamba2-7b's widths (d 64,
N 16, head_dim 16: d_in 128, 8 heads), its constant leaves perturbed so
that a dropped or misplaced one shows (``conv_b``, ``dt_bias`` and the
norm scale seeded, ``D`` around 1, ``A_log`` its log-linspace plus
seeded noise), goes into both packages; the same seeded numpy input
(B 2, S 32) goes through ``mamba2_apply`` at ``chunk=8`` — four chunks,
so the state carried from chunk to chunk matters — and then three
``mamba2_decode`` steps continue from each package's own state.

Tolerances, max |port − reference| against max |reference|, leaf by
leaf: 1e-4 in float32 and 2e-2 in bfloat16 (every leaf cast, as a served
model holds them; the state stays float32).  Measured at most 7.5e-7 in
float32 and 8.3e-3 in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RSSM
from repro_torch.models import convert
from repro_torch.models import ssm as SSM

D_MODEL, N_STATE, HEAD_DIM = 64, 16, 16
B, S, CHUNK, STEPS = 2, 32, 8, 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LEAVES = ("y", "state", "conv")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    on one machine otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got, ref) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     dtype=np.float32)
    ref = np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def reference_tree() -> dict:
    """``mamba2_init``'s float32 leaves, the constant ones perturbed."""
    tree = jax.tree.map(np.asarray, RSSM.mamba2_init(
        jax.random.PRNGKey(0), D_MODEL, N_STATE, HEAD_DIM, jnp.float32))
    rng = np.random.default_rng(0)

    def noise(x, scale):
        return (scale * rng.standard_normal(x.shape)).astype(np.float32)

    tree["conv_b"] = noise(tree["conv_b"], 0.2)
    tree["A_log"] = tree["A_log"] + noise(tree["A_log"], 0.3)
    tree["D"] = 1.0 + noise(tree["D"], 0.3)
    tree["dt_bias"] = noise(tree["dt_bias"], 0.5)
    tree["norm"]["scale"] = noise(tree["norm"]["scale"], 0.2)
    return tree


def port_block(tree, dtype) -> SSM.Mamba2:
    block = SSM.Mamba2(D_MODEL, N_STATE, HEAD_DIM, device="meta")
    block.load_state_dict(
        {k: torch.from_numpy(np.array(v)).to(dtype)
         for k, v in convert._flatten(tree).items()}, assign=True)
    return block


def inputs(length=S + STEPS, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, length, D_MODEL), dtype=np.float32)


def reference_run(dtype: str) -> dict:
    """``mamba2_apply`` over the first S tokens, then STEPS decode steps,
    each step's (y, state, conv)."""
    tree = reference_tree()
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    x = jnp.asarray(inputs(), dtype)
    apply = jax.jit(lambda p, x: RSSM.mamba2_apply(
        p, x, n_state=N_STATE, head_dim=HEAD_DIM, chunk=CHUNK))
    step = jax.jit(lambda p, x, st, cv: RSSM.mamba2_decode(
        p, x, st, cv, n_state=N_STATE, head_dim=HEAD_DIM))
    y, state, conv = apply(params, x[:, :S])
    out = {"tree": tree, "apply": dict(zip(LEAVES, (y, state, conv))),
           "decode": []}
    for t in range(S, S + STEPS):
        y, state, conv = step(params, x[:, t:t + 1], state, conv)
        out["decode"].append(dict(zip(LEAVES, (y, state, conv))))
    return out


@pytest.fixture(scope="module")
def reference():
    runs = {}

    def get(dtype):
        if dtype not in runs:
            runs[dtype] = reference_run(dtype)
        return runs[dtype]

    return get


def port_run(tree, dtype: str) -> dict:
    tdt = getattr(torch, dtype)
    block = port_block(tree, tdt)
    x = torch.from_numpy(inputs()).to(tdt)
    with torch.no_grad():
        y, state, conv = SSM.mamba2_apply(block, x[:, :S], chunk=CHUNK)
        out = {"apply": dict(zip(LEAVES, (y, state, conv))), "decode": []}
        for t in range(S, S + STEPS):
            y, state, conv = SSM.mamba2_decode(block, x[:, t:t + 1], state,
                                               conv)
            out["decode"].append(dict(zip(LEAVES, (y, state, conv))))
    return out


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_equals_reference(dtype, leaf, reference):
    ref = reference(dtype)
    got = port_run(ref["tree"], dtype)["apply"][leaf]
    want = ref["apply"][leaf]
    assert str(got.dtype) == "torch." + str(want.dtype)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_equal_reference(dtype, leaf, reference):
    ref = reference(dtype)
    steps = port_run(ref["tree"], dtype)["decode"]
    for i, (got, want) in enumerate(zip(steps, ref["decode"])):
        assert str(got[leaf].dtype) == "torch." + str(want[leaf].dtype)
        assert rel_err(got[leaf], want[leaf]) <= TOL[dtype], i


def test_prefill_then_decode_equals_one_apply(reference):
    """Three chunks of 8 and 8 decode steps equal one apply over the 32
    tokens (four chunks): outputs, state and conv history."""
    block = port_block(reference("float32")["tree"], torch.float32)
    x = torch.from_numpy(inputs(S))
    with torch.no_grad():
        want, want_state, want_conv = SSM.mamba2_apply(block, x, chunk=CHUNK)
        y, state, conv = SSM.mamba2_apply(block, x[:, :24], chunk=CHUNK)
        ys = [y]
        for t in range(24, S):
            y, state, conv = SSM.mamba2_decode(block, x[:, t:t + 1], state,
                                               conv)
            ys.append(y)
    assert rel_err(torch.cat(ys, 1), want) <= 1e-5
    assert rel_err(state, want_state) <= 1e-5
    assert torch.equal(conv, want_conv)


def test_chunk_size_does_not_change_the_result(reference):
    """Four chunks of 8 carry the state across three boundaries; one
    chunk of 32 carries none."""
    block = port_block(reference("float32")["tree"], torch.float32)
    x = torch.from_numpy(inputs(S))
    with torch.no_grad():
        y8, st8, _ = SSM.mamba2_apply(block, x, chunk=8)
        y32, st32, _ = SSM.mamba2_apply(block, x, chunk=32)
    assert rel_err(y8, y32) <= 1e-5
    assert rel_err(st8, st32) <= 1e-5


def test_apply_refuses_a_length_off_the_chunk(reference):
    block = port_block(reference("float32")["tree"], torch.float32)
    with pytest.raises(AssertionError):
        SSM.mamba2_apply(block, torch.from_numpy(inputs(12)), chunk=8)


def test_causal_conv_carries_its_history():
    """The conv over a whole sequence equals the conv over its second
    half given the first half's tail."""
    rng = np.random.default_rng(2)
    xbc = torch.from_numpy(rng.standard_normal((B, 10, 6), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((SSM.CONV_K, 6),
                                             dtype=np.float32))
    bias = torch.from_numpy(rng.standard_normal(6, dtype=np.float32))
    whole, tail = SSM.causal_conv(xbc, w, bias)
    first, prev = SSM.causal_conv(xbc[:, :4], w, bias)
    second, tail2 = SSM.causal_conv(xbc[:, 4:], w, bias, prev)
    assert torch.allclose(torch.cat([first, second], 1), whole, atol=1e-6)
    assert torch.equal(tail, xbc[:, -3:]) and torch.equal(tail2, tail)


def test_init_sets_the_reference_constants():
    """``conv_b``, ``D``, ``dt_bias`` and the norm scale exactly the
    reference's; ``A_log`` the correctly rounded float32 of
    log(linspace(1, 16, H)), within 3e-7 of the reference's float32
    arithmetic (ROADMAP.md §3); the constant leaves float32 under
    bfloat16 weights, as the reference's masters."""
    block = SSM.Mamba2(D_MODEL, N_STATE, HEAD_DIM, device="cpu",
                       dtype=torch.bfloat16)
    block.init_(torch.Generator().manual_seed(0), torch.float32)
    block.requires_grad_(False)
    ref = RSSM.mamba2_init(jax.random.PRNGKey(0), D_MODEL, N_STATE,
                           HEAD_DIM, jnp.bfloat16)
    for name in ("conv_b", "D", "dt_bias"):
        got = getattr(block, name)
        assert str(got.dtype) == "torch." + str(ref[name].dtype), name
        assert np.array_equal(got.float().numpy(),
                              np.asarray(ref[name], np.float32)), name
    assert not block.norm.scale.any()
    h = D_MODEL * 2 // HEAD_DIM
    want = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    assert block.A_log.dtype == torch.float32
    assert np.array_equal(block.A_log.numpy(), want)
    assert np.abs(block.A_log.numpy() - np.asarray(ref["A_log"])).max() <= 3e-7
