"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``) on the CPU.

One reference parameter tree a block at the reduced xlstm-350m's widths
(d 64, 4 heads: the mLSTM's heads 32 wide, the sLSTM's 16), its
constant leaves perturbed so that a dropped or misplaced one shows
(``fbias`` seeded around 3, the norm scale seeded), goes into both
packages; the same seeded numpy input (B 2, S 32) goes through
``mlstm_apply`` at ``chunk=8`` — four chunks, so the (C, n, m) carried
from chunk to chunk matters — and ``slstm_apply``, and then three
decode steps continue from each package's own state.  The sLSTM's
random ``r`` holds the gate layout: its recurrent term is computed per
head and then split into the four gates, which therefore interleave
heads.

Tolerances, max |port − reference| against max |reference|, leaf by
leaf: 1e-4 in float32 and 2e-2 in bfloat16 (every leaf cast, as a served
model holds them; the states stay float32).  Measured at most 5.1e-7 in
float32 and 6.8e-3 in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as RXL
from repro_torch.models import convert
from repro_torch.models import xlstm as XL

D_MODEL, N_HEADS = 64, 4
B, S, CHUNK, STEPS = 2, 32, 8, 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = ("float32", "bfloat16")


class Block:
    """One kind: its reference init/apply/decode, its port module and
    functions, and the names of its state's leaves."""

    def __init__(self, kind):
        self.kind = kind
        if kind == "mlstm":
            self.ref_init, self.port_cls = RXL.mlstm_init, XL.MLSTM
            self.ref_apply = lambda p, x: RXL.mlstm_apply(
                p, x, n_heads=N_HEADS, chunk=CHUNK)
            self.ref_decode = lambda p, x, st: RXL.mlstm_decode(
                p, x, st, n_heads=N_HEADS)
            self.apply = lambda m, x, chunk=CHUNK: XL.mlstm_apply(
                m, x, chunk=chunk)
            self.decode = XL.mlstm_decode
            self.state = tuple("cnm")
        else:
            self.ref_init, self.port_cls = RXL.slstm_init, XL.SLSTM
            self.ref_apply = lambda p, x: RXL.slstm_apply(
                p, x, n_heads=N_HEADS)
            self.ref_decode = lambda p, x, st: RXL.slstm_decode(
                p, x, st, n_heads=N_HEADS)
            self.apply = lambda m, x, chunk=None: XL.slstm_apply(m, x)
            self.decode = XL.slstm_decode
            self.state = tuple("cnhm")
        self.leaves = ("y",) + self.state


BLOCKS = {k: Block(k) for k in ("mlstm", "slstm")}
CASES = [(k, dt, leaf) for k in BLOCKS for dt in DTYPES
         for leaf in BLOCKS[k].leaves]


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


def reference_tree(block: Block) -> dict:
    """The block's float32 init, ``fbias`` and the norm scale perturbed."""
    tree = jax.tree.map(np.asarray, block.ref_init(
        jax.random.PRNGKey(0), D_MODEL, N_HEADS, jnp.float32))
    rng = np.random.default_rng(0)
    tree["fbias"] = (3.0 + rng.standard_normal(tree["fbias"].shape)
                     ).astype(np.float32)
    tree["norm"]["scale"] = (0.2 * rng.standard_normal(
        tree["norm"]["scale"].shape)).astype(np.float32)
    return tree


def port_block(block: Block, tree, dtype):
    module = block.port_cls(D_MODEL, N_HEADS, device="meta")
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)).to(dtype)
         for k, v in convert._flatten(tree).items()}, assign=True)
    return module


def inputs(length=S + STEPS, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, length, D_MODEL), dtype=np.float32)


def reference_run(block: Block, dtype: str) -> dict:
    """apply over the first S tokens, then STEPS decode steps: each
    one's output and state leaves."""
    tree = reference_tree(block)
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    x = jnp.asarray(inputs(), dtype)
    y, state = jax.jit(block.ref_apply)(params, x[:, :S])
    out = {"tree": tree, "decode": [],
           "apply": dict(zip(block.leaves, (y,) + tuple(state)))}
    step = jax.jit(block.ref_decode)
    for t in range(S, S + STEPS):
        y, state = step(params, x[:, t:t + 1], state)
        out["decode"].append(dict(zip(block.leaves, (y,) + tuple(state))))
    return out


@pytest.fixture(scope="module")
def reference():
    runs = {}

    def get(kind, dtype):
        if (kind, dtype) not in runs:
            runs[kind, dtype] = reference_run(BLOCKS[kind], dtype)
        return runs[kind, dtype]

    return get


def port_run(block: Block, tree, dtype: str) -> dict:
    tdt = getattr(torch, dtype)
    module = port_block(block, tree, tdt)
    x = torch.from_numpy(inputs()).to(tdt)
    with torch.no_grad():
        y, state = block.apply(module, x[:, :S])
        out = {"apply": dict(zip(block.leaves, (y,) + tuple(state))),
               "decode": []}
        for t in range(S, S + STEPS):
            y, state = block.decode(module, x[:, t:t + 1], state)
            out["decode"].append(dict(zip(block.leaves, (y,) + tuple(state))))
    return out


@pytest.mark.parametrize("kind, dtype, leaf", CASES)
def test_apply_equals_reference(kind, dtype, leaf, reference):
    ref = reference(kind, dtype)
    got = port_run(BLOCKS[kind], ref["tree"], dtype)["apply"][leaf]
    want = ref["apply"][leaf]
    assert str(got.dtype) == "torch." + str(want.dtype)
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("kind, dtype, leaf", CASES)
def test_decode_steps_equal_reference(kind, dtype, leaf, reference):
    ref = reference(kind, dtype)
    steps = port_run(BLOCKS[kind], ref["tree"], dtype)["decode"]
    for i, (got, want) in enumerate(zip(steps, ref["decode"])):
        assert str(got[leaf].dtype) == "torch." + str(want[leaf].dtype)
        assert rel_err(got[leaf], want[leaf]) <= TOL[dtype], i


@pytest.mark.parametrize("kind", BLOCKS)
def test_prefill_then_decode_equals_one_apply(kind, reference):
    """apply over 24 tokens (three chunks of 8 for the mLSTM) and 8 decode
    steps equal one apply over the 32: outputs and every state leaf (the
    mLSTM's chunkwise stabiliser ends each chunk at the running max, the
    decode's exact one)."""
    block = BLOCKS[kind]
    module = port_block(block, reference(kind, "float32")["tree"],
                        torch.float32)
    x = torch.from_numpy(inputs(S))
    with torch.no_grad():
        want, want_state = block.apply(module, x)
        y, state = block.apply(module, x[:, :24])
        ys = [y]
        for t in range(24, S):
            y, state = block.decode(module, x[:, t:t + 1], state)
            ys.append(y)
    assert rel_err(torch.cat(ys, 1), want) <= 1e-5
    for name, got, ref in zip(block.state, state, want_state):
        assert rel_err(got, ref) <= 1e-5, name


def test_mlstm_chunk_size_does_not_change_the_output(reference):
    """Four chunks of 8 carry (C, n, m) across three boundaries; one
    chunk of 32 carries none."""
    block = BLOCKS["mlstm"]
    module = port_block(block, reference("mlstm", "float32")["tree"],
                        torch.float32)
    x = torch.from_numpy(inputs(S))
    with torch.no_grad():
        y8, _ = block.apply(module, x, chunk=8)
        y32, _ = block.apply(module, x, chunk=32)
    assert rel_err(y8, y32) <= 1e-5


def test_mlstm_apply_refuses_a_length_off_the_chunk(reference):
    module = port_block(BLOCKS["mlstm"], reference("mlstm", "float32")["tree"],
                        torch.float32)
    with pytest.raises(AssertionError):
        XL.mlstm_apply(module, torch.from_numpy(inputs(12)), chunk=8)


def test_slstm_gate_layout_interleaves_heads(reference, monkeypatch):
    """A per-gate layout of the recurrent term (each gate's d columns
    spanning every head) loads the same shapes but computes another
    cell: the reference's random ``r`` tells it apart from the port's."""
    ref = reference("slstm", "float32")
    module = port_block(BLOCKS["slstm"], ref["tree"], torch.float32)
    x = torch.from_numpy(inputs())[:, :S]
    cell = XL._slstm_cell

    def per_gate(r, fbias, xg, state):
        hn, hp = r.shape[:2]
        h = state[2]
        # (B, H, 4, P) -> (B, 4, H, P): gate-major instead of head-major
        rg = torch.einsum("bhp,hpq->bhq", h.reshape(-1, hn, hp), r)
        rg = rg.reshape(-1, hn, 4, hp).transpose(1, 2).reshape(xg.shape)
        zero = torch.zeros_like(r)
        return cell(zero, fbias, xg + rg, state)

    with torch.no_grad():
        y, _ = XL.slstm_apply(module, x)
        assert rel_err(y, ref["apply"]["y"]) <= TOL["float32"]
        monkeypatch.setattr(XL, "_slstm_cell", per_gate)
        y, _ = XL.slstm_apply(module, x)
    assert rel_err(y, ref["apply"]["y"]) > 1e-2


@pytest.mark.parametrize("kind", BLOCKS)
def test_init_sets_the_reference_constants(kind):
    """``fbias`` 3 (float32 under bfloat16 weights, as the reference's
    masters), the norm scale 0; the mLSTM ``gates`` at std 0.01."""
    block = BLOCKS[kind]
    module = block.port_cls(D_MODEL, N_HEADS, device="cpu",
                            dtype=torch.bfloat16)
    module.init_(torch.Generator().manual_seed(0), torch.float32)
    module.requires_grad_(False)
    ref = block.ref_init(jax.random.PRNGKey(0), D_MODEL, N_HEADS,
                         jnp.bfloat16)
    assert module.fbias.dtype == torch.float32
    assert str(ref["fbias"].dtype) == "float32"
    assert np.array_equal(module.fbias.numpy(), np.asarray(ref["fbias"]))
    assert not module.norm.scale.any()
    if kind == "mlstm":
        assert float(module.gates.float().abs().max()) <= 0.02
        assert abs(float(module.gates.float().std()) / 0.01 - 0.880) < 0.1


def test_full_width_slstm_is_chaotic_under_the_reference_init():
    """At xlstm-350m's width (d 1024, 4 heads of 256) the reference's
    initialiser draws ``r`` at std 1/√4 = 0.5 (its fan-in is shape[0],
    the heads), and the sLSTM amplifies a 1e-7 relative perturbation of
    its input beyond 1e-2 of max |y| within 64 tokens — in both packages
    — where the reduced width (heads of 16) keeps it near 1e-7.  So no
    two devices' float32 runs of the full stack agree over long prompts
    (``chip_smoke.py``'s ``XLSTM_CHECK_PROMPT``)."""
    d, s = 1024, 64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, s, d), dtype=np.float32)
    x /= np.sqrt((x ** 2).mean(-1, keepdims=True))
    xp = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(np.float32)
    tree = jax.tree.map(np.asarray, RXL.slstm_init(
        jax.random.PRNGKey(0), d, N_HEADS, jnp.float32))
    ref = jax.jit(lambda p, x: RXL.slstm_apply(p, x, n_heads=N_HEADS)[0])
    ya, yb = (np.asarray(ref(tree, jnp.asarray(v))) for v in (x, xp))
    assert rel_err(yb[:, -1], ya[:, -1]) > 1e-2
    module = XL.SLSTM(d, N_HEADS, device="meta")
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                            convert._flatten(tree).items()}, assign=True)
    with torch.no_grad():
        ta, tb = (XL.slstm_apply(module, torch.from_numpy(v))[0]
                  for v in (x, xp))
    assert rel_err(ta[:, :8], ya[:, :8]) <= TOL["float32"]
    assert rel_err(tb[:, -1], ta[:, -1]) > 1e-2
