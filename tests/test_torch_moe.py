"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``)
against the JAX package's (``repro.models.moe``) on the CPU.

One reference parameter tree per reduced configuration (deepseek-moe-16b:
8 experts, top 2, one shared expert; arctic-480b: 8 experts, top 2, the
dense residual FFN; both ``router_chunk`` 16) goes into both packages,
and the same seeded numpy input through ``moe_apply``.

The reference gives every batch row its own queue positions but sums
the dispatch over the rows, so rows whose tokens take the same
(expert, slot) are mixed; the port gives each row its own slots
(``ROADMAP.md`` §3).  So each row of the port's batch is held against a
``B = 1`` reference call, where the two agree, and aux — which depends
on each token's routing alone — against the reference's batched call.

Tolerances, max |port − reference| against max |reference|: 1e-4 in
float32 (measured at most 2.1e-7), 2e-2 in bfloat16; the port's batch
against its rows run alone 1e-5 (float32 rounding of the batched
products; measured at most 6e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import moe as RMOE
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.models import moe as MOE

ARCHS = ("deepseek-moe-16b", "arctic-480b")
B = 3
TOL, TOL_BF16, TOL_ROWS = 1e-4, 2e-2, 1e-5


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


class Pair:
    """One reduced configuration's MoE in both packages, from one
    reference parameter tree (``capacity_factor`` and the activation
    dtype may be replaced)."""

    def __init__(self, arch, dtype="float32", **moe):
        self.cfg = registry.get_reduced(arch)
        self.cfg = dataclasses.replace(
            self.cfg, moe=dataclasses.replace(self.cfg.moe, **moe))
        ref_cfg = ref_registry.get_reduced(arch)
        self.ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe))
        self.dtype = dtype
        tree = jax.tree.map(np.asarray, RMOE.moe_init(
            jax.random.PRNGKey(0), self.cfg.d_model, self.ref_cfg.moe,
            self.cfg.activation, jnp.float32))
        self.tree = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        self.moe = MOE.MoE(self.cfg.d_model, self.cfg.moe,
                           self.cfg.activation, device="meta")
        state = {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
                 for k, v in convert._flatten(tree).items()}
        self.moe.load_state_dict(state, assign=True)
        self._ref = jax.jit(lambda p, x: RMOE.moe_apply(
            p, x, self.ref_cfg.moe, self.ref_cfg.activation))

    def x(self, shape, seed=0):
        return np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32)

    @torch.no_grad()
    def port(self, x):
        y, aux = MOE.moe_apply(
            self.moe, torch.from_numpy(x).to(getattr(torch, self.dtype)),
            self.cfg.moe, self.cfg.activation)
        return y, aux

    def ref(self, x):
        y, aux = self._ref(self.tree, jnp.asarray(x, self.dtype))
        return np.asarray(y, np.float32), float(aux)

    def ref_rows(self, x):
        """The reference on each batch row alone, stacked."""
        return np.concatenate([self.ref(x[i:i + 1])[0]
                               for i in range(x.shape[0])])

    @torch.no_grad()
    def routing(self, x):
        """The port's routing of one chunk of ``x``."""
        return MOE.route(torch.from_numpy(x), self.moe.router, self.cfg.moe)


@pytest.fixture(scope="module")
def pairs():
    made = {}

    def get(arch, dtype="float32", **moe):
        key = (arch, dtype, tuple(sorted(moe.items())))
        if key not in made:
            made[key] = Pair(arch, dtype, **moe)
        return made[key]

    return get


@pytest.mark.parametrize("length", [1, 16, 35])
@pytest.mark.parametrize("arch", ARCHS)
def test_rows_and_aux_equal_reference(arch, length, pairs):
    """Lengths 1 (a decode step), 16 (one chunk) and 35 (three chunks,
    the last padded with 13 zero tokens)."""
    pair = pairs(arch)
    x = pair.x((B, length, pair.cfg.d_model))
    y, aux = pair.port(x)
    assert y.shape == x.shape
    assert rel_err(y, pair.ref_rows(x)) <= TOL
    _, ref_aux = pair.ref(x)
    assert abs(float(aux) - ref_aux) <= TOL * abs(ref_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_equals_its_rows_run_alone(arch, pairs):
    pair = pairs(arch)
    for length in (1, 35):
        x = pair.x((B, length, pair.cfg.d_model), seed=length)
        y, _ = pair.port(x)
        rows = torch.cat([pair.port(x[i:i + 1])[0] for i in range(B)])
        assert rel_err(y, rows) <= TOL_ROWS


def test_the_reference_mixes_rows_and_the_port_does_not(pairs):
    """The deliberate difference: at a decode step (one token a row) the
    reference's batched output is not its rows run alone, because
    tokens of different rows that take one (expert, slot) go through
    the expert as their sum; the port's is."""
    pair = pairs("deepseek-moe-16b")
    x = pair.x((4, 1, pair.cfg.d_model), seed=7)
    rows = pair.ref_rows(x)
    batched, _ = pair.ref(x)
    assert rel_err(batched, rows) > 0.1
    y, _ = pair.port(x)
    assert rel_err(y, rows) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_assignments_equal_reference(arch, pairs):
    """capacity_factor 0.5: 4 slots an expert for a chunk's 32
    assignments, so some are dropped — without renormalising the rest
    of their row."""
    pair = pairs(arch, capacity_factor=0.5)
    x = pair.x((B, 16, pair.cfg.d_model), seed=3)
    r = pair.routing(x)
    assert MOE._capacity(16 * 2 / 8, 0.5) == 4
    assert not bool(r.valid.all())
    assert torch.equal(r.valid, r.pos < 4)
    y, _ = pair.port(x)
    assert rel_err(y, pair.ref_rows(x)) <= TOL


def test_zero_tokens_route_to_the_lowest_experts(pairs):
    """A zero token's router probabilities are exactly uniform; the
    reference's ``lax.top_k`` takes the lowest experts, and so must the
    port, or the real tokens behind 10 leading zeros would drop from
    other experts.  An all-zero input's aux is K."""
    pair = pairs("deepseek-moe-16b")
    x = pair.x((B, 16, pair.cfg.d_model), seed=4)
    x[:, :10] = 0.0
    r = pair.routing(x)
    assert torch.equal(r.gate_idx[:, :10],
                       torch.tensor([0, 1]).expand(B, 10, 2))
    assert not bool(r.valid[:, 8:10].any())
    y, _ = pair.port(x)
    assert rel_err(y, pair.ref_rows(x)) <= TOL
    zeros = np.zeros((B, 16, pair.cfg.d_model), np.float32)
    y, aux = pair.port(zeros)
    assert float(aux) == pytest.approx(pair.ref(zeros)[1]) == 2.0
    assert not bool(y.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_equals_reference_within_tolerance(arch, pairs):
    """Every leaf in bfloat16, as ``cast_params`` leaves a served model:
    router logits, softmax and weights in float32, the combine weights
    cast to bfloat16 before the sum over K, the expert products in
    bfloat16."""
    pair = pairs(arch, "bfloat16")
    x = pair.x((B, 35, pair.cfg.d_model), seed=5)
    y, _ = pair.port(x)
    assert y.dtype == torch.bfloat16
    assert rel_err(y, pair.ref_rows(x)) <= TOL_BF16
