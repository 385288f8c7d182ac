"""``repro_torch.optim.compression``, ``repro_torch.launch.mesh`` and
``build_compressed_train_step`` against the reference, on the CPU.

``quantize`` runs in this process beside the reference's.  Four gloo
ranks are spawned once for the module (``torch.multiprocessing.spawn``,
a ``FileStore`` in ``tmp_path``; the rank side is
``tests/torch_compression_ranks.py``, which imports no JAX) and run
``psum_compressed`` on seeded leaves, the compressed step on a (4, 1)
("data", "model") mesh and on a (2, 2) ("pod", "data") mesh with
``data_axes=("pod", "data")``, and the reference's convergence test
(5 steps, compressed against plain).  Beside them a subprocess runs
the reference's own ``psum_compressed`` under ``jax.vmap(...,
axis_name="d")`` and its compressed step's body under the same
``vmap`` over four shards, from the same weights (reduced gemma-2b,
batch 8 × 16, ``q_chunk`` 16, 2 steps); and, on four fake XLA devices,
its jitted ``build_compressed_train_step``, which under this JAX's
``shard_map`` reduces the gradients before the compression
(``test_the_reference_step_under_shard_map_sums_the_gradients``).
"""
import importlib.util
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro.optim import compression as RC
from repro_torch.configs import registry
from repro_torch.launch import mesh as MESH
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.optim import compression as C
from repro_torch.train import steps

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
ARCH = "gemma-2b"
#: leaf → shape; each rank's values at a scale of its own
LEAVES = {"w": (37, 16), "b": (16,), "table": (512, 64)}
SCALES = (1e-6, 1e-3, 1.0, 10.0)

#: The reference's psum_compressed under vmap; its compressed step's
#: body (``local`` in ``build_compressed_train_step``, line for line)
#: under vmap over four shards; and its own jitted step under
#: ``shard_map`` on four fake devices, one step.  The weights come back
#: in the port's names.
REFERENCE = """
    import sys
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs.registry import get_reduced
    from repro.models import model as MDL
    from repro.optim import adamw
    from repro.optim.compression import init_error, psum_compressed
    from repro.train.steps import build_compressed_train_step
    from repro_torch.configs import registry
    from repro_torch.models import convert

    inp = np.load(sys.argv[1])
    names = sorted({k.split("/")[1] for k in inp.files if "/" in k})
    grads = {n: jnp.asarray(inp["grads/" + n]) for n in names}
    errs = {n: jnp.asarray(inp["errs/" + n]) for n in names}
    mean, new_err = jax.vmap(lambda g, e: psum_compressed(g, e, "d"),
                             axis_name="d")(grads, errs)
    out = {f"mean/{n}": np.asarray(mean[n]) for n in names}
    out.update({f"err/{n}": np.asarray(new_err[n]) for n in names})

    cfg = get_reduced("gemma-2b")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=20)
    params = MDL.init_params(cfg, jax.random.PRNGKey(0))
    opt = dict(adamw.init_state(opt_cfg, params), err=init_error(params))
    batch = {"tokens": jnp.asarray(inp["tokens"]),
             "labels": jnp.asarray(inp["labels"])}
    grad_fn = jax.grad(
        lambda p, b: MDL.loss_fn(p, cfg, b, q_chunk=16), has_aux=True)

    def local(params, opt_state, batch):
        grads, metrics = grad_fn(params, batch)
        grads, new_err = psum_compressed(grads, opt_state["err"], "d")
        metrics = jax.tree.map(lambda x: jax.lax.pmean(x, "d"), metrics)
        params, inner, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, {k: opt_state[k] for k in
                                     ("m", "v", "step")})
        return params, {**inner, "err": new_err}, {**metrics, **opt_metrics}

    four = lambda t: jax.tree.map(
        lambda x: jnp.broadcast_to(x, (4,) + jnp.shape(x)), t)
    step = jax.jit(jax.vmap(local, axis_name="d"))
    p4, o4 = four(params), four(opt)
    shards = jax.tree.map(lambda x: x.reshape((4, 2) + x.shape[1:]), batch)
    for s in range(2):
        p4, o4, m = step(p4, o4, shards)
        state = convert.params_from_reference(
            jax.tree.map(lambda x: np.asarray(x[0]), p4),
            registry.get_reduced("gemma-2b"))
        out.update({f"step{s}/{n}": v.numpy() for n, v in state.items()})
        out.update({f"metric{s}/{k}": np.asarray(v) for k, v in m.items()})

    mesh = jax.make_mesh((4,), ("data",))
    own = jax.jit(build_compressed_train_step(cfg, opt_cfg, mesh, "data",
                                              q_chunk=16))
    _, _, m = own(params, opt, batch)
    out.update({f"own/{k}": np.asarray(v) for k, v in m.items()})
    np.savez(sys.argv[2], **out)
"""


def _leaves() -> tuple:
    """Four ranks' gradients and errors: (WORLD, *shape) float32 each,
    rank r's at ``SCALES[r]``."""
    rng = np.random.default_rng(7)
    grads, errs = {}, {}
    for name, shape in LEAVES.items():
        grads[name] = np.stack([
            (s * rng.standard_normal(shape)).astype(np.float32)
            for s in SCALES])
        errs[name] = np.stack([
            (s * 1e-3 * rng.standard_normal(shape)).astype(np.float32)
            for s in SCALES])
    return grads, errs


def _batch(seq: int, seed: int) -> dict:
    """The reference's convergence-test batch: 8 rows of ``seq`` tokens
    and the tokens rolled by one as labels."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, 512, (8, seq)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank's results from one spawn of four ranks, and the
    reference's (its subprocess runs beside the ranks)."""
    tmp = tmp_path_factory.mktemp("compression")
    grads, errs = _leaves()
    step_batch = _batch(16, 1)
    np.savez(tmp / "inputs.npz",
             **{f"grads/{n}": v for n, v in grads.items()},
             **{f"errs/{n}": v for n, v in errs.items()}, **step_batch)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp / "inputs.npz"), str(tmp / "reference.npz")],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        cfg = ref_registry.get_reduced(ARCH)
        tree = jax.tree.map(np.asarray, RM.init_params(
            cfg, jax.random.PRNGKey(0)))
        state = {k: v.numpy() for k, v in convert.params_from_reference(
            tree, registry.get_reduced(ARCH)).items()}
        inputs = dict(grads=grads, errs=errs, state=state,
                      step_batch=step_batch, track_batch=_batch(32, 0))
        mp.spawn(_spawn_target(), args=(WORLD, str(tmp / "store"), inputs,
                                        str(tmp)),
                 nprocs=WORLD, join=True)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    with np.load(tmp / "reference.npz") as z:
        reference = dict(z)
    return ranks, reference, state


def _spawn_target():
    import torch_compression_ranks  # tests/ is on sys.path under pytest

    return torch_compression_ranks.run


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    on one machine otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# quantize, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", SCALES)
def test_quantize_equals_the_reference(scale):
    """q, scale and the new error equal the reference's bit for bit,
    with and without a carried error."""
    rng = np.random.default_rng(int(-np.log10(scale)) + 10)
    g = (scale * rng.standard_normal(100_000)).astype(np.float32)
    e0 = (scale * 1e-2 * rng.standard_normal(100_000)).astype(np.float32)
    for err in (np.zeros_like(g), e0):
        q, s, e = C.quantize(torch.from_numpy(g), torch.from_numpy(err))
        rq, rs, re = RC.quantize(jnp.asarray(g), jnp.asarray(err))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.array_equal(s.numpy(), np.asarray(rs))
        assert np.array_equal(e.numpy(), np.asarray(re))
        assert int(q.abs().max()) == 127


def test_grad_compression_unbiased_over_time():
    """``tests/test_integration.py``'s test on the port: with error
    feedback the quantized sum converges to n·g."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)) * 1e-3
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    n = 50
    for _ in range(n):
        q, scale, err = C.quantize(g, err)
        total = total + q.float() * scale
    np.testing.assert_allclose((total / n).numpy(), g.numpy(), atol=5e-5)


def test_init_error_is_float32_zeros_beside_each_parameter():
    params = {"a": torch.ones((3, 2), dtype=torch.bfloat16),
              "b": torch.ones(4)}
    err = C.init_error(params)
    assert list(err) == ["a", "b"]
    for n, e in err.items():
        assert e.dtype == torch.float32 and e.shape == params[n].shape
        assert not e.any()


# ---------------------------------------------------------------------------
# four gloo ranks against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leaf", LEAVES)
def test_psum_compressed_equals_the_reference(runs, leaf):
    """Every rank's mean gradient equals the reference's under
    ``vmap`` bit for bit: the int32 sum is exact in any order, and the
    scales are summed left to right in rank order, as XLA sums them
    here.  Each rank's new error is the reference's for that rank."""
    ranks, reference, _ = runs
    want = reference[f"mean/{leaf}"]
    for r, out in enumerate(ranks):
        mean, err = out["psum"]
        assert mean[leaf].dtype == np.float32
        assert np.array_equal(mean[leaf], want[r]), r
        assert np.array_equal(err[leaf], reference[f"err/{leaf}"][r]), r


def _ref_metric(reference, key: str) -> float:
    """A metric of the reference's step body under vmap: equal on the
    four shards."""
    v = reference[key]
    assert v.shape == (4,) and (v == v[0]).all()
    return float(v[0])


@pytest.mark.parametrize("step", (0, 1))
def test_compressed_step_matches_the_reference(runs, step):
    """The compressed step on four gloo ranks against the reference's
    step body (``build_compressed_train_step``'s ``local``) under
    ``jax.vmap`` over four shards, from the same weights and batch.

    The loss within 1e-5, ``grad_norm`` within 1e-4 relative, and every
    parameter element within 1e-5 of its leaf's max |reference|, but
    for elements where a rounding in ``quantize`` flipped: the port's
    and XLA's float32 gradients differ in the last bits, a value near a
    half step of the scale rounds the other way, and AdamW's update of
    that element then differs by up to a learning rate.  Those are
    counted and must stay under 1e-3 of all elements."""
    ranks, reference, _ = runs
    params, metrics = ranks[0]["reference_steps"]
    for out in ranks[1:]:  # every rank holds the same model
        for n, p in out["reference_steps"][0][step].items():
            assert np.array_equal(p, params[step][n]), n
    m = metrics[step]
    assert set(m) == {"loss", "aux", "grad_norm", "lr"}
    assert abs(m["loss"] - _ref_metric(reference, f"metric{step}/loss")) \
        < 1e-5
    want_norm = _ref_metric(reference, f"metric{step}/grad_norm")
    assert abs(m["grad_norm"] - want_norm) <= 1e-4 * want_norm
    assert m["lr"] == _ref_metric(reference, f"metric{step}/lr")
    flipped = total = 0
    for n, p in params[step].items():
        want = reference[f"step{step}/{n}"]
        tol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
        flipped += int((np.abs(p - want) > tol).sum())
        total += p.size
    print(f"step {step + 1}: {flipped} of {total} elements off by a "
          f"flipped rounding")
    assert flipped < 1e-3 * total, (flipped, total)


def test_the_reference_step_under_shard_map_sums_the_gradients(runs):
    """Why the port is held against the reference's step body under
    ``vmap`` and not against its jitted ``shard_map`` step: under this
    JAX's ``shard_map``, ``jax.grad`` of the replicated parameters
    inserts a psum, so every device already holds the sum of the four
    shards' gradients before ``psum_compressed`` (which then quantizes
    that sum once and divides the four equal payloads by four).  Its
    ``grad_norm`` is four times the mean's, up to the quantization; the
    loss of its first step is the same."""
    ranks, reference, _ = runs
    m = ranks[0]["reference_steps"][1][0]
    own = float(reference["own/grad_norm"])
    assert 3.5 * m["grad_norm"] < own < 4.5 * m["grad_norm"]
    assert abs(float(reference["own/loss"]) - m["loss"]) < 1e-5


def test_compressed_training_tracks_the_plain_step(runs):
    """The reference's convergence test on the port
    (``tests/test_distributed.py``): 5 steps on one batch, compressed
    over four ranks and plain; the compressed loss descends below 6.3
    from ~ln(512) and stays within 0.35 of the plain one."""
    ranks, _, _ = runs
    comp, plain = ranks[0]["tracked"], ranks[0]["plain"]
    assert all(out["tracked"] == comp for out in ranks)
    assert comp[-1] < 6.3, comp
    assert abs(plain[-1] - comp[-1]) < 0.35, (plain, comp)


def test_pod_data_mesh_equals_the_data_mesh(runs):
    """A (2, 2) ("pod", "data") mesh with ``data_axes=("pod",
    "data")`` splits the batch and reduces as the (4, 1) mesh's
    "data" axis: the same parameters and metrics, bit for bit."""
    ranks, _, _ = runs
    for out in ranks:
        (p4, m4), (p22, m22) = out["reference_steps"], out["pod_steps"]
        assert m4 == m22
        for a, b in zip(p4, p22):
            assert all(np.array_equal(a[n], b[n]) for n in a)


def test_two_data_groups_of_a_model_axis(runs):
    """On a (2, 2) ("data", "model") mesh the step reduces over each
    column's two ranks (global ranks {0, 2} and {1, 3}), each taking 4
    rows by its "data" coordinate: ranks of one "data" coordinate take
    the same rows, so all four hold the same parameters, and the loss
    meaned over two ranks of 4 rows is the 8 rows' loss of the (4, 1)
    mesh within float32 rounding."""
    ranks, _, _ = runs
    params, metrics = ranks[0]["two_data_steps"]
    for out in ranks[1:]:
        p, m = out["two_data_steps"]
        assert m == metrics
        assert all(np.array_equal(p[0][n], params[0][n]) for n in p[0])
    four = ranks[0]["reference_steps"][1][0]["loss"]
    assert abs(metrics[0]["loss"] - four) < 1e-6
    assert not all(np.array_equal(params[0][n],
                                  ranks[0]["reference_steps"][0][0][n])
                   for n in params[0])


def test_meshes_their_axes_and_their_worlds(runs):
    """``batch_axes`` is every axis but "model"; the production mesh
    needs 256 ranks and says so on a four-rank world; a batch that does
    not split over the data ranks raises."""
    ranks, _, _ = runs
    for out in ranks:
        assert out["batch_axes"] == (("data",), ("pod", "data"))
        assert "needs 256 ranks, the world has 4" in out["production"]
        assert "does not split over the 4 ranks" in out["indivisible"]


# ---------------------------------------------------------------------------
# single-process cases
# ---------------------------------------------------------------------------


def test_default_device_is_the_gpu_and_raises_without_one(monkeypatch):
    """``device=None`` is the GPU in the compressed step, the meshes and
    the training example; without a GPU each raises before it touches
    a process group."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default runs there")
    cfg = registry.get_reduced(ARCH)
    for call in (lambda: steps.build_compressed_train_step(
                     cfg, adamw.AdamWConfig(), None, "data"),
                 lambda: MESH.make_host_mesh(),
                 lambda: MESH.make_production_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", REPO / "examples" / "torch_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    monkeypatch.setattr(sys, "argv", ["torch_train_lm.py", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_reference_leaves_group_the_port_names_as_the_reference_stacks(
        arch):
    """Each reference leaf under a ``blocks`` stack holds G layers: the
    port's names group into G tensors of the leaf's per-layer shape;
    every other leaf (tail layers, the table, norms, the shared block)
    is one tensor.  The same multiset of (tensors, shape) both sides."""
    from repro_torch.models import model as M

    cfg = registry.get_reduced(arch)
    tree = jax.eval_shape(lambda: RM.init_params(
        ref_registry.get_reduced(arch), jax.random.PRNGKey(0)))
    want = sorted(
        (x.shape[0], x.shape[1:]) if "'blocks'" in jax.tree_util.keystr(path)
        else (1, x.shape)
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0])
    shapes = {n: tuple(p.shape) for n, p in
              M.Model(cfg, device="meta").named_parameters()}
    leaves = convert.reference_leaves(cfg, list(shapes))
    got = []
    for leaf in leaves:
        assert len({shapes[n] for n in leaf}) == 1, leaf
        got.append((len(leaf), shapes[leaf[0]]))
    assert sorted(got) == want
    assert sorted(n for leaf in leaves for n in leaf) == sorted(shapes)


def test_a_mesh_wants_an_initialised_group():
    """Without a process group a mesh raises rather than start one from
    environment variables."""
    with pytest.raises(RuntimeError, match="initialise torch.distributed"):
        MESH.make_host_mesh(device="cpu")
