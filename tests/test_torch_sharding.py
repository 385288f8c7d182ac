"""``repro_torch.launch.sharding`` and ``repro_torch.models.partitioning``
against ``repro.launch.sharding`` and ``repro.models.partitioning``.

The specs need only a mesh's axis names and sizes, so both packages
take the reference tests' stand-in mesh.  A port parameter's spec must
equal its reference leaf's, less the scanned group dimension the port
does not have (layer ``g·period + j`` is ``blocks[j]`` at index ``g``;
``models/convert.py``).  ``constrain`` runs on DTensors over a 2×2 mesh
of torch's fake process group, one process standing for four ranks.
"""
import functools
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import registry as ref_registry
from repro.launch import sharding as RSH
from repro.models import decode as RDEC
from repro.models import model as RMDL
from repro.models import partitioning as RPT
from repro_torch.configs import registry
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models import decode as DEC
from repro_torch.models import model as MDL
from repro_torch.models import partitioning as PT


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


def _ref_leaves(tree) -> dict:
    """``{"a/b/0/c": leaf}`` of a reference tree of specs or shapes."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {RSH._path_str(path): leaf for path, leaf in flat}


def _ref_name(cfg, name: str):
    """The reference leaf path of a port parameter or cache entry name,
    and whether it carries the scanned group dimension."""
    stack, _, rest = name.partition(".")
    plans = {"layers": ("decoder", MDL.layer_plan(cfg))}
    if cfg.is_enc_dec:
        plans["encoder"] = ("encoder", MDL.layer_plan(
            MDL.encoder_config(cfg), cfg.encoder_layers))
    if stack not in plans:
        return name.replace(".", "/"), False
    top, (period, n_groups, _) = plans[stack]
    index, _, path = rest.partition(".")
    i = int(index)
    if i < period * n_groups:
        return f"{top}/blocks/{i % period}/{path.replace('.', '/')}", True
    return (f"{top}/tail/{i - period * n_groups}/"
            f"{path.replace('.', '/')}"), False


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    ref_cfg = ref_registry.get_config(arch)
    return jax.eval_shape(
        lambda: RMDL.init_params(ref_cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    fake = MESHES[mesh]
    shapes = _ref_params(arch)
    ref = _ref_leaves(RSH.param_specs(ref_cfg, shapes, fake))
    ref_shapes = _ref_leaves(shapes)
    model = MDL.Model(cfg, device="meta")
    got = SH.param_specs(cfg, model, fake)
    assert list(got) == [n for n, _ in model.named_parameters()]
    assert {_ref_name(cfg, n)[0] for n in got} == set(ref)
    for name, p in model.named_parameters():
        path, stacked = _ref_name(cfg, name)
        want = tuple(ref[path])
        shape = tuple(ref_shapes[path].shape)
        if stacked:
            assert want[0] is None, (name, want)
            want, shape = want[1:], shape[1:]
        assert tuple(p.shape) == shape, name
        assert got[name] == want, (name, got[name], want)
        for dim, axes in zip(p.shape, got[name]):
            if axes is not None:
                assert dim % math.prod(fake.shape[a] for a in (
                    (axes,) if isinstance(axes, str) else axes)) == 0
    for attn_tp in (False, True):
        serve = SH.param_specs(cfg, model, fake, fsdp_enabled=False,
                               attn_tp=attn_tp)
        ref_serve = _ref_leaves(RSH.param_specs(
            ref_cfg, shapes, fake, fsdp_enabled=False, attn_tp=attn_tp))
        for name, spec in serve.items():
            path, stacked = _ref_name(cfg, name)
            assert spec == tuple(ref_serve[path])[int(stacked):], name
    opt = SH.opt_state_specs(cfg, got)
    assert opt["m"] is got and opt["v"] is got and opt["step"] == ()


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    fake = MESHES[mesh]
    for batch, smax in ((128, 32768), (1, 524288)):
        enc_len = min(smax, 4096) if cfg.is_enc_dec else 0
        ref_cache = jax.eval_shape(
            lambda: RDEC.init_cache(ref_cfg, batch, smax, enc_len))
        ref = _ref_leaves(RSH.cache_specs(ref_cfg, ref_cache, fake))
        with FakeTensorMode():
            cache = DEC.init_cache(cfg, batch, smax, "cpu", enc_len=enc_len)
        got = SH.cache_specs(cfg, cache, fake)
        period, n_groups, _ = MDL.layer_plan(cfg)
        for i, entry in enumerate(got["layers"]):
            for key, spec in entry.items():
                path, stacked = _ref_name(cfg, f"layers.{i}.{key}")
                path = path.replace("decoder/", "")
                assert spec == tuple(ref[path])[int(stacked):], (path, spec)
        for g, entry in enumerate(got.get("shared", [])):
            for key, spec in entry.items():
                assert spec == tuple(ref[f"blocks/{period}/{key}"])[1:]
        assert got["pos"] == tuple(ref["pos"]) == ()
        if cfg.is_enc_dec:
            assert got["enc_out"] == tuple(ref["enc_out"])
        assert set(got) == {k.split("/")[0] for k in ref} - {
            "blocks", "tail"} | {"layers"} | (
                {"shared"} if cfg.shared_attn_period else set())


@pytest.mark.parametrize("mesh", MESHES, ids=str)
def test_batch_specs_equal_the_reference(mesh):
    fake = MESHES[mesh]
    batch = {"tokens": (256, 4096), "labels": (32, 4096), "one": (1, 8),
             "embeds": (64, 16, 8)}
    ref = RSH.batch_specs({k: jax.ShapeDtypeStruct(v, "int32")
                           for k, v in batch.items()}, fake)
    got = SH.batch_specs(batch, fake)
    assert got == {k: tuple(v) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# constrain and placements on a 2x2 fake world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh22():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield M.make_host_mesh((2, 2), device="cpu")
    finally:
        dist.destroy_process_group()


def _ref_spec(fake, batch_axes, dims, shape, free=False) -> tuple:
    """The spec the reference's ``constrain`` names for ``dims`` over
    ``shape`` on the stand-in mesh ``fake`` (read before it builds the
    ``NamedSharding``, which takes no stand-in)."""
    seen = {}
    orig = RPT.NamedSharding, jax.lax.with_sharding_constraint
    RPT.NamedSharding = lambda mesh, spec: spec
    jax.lax.with_sharding_constraint = lambda x, spec: seen.setdefault(
        "spec", spec)
    try:
        with RPT.apply_policy(RPT.Policy(fake, batch_axes)):
            RPT.constrain(jax.ShapeDtypeStruct(shape, "float32"), dims, free)
    finally:
        RPT.NamedSharding, jax.lax.with_sharding_constraint = orig
    return tuple(seen["spec"])


def _port_spec(spec) -> tuple:
    return tuple(None if e == PT.FREE else e for e in spec)


@pytest.mark.parametrize("case", [
    (("batch", None, "model"), (4, 3, 8), False),
    (("batch", None, "model"), (3, 3, 8), False),      # batch indivisible
    (("batch", None, "model"), (4, 3, 5), False),      # model indivisible
    (("model", None, "batch"), (6, 2, 4), False),
    (("batch", "batch", "model"), (4, 4, 2), False),   # an axis used once
    (("batch", "model", None, None), (2, 4, 3, 3), True),
    ((None, "batch", "model", None, None), (2, 4, 1, 3, 3), True),
])
def test_constrain_gives_the_reference_spec(mesh22, case):
    dims, shape, free = case
    want = _ref_spec(FakeMesh({"data": 2, "model": 2}), ("data",), dims,
                     shape, free)
    want = tuple(None if e is P.UNCONSTRAINED else e for e in want)
    pol = PT.Policy(mesh22, ("data",))
    spec = PT.spec_of(pol, dims, shape, free)
    assert _port_spec(spec) == want
    x = distribute_tensor(torch.zeros(shape), mesh22,
                          [Replicate(), Replicate()], src_data_rank=None)
    with PT.apply_policy(pol):
        y = PT.constrain(x, dims, free)
    assert isinstance(y, DTensor)
    assert list(y.placements) == PT.placements_of(want, ("data", "model"))


@pytest.mark.parametrize("b", (8, 4, 2, 1, 6))
def test_constrain_batch_suffix_fallback(b):
    """A batch that divides only the inner batch axes shards over them
    (the reference's suffix fallback), on a 2×2×2 stand-in."""
    fake = FakeMesh({"pod": 2, "data": 2, "model": 2})
    pol = PT.Policy(fake, ("pod", "data"))
    want = _ref_spec(fake, ("pod", "data"), ("batch", None), (b, 3))
    assert PT.spec_of(pol, ("batch", None), (b, 3)) == want


def test_constrain_is_a_no_op_without_a_policy(mesh22):
    x = torch.ones(4, 4)
    assert PT.get_policy() is None
    assert PT.constrain(x, ("batch", "model")) is x
    d = distribute_tensor(x, mesh22, [Shard(0), Replicate()],
                          src_data_rank=None)
    assert PT.constrain(d, ("model", None)) is d
    assert PT.gather(d, (None, None)) is d
    with PT.apply_policy(PT.Policy(mesh22, ("data",))):
        assert PT.constrain(x, ("batch", "model")) is x   # a plain tensor
        r = PT.gather(d, (None, None))
        assert list(r.placements) == [Replicate(), Replicate()]
    assert PT.get_policy() is None


def test_free_keeps_the_current_placement(mesh22):
    pol = PT.Policy(mesh22, ("data",))
    d = distribute_tensor(torch.zeros(4, 6, 4), mesh22,
                          [Replicate(), Shard(2)], src_data_rank=None)
    with PT.apply_policy(pol):
        pinned = PT.constrain(d, ("batch", None, None))
        free = PT.constrain(d, ("batch", None, None), free=True)
    assert list(pinned.placements) == [Shard(0), Replicate()]
    assert list(free.placements) == [Shard(0), Shard(2)]
    # a pending sum stays pending on a free dim and is reduced otherwise
    part = DTensor.from_local(torch.zeros(4, 6, 4), mesh22,
                              [Replicate(), Partial()])
    with PT.apply_policy(pol):
        assert list(PT.constrain(part, ("batch", None, None),
                                 free=True).placements) == [Shard(0),
                                                           Partial()]
        assert list(PT.constrain(part, ("batch", None, None)).placements
                    ) == [Shard(0), Replicate()]


def test_to_placements_follows_mesh_order():
    fake = FakeMesh({"pod": 2, "data": 2, "model": 2})
    fake.mesh_dim_names = fake.axis_names
    tree = {"w": (("pod", "data"), "model"), "b": (None,), "step": ()}
    got = SH.to_placements(tree, fake)
    assert got["w"] == [Shard(0), Shard(0), Shard(1)]
    assert got["b"] == got["step"] == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        SH.to_placements({"w": (("data", "pod"),)}, fake)
