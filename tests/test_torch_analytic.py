"""``repro_torch.launch.analytic`` against ``repro.launch.analytic``.

``step_flops`` and ``step_hbm_bytes`` hold no hardware constant, so the
port's equal the reference's exactly for every architecture, every cell
of ``cells_for`` and both production meshes.  ``roofline_terms`` turns
them into times with the H100's constants, which must be the ones
``chip_smoke.py`` bounds its kernels and models with.
"""
import importlib.util
import math
import pathlib

import pytest

from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.launch import analytic as RA
from repro_torch.configs import registry, shapes
from repro_torch.launch import analytic as A

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_flops_and_bytes_equal_the_reference(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    cells = shapes.cells_for(cfg)
    assert cells == ref_shapes.cells_for(ref_cfg)
    for cell in cells:
        shape, ref_shape = shapes.SHAPES[cell], ref_shapes.SHAPES[cell]
        assert A.step_flops(cfg, shape) == RA.step_flops(ref_cfg, ref_shape)
        for mesh in MESHES:
            for accum in (1, 4):
                assert A.step_hbm_bytes(cfg, shape, mesh, accum) == \
                    RA.step_hbm_bytes(ref_cfg, ref_shape, mesh, accum), (
                        cell, mesh, accum)


def test_the_constants_are_the_h100s():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert A.PEAK_FLOPS == chip_smoke.BF16_TENSOR_OPS_PER_S == 989e12
    assert A.HBM_BW == chip_smoke.HBM_BYTES_PER_S == 3.35e12
    assert set(A.VPU_OPS.values()) == {chip_smoke.PEAK_OPS_PER_S} == {67e12}
    assert sorted(A.VPU_OPS) == sorted(RA.VPU_OPS)
    assert A.NVLINK_LINKS * A.NVLINK_BW == 450e9   # 900 GB/s both ways


@pytest.mark.parametrize("hlo", (None, {"collective_bytes_total": 3.0e9,
                                        "dot_flops": 1.5e15}))
def test_roofline_terms_use_the_constants(hlo):
    cfg = registry.get_config("gemma-2b")
    shape = shapes.SHAPES["train_4k"]
    mesh = MESHES[1]
    terms = A.roofline_terms(cfg, shape, mesh, hlo)
    chips = math.prod(mesh.values())
    assert terms.compute_s == A.step_flops(cfg, shape)["flops"] / (
        chips * A.PEAK_FLOPS)
    assert terms.memory_s == A.step_hbm_bytes(cfg, shape, mesh) / A.HBM_BW
    assert terms.model_flops == A.step_flops(cfg, shape)["model_flops"]
    if hlo is None:
        assert terms.collective_s == 0.0 and terms.hlo_flops is None
    else:
        assert terms.collective_s == 3.0e9 / (A.NVLINK_LINKS * A.NVLINK_BW)
        assert terms.hlo_flops == 1.5e15
    assert terms.dominant in ("compute", "memory", "collective")
    # the same terms over the same chips, on the H100's rates
    ref = RA.roofline_terms(ref_registry.get_config("gemma-2b"),
                            ref_shapes.SHAPES["train_4k"], mesh)
    assert terms.compute_s == pytest.approx(
        ref.compute_s * RA.PEAK_FLOPS / A.PEAK_FLOPS, rel=1e-12)
    assert terms.memory_s == pytest.approx(
        ref.memory_s * RA.HBM_BW / A.HBM_BW, rel=1e-12)
