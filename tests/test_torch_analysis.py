"""``repro_torch.analysis`` — the port of the static verifier — held
against ``repro.analysis``.

The mutation self-tests of ``tests/test_analysis.py``, case for case, on
the port: each seeds a violation of one check class (halo/pad-state,
dtype safety, plan constraints, cache-key completeness, index maps) and
asserts the verifier reports it, beside the clean case.  ``TestIndexMaps``
is rewritten for the port's launch model (``analysis/indexmaps.py``:
the CUDA launchers' block shapes, sub-tiles and windows, in place of the
reference's Pallas BlockSpecs), with its own seeded mutations.  Then
parity: the port's ``"full"`` report equals the reference's finding for
finding on the registry matrix and on the same seeded mutations (the
classes both have: halo, dtype, plan, cache-key; the reference's
Mosaic-readiness warnings have no counterpart), and
``compile(verify=True)`` raises on each mutation the reference's compile
hook catches.  Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import repro.analysis as RA
import repro.api as RAPI
import repro_torch.api as TAPI
from repro.analysis.lint import iter_registry_cases as ref_cases
from repro.core.chain import ChainPlan as RefPlan
from repro_torch import analysis as A
from repro_torch.analysis import indexmaps as IM
from repro_torch.analysis.findings import ERROR, WARN, VerificationError
from repro_torch.api import E
from repro_torch.api.compile import compile as compile_expr
from repro_torch.api.executable import Executable
from repro_torch.api.lower import RunSeg, lower
from repro_torch.core.chain import ChainPlan, plan_chain

pytestmark = pytest.mark.pipeline


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (see
    ``tests/test_torch_api.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def exe_for(expr, shape3=(1, 40, 72), dtype="uint8", backend="cuda"):
    return compile_expr(expr, shape3, dtype, backend, verify=False,
                        device="cpu")


def forge_plan(plan, cls=ChainPlan, **over):
    """Copy ``plan`` with fields overridden, bypassing __post_init__."""
    mutant = object.__new__(cls)
    for f in dataclasses.fields(cls):
        object.__setattr__(mutant, f.name,
                           over.get(f.name, getattr(plan, f.name)))
    return mutant


def errors_of(findings):
    return [f for f in findings if f.severity == ERROR]


def facts(findings):
    """Findings as comparable tuples (the two packages' ``Finding``
    classes differ, so their instances never compare equal)."""
    return [(f.check, f.severity, f.subject, f.message) for f in findings]


def rec4():
    return E.reconstruct(E.erode(4, E.input("f")), E.input("m"),
                         op="dilate")


# ---------------------------------------------------------------------------
# check class a: halo coverage / pad-state discipline
# ---------------------------------------------------------------------------

class TestHalo:
    def test_clean_multi_phase_program_passes(self):
        exe = exe_for(rec4())
        assert A.check_program(exe.program) == []
        assert errors_of(A.check_coverage(
            exe.program, exe.plan, (1, 40, 72))) == []

    def test_wrong_refill_identity_detected(self):
        prog = exe_for(rec4()).program
        segs = list(prog.segments)
        idx = next(i for i, s in enumerate(segs) if s.kind == "refill")
        fill = segs[idx].param("fill")
        flipped = tuple(("fill", "hi" if fill == "lo" else "lo")
                        if n == "fill" else (n, v)
                        for n, v in segs[idx].params)
        segs[idx] = dataclasses.replace(segs[idx], params=flipped)
        bad = dataclasses.replace(prog, segments=tuple(segs))
        errs = errors_of(A.check_program(bad))
        assert errs and any("leak" in f.message for f in errs)

    def test_dropped_refill_detected(self):
        prog = exe_for(rec4()).program
        assert any(s.kind == "refill" for s in prog.segments)
        bad = dataclasses.replace(prog, segments=tuple(
            s for s in prog.segments if s.kind != "refill"))
        assert errors_of(A.check_program(bad))

    def test_input_slot_misbinding_detected(self):
        e = E.reconstruct(E.erode(1, E.input("a")), E.input("b"),
                          op="erode")
        prog = exe_for(e).program
        assert prog.run_input_slots != tuple(
            range(len(prog.run_input_slots)))
        bad = dataclasses.replace(
            prog, run_input_slots=tuple(range(len(prog.run_input_slots))))
        errs = errors_of(A.check_program(bad))
        assert errs and any("before any definition" in f.message
                            for f in errs)

    def test_slot_binding_regression_bit_exact(self):
        """The non-contiguous-slot program runs bit-exact on both port
        engines and equals the reference's."""
        rng = np.random.default_rng(3)
        a = rng.integers(0, 255, (1, 40, 72), dtype=np.uint8)
        b = rng.integers(0, 255, (1, 40, 72), dtype=np.uint8)
        e = E.reconstruct(E.erode(1, E.input("a")), E.input("b"),
                          op="erode")
        outs = [exe_for(e, backend=bk)(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()
                for bk in ("cuda", "torch")]
        np.testing.assert_array_equal(outs[0], outs[1])
        RE = RAPI.E
        ref = RAPI.compile(
            RE.reconstruct(RE.erode(1, RE.input("a")), RE.input("b"),
                           op="erode"), (1, 40, 72), "uint8", "xla")(a, b)
        np.testing.assert_array_equal(outs[0], np.asarray(ref))

    def test_plan_under_coverage_warned(self):
        exe = exe_for(E.erode(6, E.input("f")))
        short = forge_plan(exe.plan, fuse_k=2, band_h=16, n_chunks=1)
        finds = A.check_coverage(exe.program, short, (1, 40, 72))
        assert any(f.severity == WARN and "under-cover" in f.message
                   for f in finds)


# ---------------------------------------------------------------------------
# check class b: dtype safety
# ---------------------------------------------------------------------------

class TestDtypes:
    def test_bucketer_fills_clean(self):
        assert errors_of(A.check_bucketer_fills()) == []
        assert facts(A.check_bucketer_fills()) == facts(
            RA.check_bucketer_fills())

    def test_non_identity_fill_detected(self):
        assert errors_of(A.check_fill_value("uint8", "hi", 254))
        assert errors_of(A.check_fill_value("float32", "lo", np.inf))
        assert A.check_fill_value("uint8", "hi", 255) == []
        assert A.check_fill_value(torch.uint8, "hi", 255) == []

    def test_unrepresentable_fill_detected(self):
        assert errors_of(A.check_fill_value("uint8", "hi", 255.5))

    def test_qdt_accumulator_overflow(self):
        assert errors_of(A.check_qdt_accumulator("uint16", "int16"))
        assert errors_of(A.check_qdt_accumulator("float32", "int32"))
        assert errors_of(A.check_qdt_accumulator("int32", "float32"))
        assert A.check_qdt_accumulator("uint8") == []
        assert A.check_qdt_accumulator(torch.uint16) == []

    def test_qdt_accumulator_domain_conditional_warns(self):
        for img, acc in (("int32", "int32"), ("float64", "float32")):
            finds = A.check_qdt_accumulator(img, acc)
            assert finds and all(f.severity == WARN for f in finds)
            assert facts(finds) == facts(RA.check_qdt_accumulator(img, acc))

    def test_distance_plane_overflow(self):
        assert errors_of(A.check_distance_plane(2 ** 28, 2 ** 8))
        assert A.check_distance_plane(1000, 16) == []

    @pytest.mark.parametrize("dtype", A.SUPPORTED_DTYPES)
    def test_accumulator_findings_equal_the_reference(self, dtype):
        """Each production accumulator rule gives the reference's
        findings.  float64: both accumulate in float32 (the reference
        because its float64 images are float32 without x64, the port by
        ``qdt_acc_dtype``), so the WARN is the same."""
        assert facts(A.check_qdt_accumulator(dtype)) == facts(
            RA.check_qdt_accumulator(dtype))


# ---------------------------------------------------------------------------
# check class c: plan constraints
# ---------------------------------------------------------------------------

class TestPlans:
    def test_derived_plans_pass(self):
        for h, w in ((64, 64), (33, 70), (200, 128)):
            plan = plan_chain(h, w, "uint8", 8)
            assert errors_of(A.check_plan(plan, (1, h, w))) == []

    def test_band_fuse_violation_detected(self):
        plan = plan_chain(64, 64, "uint8", 8)
        bad = forge_plan(plan, band_h=plan.fuse_k * 2 + 1)
        assert errors_of(A.check_plan(bad))

    def test_ragged_tile_detected(self):
        plan = plan_chain(64, 64, "uint8", 8)
        bad = forge_plan(plan, tile_w=plan.fuse_k + 1)
        errs = errors_of(A.check_plan(bad))
        assert errs and any("tile_w" in f.message for f in errs)

    def test_requeue_exactness_detected(self):
        plan = plan_chain(64, 64, "uint8", 8)
        bad = forge_plan(plan, requeue_halo=0)
        assert errors_of(A.check_plan(bad))

    def test_shape_coverage_detected(self):
        plan = plan_chain(64, 64, "uint8", 8)
        assert errors_of(A.check_plan(plan, (1, plan.height_pad + 1,
                                             plan.width_pad)))
        assert errors_of(A.check_plan(plan, (2, 64, 64)))

    def test_unknown_schedule_detected(self):
        plan = plan_chain(32, 32, np.float32, None, convergent=True)
        errs = errors_of(A.check_plan(forge_plan(plan, schedule="zigzag")))
        assert any("schedule" in f.message for f in errs)

    def test_no_mosaic_diagnostics(self):
        """The TPU compiler's lane rules have no Hopper counterpart: a
        plan with 64-wide tiles and fuse_k-wide halos (the reference
        warns on both) is clean, its launches feasible."""
        plan = ChainPlan(band_h=16, fuse_k=8, width_pad=256, height_pad=64,
                         n_bands=4, n_chunks=1, tile_w=64)
        assert RA.check_mosaic_readiness(plan, "uint8")
        assert not hasattr(A, "check_mosaic_readiness")
        assert A.check_plan(plan) == []
        assert A.check_plan_index_maps(
            plan, "uint8", ("geodesic_tile_step", "qdt_tile_step")) == []


# ---------------------------------------------------------------------------
# check class d: cache-key completeness
# ---------------------------------------------------------------------------

class TestCacheKeys:
    def test_plan_key_is_complete(self):
        plan = plan_chain(64, 96, "uint8", 8)
        assert A.check_plan_key(plan) == []

    def test_plan_key_gap_detected(self):
        plan = plan_chain(64, 96, "uint8", 8)
        broken = lambda p: (p.band_h, p.fuse_k, p.width_pad,  # noqa: E731
                            p.height_pad)
        finds = A.check_plan_key(plan, key_of=broken)
        assert finds and all(f.check == "cache-key" for f in finds)
        assert any("n_chunks" in f.message for f in finds)

    @pytest.mark.parametrize("backend", ["cuda", "torch"])
    def test_executable_key_is_complete(self, backend):
        exe = exe_for(rec4(), backend=backend)
        assert A.check_executable_key(exe) == []

    def test_executable_key_gap_detected(self):
        exe = exe_for(E.erode(4, E.input("f")))
        broken = lambda x: x.key[:2]  # noqa: E731
        finds = A.check_executable_key(exe, key_of=broken)
        insensitive = {f.message.split(" — ")[0] for f in finds}
        assert any("was_2d" in m for m in insensitive)
        assert any("max_chunks" in m for m in insensitive)
        assert any("device" in m for m in insensitive)

    def test_device_is_perturbed(self):
        """A key without the device would let a CPU executable answer for
        a CUDA one (different code, different device)."""
        exe = exe_for(E.erode(4, E.input("f")))
        no_device = lambda x: x.key[:-1]  # noqa: E731
        finds = A.check_executable_key(exe, key_of=no_device)
        assert [f.message.split(" — ")[0] for f in finds] == [
            "insensitive to device"]


# ---------------------------------------------------------------------------
# check class e: the CUDA launchers' geometry (the port's index maps)
# ---------------------------------------------------------------------------

#: a 3-image stack of 2 bands each, K = 16, 160-column tiles (off 128)
TILE = IM.Launch("geodesic_tile_step", "uint8", 16, 3 * 2 * 32, 320, 32,
                 160, bands_per_image=2)


def _short_sub_c(g, sh):
    """The launch with ``n_sub_c`` one short, as ``sub_tiles`` would
    count it."""
    bad = dataclasses.replace(g, n_sub_c=g.n_sub_c - 1)
    return bad, dataclasses.replace(
        sh, n_sub=-(-g.cell_h // g.tb) * bad.n_sub_c)


def _unclamped_tw(g, cell, sub):
    """``locate`` with the ragged sub-tile's width not clamped at the
    cell edge."""
    f = list(IM.locate(g, cell, sub))
    f[1] = np.full(np.shape(cell), g.tw)
    f[3] = f[1] + 2 * g.k
    return tuple(f)


class TestIndexMaps:
    @pytest.mark.parametrize("dtype", IM.DTYPE_CODES)
    def test_real_launches_in_bounds(self, dtype):
        kernels = [k for k in IM.KERNELS
                   if IM.KERNELS[k][0] != "gdt" or dtype.startswith("float")]
        for kwargs in ({}, {"tile_w": 64}):
            plan = ChainPlan(band_h=16, fuse_k=8, width_pad=128,
                             height_pad=64, n_bands=4, n_chunks=2,
                             n_images=2, compact_threshold=0.25, **kwargs)
            assert A.check_plan_index_maps(plan, dtype, kernels) == []

    def test_ragged_subtile_unclamped_detected(self):
        g, sh = IM.launch_shape(TILE)
        assert g.cell_w % g.tw  # a ragged last sub-tile exists
        finds = A.check_partition(TILE, g, sh, locate=_unclamped_tw)
        assert any("outside their cell" in f.message for f in finds)
        assert any("more than once" in f.message for f in finds)
        compact = dataclasses.replace(TILE, kernel="geodesic_compact_step",
                                      rows=3, width=192)
        g, sh = IM.launch_shape(compact)
        finds = A.check_partition(compact, g, sh, locate=_unclamped_tw)
        assert any("outside the output" in f.message for f in finds)

    def test_wrong_rows_per_image_detected(self):
        g, sh = IM.launch_shape(TILE)
        for rpi in (g.cell_h, 3 * g.rows_per_image):
            bad = dataclasses.replace(g, rows_per_image=rpi)
            finds = A.check_windows(TILE, bad, sh)
            assert any("outside the cell's image" in f.message
                       for f in finds), rpi

    def test_n_sub_c_one_short_detected(self):
        g, sh = IM.launch_shape(TILE)
        bad, bad_sh = _short_sub_c(g, sh)
        finds = A.check_partition(TILE, bad, bad_sh)
        assert any("never written" in f.message for f in finds)

    def test_shape_over_227_kb_detected(self):
        g, sh = IM.launch_shape(TILE)
        bad = dataclasses.replace(sh, smem=IM.MAX_SMEM + 1)
        finds = IM.check_feasibility(TILE, g, bad)
        assert any("227" in f.message or str(IM.MAX_SMEM) in f.message
                   for f in finds)
        many = dataclasses.replace(sh, ncol=sh.max_threads // 32 + 1)
        assert any("threads" in f.message
                   for f in IM.check_feasibility(TILE, g, many))

    def test_window_not_the_halo_detected(self):
        g, sh = IM.launch_shape(TILE)

        def shifted(g, cell, sub):
            f = list(IM.locate(g, cell, sub))
            f[4] = f[4] + 1  # window one row low
            return tuple(f)

        finds = A.check_windows(TILE, g, sh, locate=shifted)
        assert any("halo" in f.message for f in finds)

    def test_infeasible_k_reported(self):
        """K = 64 on a float32 chain needs more sub-tiles a cell than a
        grid takes (the launcher returns cudaErrorInvalidValue)."""
        plan = ChainPlan(band_h=512, fuse_k=64, width_pad=1024,
                         height_pad=1024, n_bands=2, n_chunks=1)
        finds = A.check_plan_index_maps(plan, "float32", ["chain_step"])
        assert finds and "cudaErrorInvalidValue" in finds[0].message
        assert A.check_plan_index_maps(plan, "uint8", ["chain_step"]) == []

    def test_gdt_probes_kreg_before_kiwin(self):
        launch = IM.Launch("gdt_tile_step", "float32", 16, 1024, 1024, 64,
                           128, 16)
        picks = {}
        for k in (16, 31, 32):
            for dtype in ("float32", "float64"):
                _, sh = IM.launch_shape(dataclasses.replace(
                    launch, k=k, dtype=dtype))
                picks[k, dtype] = sh.body
        assert picks[16, "float32"] == picks[31, "float32"] == \
            "gdt_kernel<kReg>"
        assert {picks[32, "float32"], picks[16, "float64"]} == {
            "gdt_kernel<kIwin>"}
        _, sh = IM.launch_shape(dataclasses.replace(launch, lamb=0.0))
        assert sh.body == "gdt_kernel<kUnit>"
        assert IM.launch_shape(dataclasses.replace(
            launch, dtype="uint8"))[1] is None

    def test_qdt_packed_body_below_k128(self):
        base = IM.Launch("qdt_chain_step", "uint8", 32, 1024, 1024, 512,
                         1024, 2)
        assert IM.launch_shape(base)[1].body == "qdt_u8_kernel"
        for k in (128, 130):
            _, sh = IM.launch_shape(dataclasses.replace(base, k=k))
            assert sh is None or sh.body == "qdt_pixel_kernel"
        _, sh = IM.launch_shape(dataclasses.replace(base, kernel="chain_step"))
        assert sh.body == "morph_u8_kernel"

    def test_tie_breaks_differ_by_source(self):
        """At equal warps the morphology and QDT launchers take more
        blocks, the gdt fewer: the model keeps each source's own."""
        g = IM.Geo(src_w=1024, out_w=1024, k=32, cell_h=512, cell_w=1024,
                   n_tiles=1, rows_per_image=1024, compact=False)
        body = IM._Body(0, "b", 32, 128, 8, 1, 512, 2, True)
        more = IM._pick_shape(g, body)
        fewer = IM._pick_shape(g, body._replace(more_blocks=False))
        blocks = [-(-512 // tb) * -(-1024 // tw) for tb, tw, *_ in
                  (more, fewer)]
        warps = [b * s[2] * s[3] for b, s in zip(blocks, (more, fewer))]
        assert warps[0] == warps[1] and blocks[0] > blocks[1]

    def test_executable_launches_cover_its_segments(self):
        exe = exe_for(E.erode(20, E.input("f")), dtype="uint8")
        # fuse_k 32 covers none of 20 steps: 16 + 4, both on the kernel
        assert sorted(l.k for l in IM.executable_launches(exe)) == [4, 16]
        exe = exe_for(rec4(), shape3=(2, 300, 520))
        names = {l.kernel for l in IM.executable_launches(exe)}
        assert names == {"chain_step", "geodesic_tile_step",
                         "geodesic_compact_step"}
        assert IM.executable_launches(exe_for(rec4(), backend="torch")) == []

    def test_int16_has_no_launcher(self):
        exe = exe_for(E.erode(3, E.input("f")), dtype="int16")
        finds = IM.check_executable_launches(exe)
        assert [f.severity for f in finds] == [WARN]
        on_card = Executable(exe.program, (1, 40, 72), exe.dtype, "cuda",
                             exe.plan, None, False, "cuda")
        assert [f.severity for f in IM.check_executable_launches(
            on_card)] == [ERROR]


# ---------------------------------------------------------------------------
# the gdt's verifier facts (tests/test_gdt.py's, on the port)
# ---------------------------------------------------------------------------

def _gdt_expr():
    return E.gdt(E.input("img"), E.input("seeds"), lamb=1.0)


class TestGdt:
    def test_segment_reach_rejects_unknown_kinds(self):
        from repro_torch.analysis.halo import segment_reach
        with pytest.raises(ValueError, match="unknown segment kind"):
            segment_reach(RunSeg("mystery", (0,), (1,), ()))

    def test_check_program_flags_unknown_kind_and_op(self):
        prog = lower(_gdt_expr())
        live = prog.segments[-1].dsts[0]
        bogus_kind = dataclasses.replace(
            prog, segments=prog.segments
            + (RunSeg("mystery", (live,), (live + 1,), ()),))
        errs = errors_of(A.check_program(bogus_kind))
        assert any("unknown segment kind" in f.message for f in errs)
        bogus_op = dataclasses.replace(
            prog, segments=prog.segments
            + (RunSeg("chain", (live,), (live + 1,),
                      (("n", 1), ("op", "mystery"))),))
        errs = errors_of(A.check_program(bogus_op))
        assert any("unknown op" in f.message for f in errs)

    def test_dtype_check_flags_gdt_on_integers(self):
        from repro_torch.analysis.dtypes import check_executable_dtypes
        exe = types.SimpleNamespace(
            dtype=torch.uint8, plan=None,
            program=types.SimpleNamespace(
                segments=(RunSeg("gdt", (0, 1), (2,),
                                 (("lamb", 1.0), ("nu", 1e6))),)))
        errs = errors_of(check_executable_dtypes(exe))
        assert any("gdt" in f.subject for f in errs)
        clean = exe_for(_gdt_expr(), (1, 32, 32), "float32")
        assert errors_of(check_executable_dtypes(clean)) == []

    @pytest.mark.parametrize("lamb", (0.0, 1.0))
    def test_verifier_passes_gdt_programs(self, lamb):
        for schedule in ("wavefront", "raster"):
            plan = plan_chain(40, 36, "float32", None, convergent=True,
                              schedule=schedule)
            exe = compile_expr(
                E.gdt(E.input("img"), E.input("seeds"), lamb=lamb),
                (40, 36), "float32", plan=plan, device="cpu")
            report = A.verify_executable(exe, level="full")
            assert report.ok, str(report)
            kernels = {l.kernel for l in IM.executable_launches(exe)}
            assert bool(kernels) == (schedule == "wavefront")


# ---------------------------------------------------------------------------
# orchestration: verifier levels, compile hook, lint
# ---------------------------------------------------------------------------

class TestVerifier:
    def test_full_level_clean_on_registry_sample(self):
        from repro_torch.analysis.lint import iter_registry_cases
        cases = list(iter_registry_cases(
            dtypes=("uint8",), shapes=((1, 48, 64),), backends=("cuda",)))
        assert cases
        for _label, expr, shape3, dtype, backend in cases:
            exe = compile_expr(expr, shape3, dtype, backend, verify=False,
                               device="cpu")
            report = A.verify_executable(exe, level="full")
            assert report.ok, str(report)

    def test_hook_raises_on_seeded_violation(self):
        exe = exe_for(E.erode(4, E.input("f")))
        bad_prog = dataclasses.replace(
            exe.program,
            run_input_slots=tuple(s + 7 for s in
                                  exe.program.run_input_slots))
        bad = Executable(bad_prog, (1, 40, 72), torch.uint8, "cuda",
                         exe.plan, None, False, "cpu")
        report = A.verify_executable(bad, level="fast")
        with pytest.raises(VerificationError) as ei:
            report.raise_if_errors()
        assert isinstance(ei.value, AssertionError)

    def test_hook_env_toggle(self, monkeypatch):
        from repro_torch.analysis.verifier import verify_on_compile
        monkeypatch.setenv("REPRO_VERIFY", "0")
        assert not verify_on_compile()
        monkeypatch.setenv("REPRO_VERIFY", "1")
        assert verify_on_compile()

    def test_sound_level_replays_the_rewrites(self):
        e = E.opening(2, E.opening(2, E.input("f")))
        exe = compile_expr(e, (1, 24, 33), "uint8", device="cpu")
        assert exe.rewrite_trace
        assert A.verify_executable(exe, level="sound").ok
        from repro_torch.analysis.rewrites import replay_applied
        step = exe.rewrite_trace[0]
        wrong = dataclasses.replace(step, after=E.erode(1, E.input("f")))
        finds = replay_applied(wrong, device="cpu")
        assert errors_of(finds) and "not bit-exact" in finds[0].message

    def test_lint_cli_clean(self, capsys):
        from repro_torch.analysis.lint import main
        rc = main(["--device", "cpu", "--dtypes", "uint8", "--shapes",
                   "1x48x64", "--backends", "torch"])
        out = capsys.readouterr().out
        assert rc == 0 and "lint: ok" in out

    def test_lint_cli_rejects_bad_shape(self):
        from repro_torch.analysis.lint import main
        with pytest.raises(SystemExit):
            main(["--device", "cpu", "--shapes", "48x64"])

    def test_lint_runs_on_the_gpu_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("this machine has a GPU; the default runs there")
        from repro_torch.analysis.lint import main
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--dtypes", "uint8", "--shapes", "1x48x64"])


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

#: the reference's engines and their port counterparts
ENGINES = {"pallas": "cuda", "xla": "torch"}

#: the check classes both verifiers have
SHARED = ("halo", "dtype", "plan", "cache-key")


def _shared(report):
    """Findings of the shared classes as comparable tuples; the
    reference's Mosaic-readiness warnings (check "plan", subject
    "mosaic/…") have no port counterpart (``analysis/plans.py``)."""
    return facts(f for f in report.findings
                 if f.check in SHARED and not f.subject.startswith("mosaic/"))


def test_full_report_equals_the_reference_on_the_registry():
    ref = list(ref_cases(dtypes=("uint8", "float32"),
                         shapes=((1, 48, 64), (2, 33, 70))))
    from repro_torch.analysis.lint import iter_registry_cases
    port = list(iter_registry_cases(dtypes=("uint8", "float32"),
                                    shapes=((1, 48, 64), (2, 33, 70))))
    assert [(l.split("[")[0], s, d, ENGINES[b]) for l, _, s, d, b in ref] \
        == [(l.split("[")[0], s, d, b) for l, _, s, d, b in port]
    for (label, rexpr, shape3, dtype, rb), (_, pexpr, _, _, pb) in zip(
            ref, port):
        rexe = RAPI.compile(rexpr, shape3, dtype, rb, verify=False)
        pexe = compile_expr(pexpr, shape3, dtype, pb, verify=False,
                            device="cpu")
        assert pexe.stats() == {k: (v if k != "backend" else pb)
                                for k, v in rexe.stats().items()}, label
        rrep = RA.verify_executable(rexe, level="full")
        prep = A.verify_executable(pexe, level="full")
        assert _shared(prep) == _shared(rrep), label
        assert prep.ok, str(prep)


def _ref_forged(plan_key, **over):
    return forge_plan(types.SimpleNamespace(**dict(zip(
        [f.name for f in dataclasses.fields(RefPlan)], plan_key))),
        cls=RefPlan, **over)


PLAN_MUTATIONS = {
    "band_fuse": lambda p: dict(band_h=p.fuse_k * 2 + 1),
    "ragged_tile": lambda p: dict(tile_w=p.fuse_k + 1),
    "requeue": lambda p: dict(requeue_halo=0),
    "n_bands": lambda p: dict(n_bands=p.n_bands + 1),
    "capacity": lambda p: dict(compact_threshold=1.5),
    "schedule": lambda p: dict(schedule="zigzag"),
    "under_cover": lambda p: dict(fuse_k=2, band_h=16, n_chunks=1),
}


@pytest.mark.parametrize("mutation", PLAN_MUTATIONS)
def test_plan_findings_equal_the_reference(mutation):
    """The same forged plan under the same program: the port's plan and
    halo findings equal the reference's."""
    pexe = exe_for(E.erode(6, E.input("f")))
    RE = RAPI.E
    rexe = RAPI.compile(RE.erode(6, RE.input("f")), (1, 40, 72), "uint8",
                        "pallas", verify=False)
    assert pexe.plan.key == rexe.plan.key
    over = PLAN_MUTATIONS[mutation](pexe.plan)
    pbad, rbad = forge_plan(pexe.plan, **over), _ref_forged(
        rexe.plan.key, **over)
    got = A.check_plan(pbad, (1, 40, 72)) + A.check_coverage(
        pexe.program, pbad, (1, 40, 72))
    want = RA.check_plan(rbad, (1, 40, 72)) + RA.check_coverage(
        rexe.program, rbad, (1, 40, 72))
    assert got and facts(got) == facts(want)


def _drop_refill(prog):
    return dataclasses.replace(prog, segments=tuple(
        s for s in prog.segments if s.kind != "refill"))


def _flip_refill(prog):
    segs = list(prog.segments)
    i = next(i for i, s in enumerate(segs) if s.kind == "refill")
    segs[i] = dataclasses.replace(segs[i], params=tuple(
        (n, {"hi": "lo", "lo": "hi"}.get(v, v)) for n, v in segs[i].params))
    return dataclasses.replace(prog, segments=tuple(segs))


def _misbind(prog):
    return dataclasses.replace(prog, run_input_slots=tuple(
        s + 7 for s in prog.run_input_slots))


def _dangling_output(prog):
    return dataclasses.replace(prog, run_outputs=tuple(
        o + 1000 for o in prog.run_outputs))


PROGRAM_MUTATIONS = {"drop_refill": _drop_refill, "flip_refill": _flip_refill,
                     "misbind": _misbind, "dangling_output": _dangling_output}


@pytest.fixture
def fresh_caches():
    """Empty compile caches on both sides, before (a cached executable
    would skip the build and its hook) and after (the mutants built with
    ``verify=False`` must not serve later tests)."""
    RAPI.clear_cache()
    TAPI.clear_cache()
    yield
    RAPI.clear_cache()
    TAPI.clear_cache()


@pytest.mark.parametrize("mutation", PROGRAM_MUTATIONS)
def test_compile_hook_raises_as_the_reference_does(mutation, monkeypatch,
                                                   fresh_caches):
    """A seeded program mutation behind ``lower``: the reference's
    ``compile(verify=True)`` raises, so does the port's, with the same
    findings; ``verify=False`` lets both build."""
    mutate = PROGRAM_MUTATIONS[mutation]
    # the packages' ``api`` re-export ``compile`` over its module's name
    for mod in (importlib.import_module("repro.api.compile"),
                importlib.import_module("repro_torch.api.compile")):
        real = mod.lower
        monkeypatch.setattr(mod, "lower",
                            lambda e, _real=real: mutate(_real(e)))
    RE = RAPI.E
    rexpr = RE.reconstruct(RE.erode(4, RE.input("f")), RE.input("m"),
                           op="dilate")
    with pytest.raises(RA.VerificationError) as rerr:
        RAPI.compile(rexpr, (1, 40, 72), "uint8", "pallas", verify=True)
    with pytest.raises(VerificationError) as perr:
        compile_expr(rec4(), (1, 40, 72), "uint8", "cuda", verify=True,
                     device="cpu")
    assert [str(f) for f in perr.value.errors] == \
        [str(f) for f in rerr.value.errors]
    compile_expr(rec4(), (1, 40, 72), "uint8", "cuda", verify=False,
                 device="cpu")


def test_compile_hook_raises_on_a_forged_plan(fresh_caches):
    """A forged plan passed to ``compile`` (past ``__post_init__``): the
    hook raises on both sides, with the same findings."""
    pplan = plan_chain(40, 72, "uint8", 6)
    RE = RAPI.E
    rbad = _ref_forged(pplan.key, band_h=pplan.fuse_k * 2 + 1)
    pbad = forge_plan(pplan, band_h=pplan.fuse_k * 2 + 1)
    with pytest.raises(RA.VerificationError) as rerr:
        RAPI.compile(RE.erode(6, RE.input("f")), (1, 40, 72), "uint8",
                     "pallas", plan=rbad, verify=True)
    with pytest.raises(VerificationError) as perr:
        compile_expr(E.erode(6, E.input("f")), (1, 40, 72), "uint8",
                     plan=pbad, verify=True, device="cpu")
    assert [str(f) for f in perr.value.errors] == \
        [str(f) for f in rerr.value.errors]
