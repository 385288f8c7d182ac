"""The port's requeue scheduler against the reference's, under the same
explicit ``ChainPlan`` carried across with ``plan_from_key``: outputs
*and* scheduler statistics (chunks, scheduled cells, the per-chunk
trace, the convergence verdict) must equal the JAX ``"pallas"`` engine's
(Pallas interpret mode on the CPU).  Row-only, tiled and compacting
plans on a 2-image stack of ragged 48×260 images.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.chain import ChainPlan
from repro.data.images import blobs
from repro.kernels import ops as RO
from repro_torch.core import morphology as TM
from repro_torch.core.chain import plan_from_key
from repro_torch.kernels import ops as TO

PLANS = {
    # (tile_w, compact_threshold): 3 bands × 3 tiles per image at K=8
    "rows-compact": (0, 0.5),
    "tiled": (128, 0.0),
    "tiled-compact": (128, 0.5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: under several pytest
    workers on one machine each worker's torch thread pool
    oversubscribes the cores and its threads spin, which made cases
    here up to 100× slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(tile_w, threshold):
    return ChainPlan(16, 8, 384, 48, 3, 1, n_images=2,
                     compact_threshold=threshold, tile_w=tile_w)


def _inputs(dtype, op):
    f = np.stack([blobs(48, 260, dtype, seed=s) for s in (0, 1)])
    if op == "dilate":   # HMAX-style marker below the mask
        h = 40 if dtype == np.uint8 else 0.15
        marker = (np.where(f > h, f - h, 0) if dtype == np.uint8
                  else f - np.float32(h)).astype(dtype)
    else:                # HFILL-style marker above the mask
        marker = f.copy()
        marker[:, 1:-1, 1:-1] = f.max(axis=(1, 2), keepdims=True)
    return marker, f


def _assert_stats_equal(ref, port):
    assert int(ref.chunks) == int(port.chunks)
    assert int(ref.active_band_sum) == int(port.active_band_sum)
    assert int(ref.total_bands) == int(port.total_bands)
    assert np.array_equal(np.asarray(ref.active_per_chunk),
                          port.active_per_chunk.numpy())
    assert bool(ref.converged) == bool(port.converged)


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("dtype,op", [(np.uint8, "dilate"),
                                      (np.float32, "erode")],
                         ids=["uint8-dilate", "float32-erode"])
def test_reconstruct_stats_match_reference(kind, dtype, op):
    marker, mask = _inputs(dtype, op)
    plan = _plan(*PLANS[kind])
    ref, ref_stats = RO.reconstruct_with_stats(
        jnp.asarray(marker), jnp.asarray(mask), op, "pallas", plan=plan)
    port, port_stats = TO.reconstruct_with_stats(
        torch.from_numpy(marker), torch.from_numpy(mask), op, "cuda",
        plan=plan_from_key(plan.key), device="cpu")
    assert np.array_equal(np.asarray(ref), port.numpy())
    _assert_stats_equal(ref_stats, port_stats)
    assert int(port_stats.chunks) > 1
    if PLANS[kind][1]:
        # the sparse tail of the wavefront ran on the compact workspace
        cap = plan.compact_capacity
        trace = port_stats.active_per_chunk[: int(port_stats.chunks)]
        assert bool((trace <= cap).any())


def test_budget_truncation_matches_reference():
    marker, mask = _inputs(np.uint8, "dilate")
    plan = _plan(128, 0.5)
    ref, ref_stats = RO.reconstruct_with_stats(
        jnp.asarray(marker), jnp.asarray(mask), "dilate", "pallas",
        max_chunks=3, plan=plan)
    port, port_stats = TO.reconstruct_with_stats(
        torch.from_numpy(marker), torch.from_numpy(mask), "dilate", "cuda",
        max_chunks=3, plan=plan_from_key(plan.key), device="cpu")
    assert np.array_equal(np.asarray(ref), port.numpy())
    _assert_stats_equal(ref_stats, port_stats)
    assert not bool(port_stats.converged)


def test_oracle_engine_stats_match_reference():
    marker, mask = _inputs(np.uint8, "dilate")
    ref, ref_stats = RO.reconstruct_with_stats(
        jnp.asarray(marker[0]), jnp.asarray(mask[0]), "dilate", "xla")
    port, port_stats = TO.reconstruct_with_stats(
        torch.from_numpy(marker[0]), torch.from_numpy(mask[0]), "dilate",
        "torch", device="cpu")
    assert np.array_equal(np.asarray(ref), port.numpy())
    _assert_stats_equal(ref_stats, port_stats)


def test_planned_reconstruction_equals_oracle_per_image():
    """Without an explicit plan (the planner's own tiled, compacting
    choice), each stacked image converges to its own oracle result, and
    the wavefront from a corner seed leaves cells unscheduled."""
    mask = np.stack([blobs(48, 260, np.uint16, seed=s) for s in (2, 3)])
    marker = np.zeros_like(mask)
    marker[:, :3, :3] = mask[:, :3, :3]
    out, stats = TO.reconstruct_with_stats(
        torch.from_numpy(marker), torch.from_numpy(mask), "dilate",
        device="cpu")
    for i in range(2):
        want = TM.dilate_reconstruct(torch.from_numpy(marker[i]),
                                     torch.from_numpy(mask[i]))
        assert torch.equal(out[i].view(torch.int16), want.view(torch.int16))
    assert bool(stats.converged)
    assert int(stats.active_band_sum) < int(stats.total_bands) * int(
        stats.chunks)


def test_reband_crops_and_repads():
    src = plan_from_key(_plan(0, 0.0).key)                 # 48 × 384 pads
    dst = plan_from_key(ChainPlan(32, 8, 256, 64, 2, 1, n_images=2).key)
    x3 = torch.arange(2 * 40 * 250, dtype=torch.int32).reshape(2, 40, 250)
    x2 = TO._stacked(TO._pad(x3, src, -1))
    moved = TO._reband(x2, 2, 40, 250, dst, -7)
    assert moved.shape == (2 * 64, 256)
    assert torch.equal(moved, TO._stacked(TO._pad(x3, dst, -7)))
    assert torch.equal(TO._crop3(moved, 2, 40, 250), x3)


def test_compaction_helpers_mask_sentinel_slots():
    plan = plan_from_key(_plan(128, 0.5).key)
    total = plan.total_tiles
    active = torch.zeros((plan.total_bands, plan.n_tiles), dtype=torch.int32)
    active[1, 2] = active[4, 0] = 1
    idx, valid = TO._active_indices(active, plan)
    assert idx.tolist()[:2] == [5, 12]
    assert set(idx.tolist()[2:]) == {total}
    assert valid.ravel().tolist() == [1, 1] + [0] * (len(idx) - 2)
    x2 = torch.arange(plan.total_bands * plan.band_h * plan.width_pad,
                      dtype=torch.int32).reshape(-1, plan.width_pad)
    mids = TO._gather_mid(x2, idx, plan)
    back = TO._scatter_mid(x2, idx, mids, plan)
    assert torch.equal(back, x2)   # sentinel writes never land
    flags = TO._scatter_flags(torch.ones((len(idx), 1), dtype=torch.int32),
                              idx, plan)
    assert flags.sum() == 2 and flags[1, 2] == 1 and flags[4, 0] == 1
