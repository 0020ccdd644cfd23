"""Kernel 1 of the port (segment FFT + cross-spectra + banked
accumulation, ``tdoa_tpu_torch/ops/kernels/corr_accum.py``) against the
JAX fused Pallas kernel it replaces (interpret mode on the CPU), and its
own invariants. On the CPU the wrapper runs the kernel's plain torch
version; the CUDA kernel itself is held to that version on the card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fm_block  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax.numpy as jnp
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.ops.corr import _split_bounds as jax_split_bounds
    from tdoa_tpu.ops.pallas.corr_accum import accumulate_cross_spectra_pallas
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.ops.corr import correlate_pairs_fused
from tdoa_tpu_torch.ops.kernels import corr_accum
from tdoa_tpu_torch.ops.kernels.corr_accum import (
    FFT_LEN,
    SEG_LEN,
    accumulate_banks,
    accumulate_cross_spectra,
    bank_bounds,
    slot_plan,
)

PAIRS = ((0, 1), (0, 2), (1, 2))


@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_plain_kernel_matches_jax_bf16_production_config(n_splits):
    """bf16 operands + in-kernel DC removal, the production setting.
    Tolerance 2e-2 of the spectrum's peak magnitude: the bound
    tests/test_fused_corr.py uses for the TPU kernel's bf16 DFT
    operands against f32 (the port transforms in f32)."""
    x = fm_block(3, 4 * SEG_LEN, [0.0, 17.25, -5.5], seed=1,
                 dc=(0.02, -0.015))
    jc, jp, je = accumulate_cross_spectra_pallas(
        C(jnp.asarray(x[0]), jnp.asarray(x[1])), PAIRS, precision="bf16",
        remove_dc=True, n_splits=n_splits, interpret=True)
    tc, tp, te = accumulate_cross_spectra(
        torch.from_numpy(x).to(torch.bfloat16), PAIRS, remove_dc=True,
        n_splits=n_splits)
    scale = float(np.abs(np.asarray(jc.re) + 1j * np.asarray(jc.im)).max())
    np.testing.assert_allclose(tc.real.numpy() / scale,
                               np.asarray(jc.re) / scale, atol=2e-2)
    np.testing.assert_allclose(tc.imag.numpy() / scale,
                               np.asarray(jc.im) / scale, atol=2e-2)
    pscale = float(np.asarray(jp).max())
    np.testing.assert_allclose(tp.numpy() / pscale, np.asarray(jp) / pscale,
                               atol=2e-2)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-3)


def test_dc_removal_linearity():
    """remove_dc folds in at finalize (FFT(x−m) = FFT(x) − m·D); it must
    match demeaning the signal before the accumulation (f32, 1e-4 of
    the peak)."""
    rng = np.random.default_rng(3)
    n = 2 * SEG_LEN
    x = rng.standard_normal((2, 2, n)).astype(np.float32)
    x[0] += 0.21
    x[1] -= 0.13
    c_dc, p_dc, e_dc = accumulate_cross_spectra(
        torch.from_numpy(x), ((0, 1),), remove_dc=True)
    xd = x - x.mean(axis=-1, keepdims=True)
    c_ref, p_ref, e_ref = accumulate_cross_spectra(
        torch.from_numpy(xd), ((0, 1),), remove_dc=False)
    scale = float(c_ref.abs().max())
    np.testing.assert_allclose((c_dc / scale).real.numpy(),
                               (c_ref / scale).real.numpy(), atol=1e-4)
    np.testing.assert_allclose((c_dc / scale).imag.numpy(),
                               (c_ref / scale).imag.numpy(), atol=1e-4)
    np.testing.assert_allclose(e_dc.numpy(), e_ref.numpy(), rtol=1e-4)


def test_prescale_is_unit_rms_normalization():
    """Deferred per-station scaling equals pre-scaling the signal."""
    rng = np.random.default_rng(4)
    x = (3.7 * rng.standard_normal((2, 2, SEG_LEN))).astype(np.float32)
    c_s, p_s, e_s = accumulate_cross_spectra(torch.from_numpy(x), ((0, 1),),
                                             prescale=True)
    rms = np.sqrt((x[0] ** 2 + x[1] ** 2).mean(axis=-1))
    c_r, p_r, e_r = accumulate_cross_spectra(
        torch.from_numpy(x / rms[None, :, None]), ((0, 1),))
    scale = float(c_r.abs().max())
    np.testing.assert_allclose((c_s / scale).real.numpy(),
                               (c_r / scale).real.numpy(), atol=1e-4)
    np.testing.assert_allclose(e_s.numpy(), [SEG_LEN, SEG_LEN])


def test_banks_sum_to_the_single_bank():
    """The K split banks partition the segments: their raw sums are the
    one-bank accumulators (f32 summation order, 1e-5 of the peak)."""
    x = torch.from_numpy(fm_block(3, 5 * SEG_LEN, [0, 3, -2], seed=2))
    c1, p1, s1 = accumulate_banks(x, PAIRS, 1, True)
    c4, p4, s4 = accumulate_banks(x, PAIRS, 4, True)
    scale = float(c1.abs().max())
    assert float((c4.sum(0) - c1[0]).abs().max()) / scale < 1e-5
    assert float((p4.sum(0) - p1[0]).abs().max()) / float(p1.max()) < 1e-5
    assert float((s4.sum(0) - s1[0]).abs().max()) / float(
        s1.abs().max()) < 1e-5


@pytest.mark.parametrize("n_seg", [4, 8, 11, 443])
@pytest.mark.parametrize("K", [2, 4])
def test_bank_bounds_match_split_bounds(n_seg, K):
    """Banks are bounded exactly by ops.corr._split_bounds (443 is the
    segment count of a 10 s block: 111/111/111/110)."""
    assert [b * SEG_LEN for b in bank_bounds(n_seg, K)] == jax_split_bounds(
        n_seg, K, SEG_LEN)


@pytest.mark.parametrize("n_seg", [5, 16, 96, 100, 443, 1480])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_slot_plan_lists_every_segment_once(n_seg, K):
    """The kernel's segment slots: each bank as long as the longest
    (``run``), listing all of its segments once, in order, −1 only past
    its end; over the banks every segment appears exactly once (1480
    segments is the 100 s maximum capture). The one scratch holds every
    slot of every station."""
    plan = slot_plan(n_seg, K)
    run = -(-n_seg // K)
    assert plan.dtype == np.int32 and plan.shape == (K * run,)
    b = bank_bounds(n_seg, K)
    per_bank = plan.reshape(K, run)
    for k in range(K):
        n = b[k + 1] - b[k]
        np.testing.assert_array_equal(per_bank[k, :n],
                                      np.arange(b[k], b[k + 1]))
        assert (per_bank[k, n:] == -1).all()
    np.testing.assert_array_equal(np.sort(plan[plan >= 0]), np.arange(n_seg))
    assert corr_accum.scratch_bytes(12, K, n_seg) \
        == 12 * K * run * FFT_LEN * 8


def test_timeline_build_has_its_own_hash():
    """A build with the timeline stamps compiled in (-DTDOA_TIMELINE)
    goes into its own directory: it never replaces the plain build."""
    from tdoa_tpu_torch.ops.kernels import _build

    plain = _build._digest(_build._flags(()))
    assert plain == _build._digest(_build._flags(()))
    assert plain != _build._digest(_build._flags(("TDOA_TIMELINE",)))


def test_load_keeps_one_build_per_process(monkeypatch):
    """Once a build is loaded, a call without defines returns it and a
    call asking for other defines raises instead of mixing builds."""
    from tdoa_tpu_torch.ops.kernels import _build

    loaded = object()
    monkeypatch.setattr(_build, "_lib", loaded)
    monkeypatch.setattr(_build, "_lib_defines", ())
    assert _build.load() is loaded
    assert _build.load(()) is loaded
    with pytest.raises(RuntimeError, match="TDOA_TIMELINE"):
        _build.load(("TDOA_TIMELINE",))


def test_short_capture_rejected():
    x = torch.zeros(2, 2, SEG_LEN - 1)
    with pytest.raises(ValueError, match="shorter than one kernel segment"):
        accumulate_cross_spectra(x, ((0, 1),))


def test_aliased_max_lag_rejected():
    """max_lag beyond the zero-pad slack (FFT_LEN − SEG_LEN) would alias."""
    x = torch.zeros(2, 2, 2 * SEG_LEN)
    with pytest.raises(ValueError, match="alias-free"):
        correlate_pairs_fused(x, ((0, 1),), max_lag=FFT_LEN - SEG_LEN + 1)


def test_too_many_splits_rejected():
    x = torch.zeros(2, 2, 2 * SEG_LEN)
    with pytest.raises(ValueError, match="exceeds the segment count"):
        accumulate_cross_spectra(x, ((0, 1),), n_splits=4)


def test_dc_heavy_input_stays_finite():
    """The DC fold-in cancels large near-equal terms; the psd ≥ 0 clamp
    keeps HT's sqrt from turning the correlation NaN."""
    rng = np.random.default_rng(3)
    n = 2 * SEG_LEN
    sig = rng.standard_normal(n).astype(np.float32) * 0.05
    x = np.stack([
        np.stack([sig + 0.0055, np.roll(sig, 9) + 0.0048]),
        np.stack([sig * 0.5 - 0.003, np.roll(sig, 9) * 0.5 + 0.004]),
    ]).astype(np.float32)
    res = correlate_pairs_fused(torch.from_numpy(x), ((0, 1),), max_lag=256,
                                weighting="ht", remove_dc=True)
    assert torch.isfinite(res.corr).all()
    assert torch.isfinite(res.quality[0])
    assert abs(float(res.delay[0]) - 9.0) < 0.1


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the CUDA kernel: the launch count
    stays put."""
    before = accumulate_banks.launches
    accumulate_banks(torch.zeros(2, 2, SEG_LEN), ((0, 1),))
    assert accumulate_banks.launches == before


def _all_pairs(n_st):
    return tuple((i, j) for i in range(n_st) for j in range(i + 1, n_st))


def _stacked_pairs(n_st, blocks=3):
    """The overlapped ingest's layout: the pairs of ``n_st`` stations in
    each of ``blocks`` stacked blocks of rows."""
    return tuple((n_st * b + i, n_st * b + j) for b in range(blocks)
                 for i, j in _all_pairs(n_st))


H100_SMEM_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin


@pytest.mark.parametrize("layout", ["all pairs of 5", "3 stacked blocks"])
def test_tiled_accumulation_matches_single_launch(layout):
    """Pair tiles forced to 4 pairs (the port of
    tests/test_fused_corr.py::test_fused_pair_tiling_matches_single_invocation)
    give the untiled accumulators bitwise, in 2 banks with DC sums: each
    tile runs the same sums on the same rows. The stacked layout splits
    into its row blocks first, each block's PSD from its own tile."""
    if layout == "all pairs of 5":
        n_st, pairs = 5, _all_pairs(5)
    else:
        n_st, pairs = 12, _stacked_pairs(4)
    x = torch.from_numpy(fm_block(n_st, 2 * SEG_LEN, np.arange(n_st) * 3.5,
                                  seed=3, dc=(0.01, -0.02)))
    assert len(corr_accum.plan_tiles(pairs, n_st, True, max_pairs=4)) > 1
    one = accumulate_banks(x, pairs, 2, True)
    tiled = accumulate_banks(x, pairs, 2, True, max_pairs=4)
    for a, b in zip(tiled, one):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_st,stacked,max_pairs", [
    (5, False, 4), (5, False, 1), (24, False, 46), (24, False, 7),
    (3, True, 2), (12, True, 17), (8, True, 28)])
def test_tile_planner_covers_every_pair_once_in_order(n_st, stacked,
                                                      max_pairs):
    """Tiles partition the pair list in order, each a run of consecutive
    pairs on rows that hold all of them; within a row block the sizes
    are q or q+1; the row blocks partition the rows."""
    pairs = _stacked_pairs(n_st) if stacked else _all_pairs(n_st)
    rows = 3 * n_st if stacked else n_st
    tiles = corr_accum.plan_tiles(pairs, rows, True, max_pairs=max_pairs)
    assert [t[2] for t in tiles] == [0] + [t[3] for t in tiles[:-1]]
    assert tiles[-1][3] == len(pairs)
    blocks = {}
    for r0, r1, lo, hi in tiles:
        assert 1 <= hi - lo <= max_pairs
        assert all(r0 <= i < r1 and r0 <= j < r1 for i, j in pairs[lo:hi])
        blocks.setdefault((r0, r1), []).append(hi - lo)
    edges = sorted(blocks)
    assert edges[0][0] == 0 and edges[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    for sizes in blocks.values():
        assert max(sizes) - min(sizes) <= 1
    assert len(blocks) == (3 if stacked and len(tiles) > 1 else 1)


@pytest.mark.parametrize("n_st,stacked,tiles", [
    (3, False, 1), (8, False, 1), (12, False, 1), (13, False, 2),
    (16, False, 2), (24, False, 6), (3, True, 1), (12, True, 3)])
def test_tile_capacity_on_the_h100(n_st, stacked, tiles):
    """With the H100's opt-in limit, one launch holds every pair of up
    to 12 stations (DC sums on: 12 need 213,712 B of 232,448); 13, 16
    and 24 stations tile; 12 stations stacked ×3 (36 rows, 198 pairs)
    take one launch per 12-row block. Every launch fits the limit."""
    pairs = _stacked_pairs(n_st) if stacked else _all_pairs(n_st)
    rows = 3 * n_st if stacked else n_st
    plan = corr_accum.plan_tiles(pairs, rows, True, H100_SMEM_OPTIN)
    assert len(plan) == tiles
    for r0, r1, lo, hi in plan:
        assert corr_accum.smem_bytes(r1 - r0, hi - lo, True) \
            <= H100_SMEM_OPTIN
    assert corr_accum.smem_bytes(12, 66, True) == 213_712
    assert corr_accum.smem_bytes(13, 78, True) > H100_SMEM_OPTIN


@pytest.mark.parametrize("n_st,rows,K,sums,n_seg", [
    (3, 3, 4, True, 443), (4, 4, 4, True, 443), (5, 5, 4, True, 443),
    (8, 8, 4, True, 443), (12, 12, 4, True, 443), (13, 13, 4, True, 443),
    (16, 16, 4, True, 443), (24, 24, 4, True, 443),
    (3, 9, 1, True, 96), (3, 9, 1, True, 59), (3, 9, 1, True, 39),
    (3, 3, 1, True, 96), (3, 3, 1, True, 59), (3, 3, 1, True, 39),
    (12, 36, 1, True, 96), (16, 48, 1, True, 96), (24, 72, 1, True, 96),
    (12, 36, 1, False, 220), (12, 36, 4, False, 440)])
def test_one_item_a_cta_fits_on_the_h100(n_st, rows, K, sums, n_seg):
    """At the H100's opt-in limit every launch of the tile plan holds one
    item's accumulators a CTA: 3 to 24 stations at K = 4 (13, 16 and 24
    stations in tiles), the overlapped ingest's stacked rows and a tail
    session's 3 rows at K = 1 over a default chunk (96 segments) and
    the last chunks of a 10 s and a 100 s block (59, 39), and the
    sharded step's 12-row blocks (f32, no DC sums). Each row block's
    scratch holds every station's segment slots, each bank as long as
    the longest."""
    pairs = (_stacked_pairs(n_st) if rows == 3 * n_st
             else _all_pairs(n_st))
    plan = corr_accum.plan_tiles(pairs, rows, sums, H100_SMEM_OPTIN)
    for r0, r1, lo, hi in plan:
        assert corr_accum.smem_bytes(r1 - r0, hi - lo, sums) \
            <= H100_SMEM_OPTIN
        slots = slot_plan(n_seg, K)
        assert (slots >= 0).sum() == n_seg
        assert corr_accum.scratch_bytes(r1 - r0, K, n_seg) \
            == (r1 - r0) * slots.size * FFT_LEN * 8


def test_tile_planner_refuses_what_no_launch_holds():
    """Where the per-station accumulators alone exceed the limit (300
    stations), no tile holds a pair: the planner raises."""
    assert corr_accum.max_tile_pairs(300, True, H100_SMEM_OPTIN) == 0
    with pytest.raises(ValueError, match="no launch holds one pair"):
        corr_accum.plan_tiles(_all_pairs(300), 300, True, H100_SMEM_OPTIN)


@pytest.fixture
def h100_gate(monkeypatch):
    """The kernel route's gates as on an H100 with 80 GB free, without a
    card: the opt-in limit, the free memory, and the built library's
    launch search (``choose()`` in csrc/corr_accum.cu, checked against
    the mirror on the card by ``launch_bytes``) stood in by the
    footprint mirror. Records every launch shape the gates ask about."""
    from tdoa_tpu_torch.pipeline import processor as tproc
    from tdoa_tpu_torch.pipeline import streaming as ts

    asked = []

    def launch_shape(rows, m, track, bf16, device):
        asked.append((rows, m))
        fits = corr_accum.smem_bytes(rows, m, track) <= H100_SMEM_OPTIN
        return (0 if fits else 9), {}

    monkeypatch.setattr(corr_accum, "smem_optin", lambda d: H100_SMEM_OPTIN)
    monkeypatch.setattr(corr_accum, "_launch_shape", launch_shape)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (80 << 30,
                                                               80 << 30))
    ts._kernel_fits.cache_clear()
    tproc._BATCH_ROUTES.clear()
    yield asked
    ts._kernel_fits.cache_clear()
    tproc._BATCH_ROUTES.clear()


@pytest.mark.parametrize("n_st,tiles", [(8, 3), (12, 3), (16, 6), (24, 18)])
def test_overlapped_geometry_takes_the_kernel_at_h100_optin(h100_gate, n_st,
                                                            tiles):
    """The overlapped ingest's gate (``ingest._geometry`` on the stacked
    3·n_st rows and 3·m pairs of a 10 s block) picks kernel 1 at 8 to 24
    stations, and asks only about the launches ``accumulate_banks``
    makes: each 12-, 16- or 24-row block's tiles."""
    from tdoa_tpu_torch.pipeline import ingest

    pairs = np.asarray(_stacked_pairs(n_st), np.int32)
    card = torch.device("cuda", 0)
    geo = ingest._geometry(3 * n_st, pairs, 443 * SEG_LEN, 20000, None,
                           "pallas", card)
    assert geo == (SEG_LEN, FFT_LEN, torch.bfloat16)
    plan = corr_accum.plan_tiles(pairs, 3 * n_st, True, H100_SMEM_OPTIN)
    assert len(plan) == tiles
    assert sorted(set(h100_gate)) == sorted(
        {(n_st, hi - lo) for _, _, lo, hi in plan})


@pytest.mark.parametrize("n_st", [3, 12, 13, 16, 24])
def test_batch_route_takes_the_kernel_at_h100_optin(h100_gate, n_st):
    """The batch route's gate (``TDOAProcessor._fused_eligible``, K = 4
    banks of all pairs) picks kernel 1 at 3 to 24 stations on a card
    with the H100's opt-in limit, tiled from 13."""
    from tdoa_tpu_torch.pipeline.processor import (
        ProcessorConfig,
        TDOAProcessor,
    )

    proc = TDOAProcessor(ProcessorConfig(162.4e6, 101.9e6), None,
                         device="cpu")
    proc.device = torch.device("cuda", 0)  # the card's verdict, no card
    assert proc._fused_eligible(n_st, 443 * SEG_LEN)
    m = n_st * (n_st - 1) // 2
    tiles = corr_accum.plan_tiles(_all_pairs(n_st), n_st, True,
                                  H100_SMEM_OPTIN)
    assert (len(tiles) > 1) == (n_st > 12)
    assert set(h100_gate) == {
        (n_st, hi - lo) for _, _, lo, hi in tiles}
    assert sum(hi - lo for *_, lo, hi in tiles) == m


def test_kernel_gate_refuses_what_no_launch_holds(h100_gate):
    """Where no launch holds one pair (100 stations: the per-station
    accumulators alone exceed the limit), the gates give the segmented
    route and never reach the library."""
    from tdoa_tpu_torch.pipeline import ingest

    pairs = np.asarray(_stacked_pairs(100), np.int32)
    geo = ingest._geometry(300, pairs, 443 * SEG_LEN, 20000, None, "pallas",
                           torch.device("cuda", 0))
    assert geo[2] == torch.float32 and geo[:2] != (SEG_LEN, FFT_LEN)
    assert h100_gate == []


@pytest.mark.parametrize("n_st,K,stacked", [
    (3, 4, False), (12, 4, False), (24, 4, False), (12, 1, True),
    (3, 1, False), (3, 1, True)])
def test_kernel_gate_counts_the_streamed_scratch(h100_gate, monkeypatch,
                                                 n_st, K, stacked):
    """``fits_device`` counts the largest launch's scratch, the whole
    block's stage-1 hand-off, at the longest block a capture holds (1480
    segments: 2.3 GB at 3 stations, K = 4; 18.6 GB a tile at 24
    stations; 7.0 GB on the overlapped ingest's 9 stacked rows of 3
    stations and 9.3 GB for a 12-row block of 12 stations' at K = 1),
    beside the bank accumulators and the tiles' outputs. A card with one
    byte less free than that is refused."""
    card = torch.device("cuda", 0)
    rows_all = 3 * n_st if stacked else n_st
    pairs = _stacked_pairs(n_st) if stacked else _all_pairs(n_st)
    tiles = corr_accum.plan_tiles(pairs, rows_all, True, H100_SMEM_OPTIN)
    rows = max(r1 - r0 for r0, r1, _, _ in tiles)
    scratch = corr_accum.scratch_bytes(rows, K, corr_accum.MAX_BLOCK_SEGS)
    assert scratch == rows * K * (-(-1480 // K)) * FFT_LEN * 8
    acc = K * FFT_LEN * (8 * len(pairs) + 12 * rows_all)
    need = scratch + acc + (acc if len(tiles) > 1 else 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (need + 1, 80 << 30))
    assert corr_accum.fits_device(rows_all, pairs, True, K, card)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (need, 80 << 30))
    assert not corr_accum.fits_device(rows_all, pairs, True, K, card)


WINDOW_BLOCK = 66_666_666  # a 100 s capture's block: 1479 kernel segments


def _on_card(**cfg):
    """A processor that asks the card's gates (stood in by ``h100_gate``)
    without a card."""
    from tdoa_tpu_torch.pipeline.processor import (
        ProcessorConfig,
        TDOAProcessor,
    )

    proc = TDOAProcessor(ProcessorConfig(162.4e6, 101.9e6, **cfg), None,
                         device="cpu")
    proc.device = torch.device("cuda", 0)
    return proc


@pytest.mark.parametrize("n_st,n_seg,K,stacked", [
    (3, 443, 4, False), (3, 1479, 4, False), (12, 443, 4, False),
    (12, 1479, 4, False), (24, 443, 4, False), (24, 1479, 4, False),
    (3, 96, 1, False), (3, 59, 1, False), (3, 96, 1, True),
    (3, 59, 1, True), (3, 39, 1, True)])
def test_launch_bytes_count_the_streamed_scratch_at_the_blocks_segments(
        h100_gate, n_st, n_seg, K, stacked):
    """Kernel 1's launch bytes grow with the block exactly as its largest
    launch's scratch, the hand-off of the whole block, does: the batch
    route counts 0.70 GB of scratch at 3 stations × 443 segments, 2.33
    GB at 1479, and 5.6 GB at 24 stations × 443, where the gate once
    counted 1480 segments (18.6 GB) whatever the block; a tail session's
    3 rows and the overlapped ingest's 9 stacked rows at K = 1 count
    their chunk's."""
    card = torch.device("cuda", 0)
    rows_all = 3 * n_st if stacked else n_st
    pairs = _stacked_pairs(n_st) if stacked else _all_pairs(n_st)
    tiles = corr_accum.plan_tiles(pairs, rows_all, True, H100_SMEM_OPTIN)
    rows = max(r1 - r0 for r0, r1, _, _ in tiles)
    grown = (corr_accum.launch_bytes(rows_all, pairs, True, K, card, n_seg)
             - corr_accum.launch_bytes(rows_all, pairs, True, K, card, 1))
    scratch = corr_accum.scratch_bytes(rows, K, n_seg)
    assert grown == scratch - corr_accum.scratch_bytes(rows, K, 1)
    if (n_st, K, stacked) == (3, 4, False):
        assert scratch == (698_351_616 if n_seg == 443 else 2_327_838_720)
    if n_st == 24:
        assert scratch < (6e9 if n_seg == 443 else 19e9)


@pytest.mark.parametrize("n_st,block,lo", [
    (3, WINDOW_BLOCK, False), (12, WINDOW_BLOCK, False),
    (24, WINDOW_BLOCK, False), (24, 443 * SEG_LEN, False),
    (3, WINDOW_BLOCK, True), (3, 443 * SEG_LEN, False),
    (3, 443 * SEG_LEN, True)])
def test_batch_route_with_ample_memory_takes_the_kernel(h100_gate, n_st,
                                                        block, lo):
    """With 80 GB free every network of 3 to 24 stations, at 10 and 100 s,
    with and without LO compensation, takes the kernel route, whose need
    (at 3 stations the whole block's stage-1 scratch among it) is the
    smaller and grows with the block; the verdict records the free
    memory it saw."""
    proc = _on_card(lo_compensation="auto" if lo else "off")
    v = proc.batch_route(n_st, block)
    assert v.route == "pallas" and v.free_bytes == 80 << 30
    assert v.kernel_bytes < v.segmented_bytes
    shorter = proc.route_bytes(n_st, block // 2)
    assert shorter[0] < v.kernel_bytes and shorter[1] < v.segmented_bytes


def _needs(n_st, block, **cfg):
    """The batch route's two needs at 80 GB free, before the decode."""
    from tdoa_tpu_torch.pipeline import processor as tproc

    v = _on_card(**cfg).batch_route(n_st, block)
    tproc._BATCH_ROUTES.clear()
    return v.kernel_bytes, v.segmented_bytes


def test_batch_route_between_the_two_needs_takes_the_kernel(h100_gate,
                                                            monkeypatch):
    """Free memory between the routes' needs (24 stations × 100 s: ~59
    GB for the kernel route, ~126 GB for the segmented one) takes the
    kernel route; the verdict records what it saw."""
    kernel, segmented = _needs(24, WINDOW_BLOCK)
    assert kernel < 65e9 < segmented
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (kernel + 1, 80 << 30))
    proc = _on_card()
    assert proc._fused_eligible(24, WINDOW_BLOCK)
    assert proc.batch_route(24, WINDOW_BLOCK).free_bytes == kernel + 1


@pytest.mark.parametrize("n_st,lo,staged,held_blocks", [
    (24, False, torch.bfloat16, 3.0), (12, True, torch.float32, 4.5)])
def test_batch_route_asked_first_by_process_captures_counts_its_stacks_once(
        h100_gate, monkeypatch, n_st, lo, staged, held_blocks):
    """Where ``process_captures`` asks first (captures handed in on the
    card, as an in-memory caller does), the captures and its stacks are
    allocated already: bf16 captures and stacks (3 planar f32 blocks in
    all, 38.4 GB at 24 stations × 100 s), or with LO compensation the
    captures and the derotated f32 blocks (4.5). The verdict counts them
    as allocated and not again as needed, and takes the kernel route
    that the same card takes when asked before the decode; counting
    them twice, as asked before the decode at the free memory left,
    fits neither route."""
    cfg = {"lo_compensation": "auto" if lo else "off"}
    assert _needs(n_st, WINDOW_BLOCK, **cfg)[0] < 80e9  # before the decode
    free = (80 << 30) - int(held_blocks * 2 * n_st * WINDOW_BLOCK * 4)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (free, 80 << 30))
    with pytest.raises(RuntimeError, match="fit neither batch route"):
        _on_card(**cfg).batch_route(n_st, WINDOW_BLOCK)
    proc = _on_card(**cfg)
    assert proc._fused_eligible(n_st, WINDOW_BLOCK, staged)
    v = proc.batch_route(n_st, WINDOW_BLOCK)  # the kept verdict
    assert v.route == "pallas" and v.free_bytes == free


def test_batch_route_below_both_needs_raises_before_the_decode(
        h100_gate, monkeypatch, tmp_path):
    """Below both needs the verdict raises, naming both and the free
    memory, and ``load_files`` raises before it decodes a file. (The
    gate once sent a memory refusal to the segmented route, which needs
    1.6-2.3x more, to fail later, after the decode.)"""
    from tdoa_tpu_torch.pipeline import processor as tproc

    kernel, segmented = _needs(3, WINDOW_BLOCK)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (kernel, 80 << 30))
    with pytest.raises(RuntimeError, match=r"fit neither batch route.*"
                       f"needs {kernel / 1e9:.2f} GB.*"
                       f"{segmented / 1e9:.2f} GB.*{kernel / 1e9:.2f} GB free"):
        _on_card().batch_route(3, WINDOW_BLOCK)
    decoded = []
    monkeypatch.setattr(tproc, "load_window",
                        lambda *a, **k: decoded.append(a))
    paths = []
    for name in ("kx0u", "n3pay", "kf0mtl"):
        path = tmp_path / f"{name}-1700000000.dat"
        with open(path, "wb") as fh:
            fh.truncate(6 * WINDOW_BLOCK)  # sparse: neither written nor read
        paths.append(str(path))
    proc = tproc.TDOAProcessor.from_csv(162.4e6, 101.9e6, str(
        Path(__file__).resolve().parents[1] / "lat-lon-table.csv"),
        device="cpu")
    proc.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="fit neither batch route"):
        proc.load_files(paths)
    assert decoded == []


@pytest.mark.parametrize("free_gb,route", [(80, "xla"), (1, None)])
def test_batch_route_without_a_launch_takes_the_segmented_route_where_it_fits(
        h100_gate, monkeypatch, free_gb, route):
    """Where no launch of kernel 1 holds one pair, the segmented route
    runs if its own need fits the free memory; else the verdict
    raises."""
    monkeypatch.setattr(corr_accum, "launch_bytes", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (free_gb << 30, 80 << 30))
    proc = _on_card()
    if route is None:
        with pytest.raises(RuntimeError, match="no launch holds one pair"):
            proc.batch_route(3, 443 * SEG_LEN)
    else:
        v = proc.batch_route(3, 443 * SEG_LEN)
        assert v.route == route and v.kernel_bytes is None
        assert not proc._fused_eligible(3, 443 * SEG_LEN)


def _cuda_block(n_st, n_seg, device):
    """bf16 planar noise made on the card (a 10 s block of 24 stations
    would take minutes of numpy FFTs): every station a delayed copy of
    the first plus its own noise and DC; all pairs."""
    g = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(2, n_st, n_seg * SEG_LEN, device=device, generator=g)
    for s in range(1, n_st):
        x[:, s] += 0.5 * torch.roll(x[:, 0], 7 * s - 40, dims=-1)
    return (0.3 * x + 0.01).to(torch.bfloat16).contiguous(), _all_pairs(n_st)


def _cuda_case(n_st, n_seg, stacked, device):
    """The block and pair list of a card test: all pairs of ``n_st``
    stations, or (``stacked``) the overlapped ingest's 3·n_st rows."""
    if not stacked:
        return _cuda_block(n_st, n_seg, device)
    x, _ = _cuda_block(3 * n_st, n_seg, device)
    return x, _stacked_pairs(n_st)


@pytest.mark.cuda
@pytest.mark.parametrize("n_st,n_seg,K,stacked", [
    (3, 16, 4, False), (3, 100, 4, False), (12, 5, 2, False),
    (3, 443, 4, False), (5, 443, 4, False), (16, 443, 4, False),
    (24, 443, 4, False), (12, 96, 1, True), (3, 96, 1, True)])
def test_cuda_kernel_matches_plain(cuda_sm90, n_st, n_seg, K, stacked):
    """The CUDA kernel (one item's accumulators a CTA while the bank's
    segments stream past) against its plain version on the card: 3
    stations, K = 4, sums on, bf16, at 16 segments, at 100 and at a 10 s
    block's 443 segments; 12 stations (66 pairs: 172 KB an item), 5
    stations over a 10 s block, 16 and 24 stations over a 10 s block,
    pair-tiled (2 and 6 launches), and the overlapped ingest's stacked
    rows at K = 1: 36 of 12 stations (3 launches of 12 rows × 66 pairs)
    and 9 of 3 stations (one launch); within 1e-4 of each row's peak
    magnitude (f32 FFTs, different summation orders)."""
    x, pairs = _cuda_case(n_st, n_seg, stacked, cuda_sm90)
    rows = 3 * n_st if stacked else n_st
    cfg = corr_accum.kernel_config(rows, pairs, True)
    assert cfg["tiles"] == ({3: 1, 12: 3}[n_st] if stacked else
                            {3: 1, 5: 1, 12: 1, 16: 2, 24: 6}[n_st])
    before = accumulate_banks.launches
    got = accumulate_banks(x, pairs, K, True)
    assert accumulate_banks.launches == before + cfg["tiles"]
    want = corr_accum.accumulate_banks_plain(x, pairs, K, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        peak = w.abs().amax(dim=-1, keepdim=True)
        assert float(((g - w).abs() / peak).max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n_st,n_seg,K,stacked", [
    (3, 100, 4, False), (12, 5, 2, False), (5, 443, 4, False),
    (16, 443, 4, False), (24, 443, 4, False), (12, 96, 1, True),
    (3, 96, 1, True)])
def test_cuda_kernel_is_deterministic(cuda_sm90, n_st, n_seg, K, stacked):
    """No float atomics: two launches on the same input give bitwise-
    equal outputs, untiled and tiled."""
    x, pairs = _cuda_case(n_st, n_seg, stacked, cuda_sm90)
    a = accumulate_banks(x, pairs, K, True)
    b = accumulate_banks(x, pairs, K, True)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("n_st,stacked,max_pairs", [(12, False, 33),
                                                    (3, True, 3)])
def test_cuda_tiles_are_bitwise_the_single_launch(cuda_sm90, n_st, stacked,
                                                  max_pairs):
    """On the card, 12 stations forced into 2 tiles, and the 9 stacked
    rows of the overlapped ingest forced into their three row blocks,
    give the single launch's outputs bitwise."""
    rows = 3 * n_st if stacked else n_st
    x, _ = _cuda_block(rows, 5, cuda_sm90)
    pairs = _stacked_pairs(n_st) if stacked else _all_pairs(n_st)
    one = accumulate_banks(x, pairs, 1, True)
    before = accumulate_banks.launches
    tiled = accumulate_banks(x, pairs, 1, True, max_pairs=max_pairs)
    torch.cuda.synchronize()
    assert accumulate_banks.launches - before == (3 if stacked else 2)
    for u, v in zip(tiled, one):
        assert torch.equal(u, v)
