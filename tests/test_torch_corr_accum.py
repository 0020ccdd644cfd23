"""Kernel 1 of the port (segment FFT + cross-spectra + banked
accumulation, ``tdoa_tpu_torch/ops/kernels/corr_accum.py``) against the
JAX fused Pallas kernel it replaces (interpret mode on the CPU), and its
own invariants. On the CPU the wrapper runs the kernel's plain torch
version; the CUDA kernel itself is held to that version on the card."""

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
    SCRATCH_BUF_BYTES,
    SEG_LEN,
    accumulate_banks,
    accumulate_cross_spectra,
    bank_bounds,
    bank_run,
    chunk_plan,
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


@pytest.mark.parametrize("n_seg", [5, 16, 100, 443, 1480])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_chunk_plan_covers_every_segment_once(n_seg, K):
    """The kernel's schedule: chunk c holds, for every bank, its next
    `run` segments in order, −1 only past the bank's end; over the
    chunks every segment of every bank appears exactly once, in the
    bank's order (1480 segments is the 100 s maximum capture). Checked
    at the run the kernel takes (3 stations) and at 1 and 7."""
    b = bank_bounds(n_seg, K)
    for run in sorted({bank_run(3, K, n_seg), 1, 7}):
        plan = chunk_plan(n_seg, K, run)
        assert plan.dtype == np.int32
        assert plan.shape == (-(-max(np.diff(b)) // run), K * run)
        per_bank = plan.reshape(plan.shape[0], K, run)
        for k in range(K):
            flat = per_bank[:, k].reshape(-1)
            n = b[k + 1] - b[k]
            np.testing.assert_array_equal(flat[:n], np.arange(b[k], b[k + 1]))
            assert (flat[n:] == -1).all()
        got = np.sort(plan[plan >= 0])
        np.testing.assert_array_equal(got, np.arange(n_seg))


@pytest.mark.parametrize("n_st,K", [(3, 4), (3, 1), (12, 2)])
def test_bank_run_keeps_a_scratch_buffer_in_its_bound(n_st, K):
    """A chunk's stage-1 spectra (all stations of n_banks·run segments)
    stay within SCRATCH_BUF_BYTES unless one segment a bank already
    exceeds it; the run never passes the longest bank."""
    for n_seg in (K, 443, 1480):
        run = bank_run(n_st, K, n_seg)
        assert 1 <= run <= -(-n_seg // K)
        assert run == 1 or n_st * K * run * FFT_LEN * 8 <= SCRATCH_BUF_BYTES


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


def _cuda_block(n_st, n_seg, device):
    pairs = tuple((i, j) for i in range(n_st) for j in range(i + 1, n_st))
    delays = np.linspace(-40.0, 40.0, n_st)
    x = torch.from_numpy(fm_block(n_st, n_seg * SEG_LEN, delays, seed=5,
                                  dc=(0.01, 0.0))).to(device)
    return x.to(torch.bfloat16).contiguous(), pairs


@pytest.mark.cuda
@pytest.mark.parametrize("n_st,n_seg,K", [(3, 16, 4), (3, 100, 4), (12, 5, 2),
                                          (3, 443, 4)])
def test_cuda_kernel_matches_plain(cuda_sm90, n_st, n_seg, K):
    """The CUDA kernel against its plain version on the card: 3
    stations, K = 4, sums on, bf16, at 16 segments (one chunk), at 100
    and at a 10 s block's 443 segments (chunks of corr_accum.bank_run
    segments a bank, each CTA keeping its items' accumulators on chip
    from chunk to chunk), and a 12-station network (66 pairs: one item
    takes 172 KB, so the reload branch carries the accumulators from
    chunk to chunk through the outputs); within 1e-4 of each row's peak
    magnitude (f32 FFTs, different summation orders)."""
    x, pairs = _cuda_block(n_st, n_seg, cuda_sm90)
    cfg = corr_accum.kernel_config(n_st, len(pairs), True, K)
    assert cfg["resident"] == (n_st == 3)
    before = accumulate_banks.launches
    got = accumulate_banks(x, pairs, K, True)
    assert accumulate_banks.launches == before + 1
    want = corr_accum.accumulate_banks_plain(x, pairs, K, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        peak = w.abs().amax(dim=-1, keepdim=True)
        assert float(((g - w).abs() / peak).max()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n_st,n_seg,K", [(3, 100, 4), (12, 5, 2)])
def test_cuda_kernel_is_deterministic(cuda_sm90, n_st, n_seg, K):
    """No float atomics: two launches on the same input give bitwise-
    equal outputs, in both branches."""
    x, pairs = _cuda_block(n_st, n_seg, cuda_sm90)
    a = accumulate_banks(x, pairs, K, True)
    b = accumulate_banks(x, pairs, K, True)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)
