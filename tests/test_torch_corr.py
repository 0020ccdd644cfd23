"""The port's correlator (``tdoa_tpu_torch/ops/corr.py``) against
``tdoa_tpu.ops.corr``: the fused correlation of one block (8 segments,
K = 4 split banks) and the finish-stage pieces on identical spectra."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_helpers import fm_block
from tdoa_tpu.ops import corr as jcorr
from tdoa_tpu.ops import peaks as jpeaks
from tdoa_tpu.ops.cplx import C
from tdoa_tpu_torch.ops import corr as tcorr
from tdoa_tpu_torch.ops import peaks as tpeaks
from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN

PAIRS = ((0, 1), (0, 2), (1, 2))


@pytest.fixture(scope="module")
def block():
    """3 stations, 8 segments (K = 4), a noisy FM-like source with
    fractional delays and a DC offset."""
    return fm_block(3, 8 * SEG_LEN, [0.0, 33.75, -11.5], seed=11,
                    noise=0.3, dc=(0.01, -0.02))


@pytest.mark.parametrize("precision,probe_kernel", [
    ("f32", False), ("f32", True), ("bf16", True)])
def test_correlate_pairs_fused_matches_jax(block, monkeypatch, precision,
                                           probe_kernel):
    """Delays within 5e-3 samples, σs within 5 % relative. The JAX side
    runs its split-σ probe through the Pallas kernel (interpret mode) or
    its XLA form; bf16 feeds both the same bf16-rounded samples (the TPU
    kernel also rounds its DFT operands to bf16, the port does not)."""
    monkeypatch.setattr(jcorr, "_FORCE_PROBE_KERNEL", probe_kernel)
    jax.clear_caches()  # the probe routing is decided at trace time
    try:
        rj = jcorr.correlate_pairs_fused(
            C(jnp.asarray(block[0]), jnp.asarray(block[1])), PAIRS,
            max_lag=512, weighting="ht", precision=precision,
            remove_dc=True)
    finally:
        jax.clear_caches()
    x = torch.from_numpy(block)
    if precision == "bf16":
        x = x.to(torch.bfloat16)
    rt = tcorr.correlate_pairs_fused(x, PAIRS, max_lag=512, weighting="ht",
                                     remove_dc=True)
    np.testing.assert_allclose(rt.delay.numpy(), np.asarray(rj.delay),
                               atol=5e-3)
    np.testing.assert_allclose(rt.delay.numpy(), [33.75, -11.5, -45.25],
                               atol=0.5)
    np.testing.assert_allclose(rt.delay_std.numpy(),
                               np.asarray(rj.delay_std), rtol=0.05)
    np.testing.assert_allclose(rt.quality.numpy(), np.asarray(rj.quality),
                               rtol=1e-3)


def _spectra(seed, m=3, n_st=3, F=4096):
    rng = np.random.default_rng(seed)
    f = np.fft.fftfreq(F)
    band = np.exp(-(f / 0.08) ** 2)
    delays = rng.uniform(-30, 30, m)
    cross = np.stack([
        band * np.exp(-2j * np.pi * f * d + 1j * rng.uniform(-3, 3))
        + 0.05 * (rng.standard_normal(F) + 1j * rng.standard_normal(F))
        for d in delays]).astype(np.complex64)
    psd = (np.abs(cross[[0, 0, 1]]) * 1.3 + 0.02).astype(np.float32)[:n_st]
    energy = rng.uniform(1, 2, n_st).astype(np.float32)
    return cross, psd, energy, delays


@pytest.mark.parametrize("weighting", ["ht", "ml", "phat", "scot", "none"])
def test_finish_correlation_matches_jax(weighting):
    """Same accumulated spectra through both finish stages (GCC weight,
    iFFT, parabolic peak, phase-slope refine, σ model): delays within
    2e-3 samples, σs and qualities within 1e-3 relative."""
    cross, psd, energy, _ = _spectra(0)
    pair_idx = np.array(PAIRS, np.int32)
    rj = jcorr._finish_correlation(
        C(jnp.asarray(cross.real), jnp.asarray(cross.imag)),
        jnp.asarray(psd), jnp.asarray(energy), jnp.asarray(pair_idx), 128,
        weighting, 1e-3, 4096, "phase", n_seg=6)
    rt = tcorr._finish_correlation(
        torch.from_numpy(cross), torch.from_numpy(psd),
        torch.from_numpy(energy), pair_idx, 128, weighting, 1e-3, 4096,
        "phase", n_seg=6)
    np.testing.assert_allclose(rt.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rt.delay_std.numpy(),
                               np.asarray(rj.delay_std), rtol=1e-3)
    np.testing.assert_allclose(rt.quality.numpy(), np.asarray(rj.quality),
                               rtol=1e-3)
    np.testing.assert_allclose(rt.peak_value.numpy(),
                               np.asarray(rj.peak_value), rtol=1e-3)
    np.testing.assert_allclose(rt.corr_c.real.numpy(), np.asarray(rj.corr_re),
                               atol=1e-4 * float(np.abs(rj.corr).max()))


@pytest.mark.parametrize("seed,offset", [(1, 0.0), (2, -40.0)])
def test_zoom_corr_delay_matches_jax(seed, offset):
    """The plain probe (weighted spectrum → ±16-lag zoom DFT around the
    coarse delay): within 2e-3 samples, negative delays included (an
    offset coarse delay saturates the window identically)."""
    cross, _, _, delays = _spectra(seed)
    coarse = (np.round(delays) + offset).astype(np.float32)
    dj = jcorr._zoom_corr_delay(
        C(jnp.asarray(cross.real), jnp.asarray(cross.imag)),
        jnp.asarray(coarse), 4096, 128)
    dt = tcorr._zoom_corr_delay(torch.from_numpy(cross),
                                torch.from_numpy(coarse), 4096, 128)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-3)


def test_clock_correct_blocks_matches_jax():
    rng = np.random.default_rng(5)
    d, s, q, p = (rng.standard_normal((3, 3)).astype(np.float32)
                  for _ in range(4))
    mag = rng.random((3, 3, 9)).astype(np.float32)
    cplx = (rng.standard_normal((3, 3, 9))
            + 1j * rng.standard_normal((3, 3, 9))).astype(np.complex64)
    geo = rng.standard_normal(3).astype(np.float32)
    for cc in (True, False):
        oj = jcorr.clock_correct_blocks(
            jnp.asarray(d), jnp.asarray(s), jnp.asarray(q), jnp.asarray(p),
            jnp.asarray(mag), jnp.asarray(cplx.real), jnp.asarray(cplx.imag),
            jnp.asarray(geo), cc)
        ot = tcorr.clock_correct_blocks(
            *(torch.from_numpy(a) for a in (d, s, q, p, mag, cplx, geo)), cc)
        for k in range(9):
            np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ot[9].real.numpy(), np.asarray(oj[9][0]))
        np.testing.assert_allclose(ot[9].imag.numpy(), np.asarray(oj[9][1]))


def test_split_helpers_match_jax():
    for n in range(0, 40):
        assert tcorr.split_k(n) == jcorr.split_k(n)
        for K in (2, 4):
            if n >= K:
                assert tcorr._split_bounds(n, K, 7) == jcorr._split_bounds(
                    n, K, 7)
    assert tcorr._SPLIT_STD_SCALE == jcorr._SPLIT_STD_SCALE


def test_peaks_match_jax():
    rng = np.random.default_rng(9)
    y = rng.random((5, 41)).astype(np.float32)
    y[1, 0] = 3.0  # clamped edge
    y[2, 40] = 3.0
    pj, vj = jpeaks.parabolic_peak(jnp.asarray(y))
    pt, vt = tpeaks.parabolic_peak(torch.from_numpy(y))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-6)
    np.testing.assert_allclose(
        tpeaks.peak_quality(torch.from_numpy(y)).numpy(),
        np.asarray(jpeaks.peak_quality(jnp.asarray(y))), rtol=1e-6)
