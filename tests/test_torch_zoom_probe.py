"""Kernel 2 of the port (LOO HT weighting + deramp + zoom DFT,
``tdoa_tpu_torch/ops/kernels/zoom_probe.py``) against the JAX Pallas
probe kernel (interpret mode on the CPU) on the same banks, carried
across with ``tdoa_tpu_torch.convert``."""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fm_block  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax.numpy as jnp
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.ops.pallas.corr_accum import accumulate_cross_spectra_pallas
    from tdoa_tpu.ops.pallas.zoom_probe import loo_zoom_delays_pallas
    from tdoa_tpu.pipeline import ProcessorConfig as JaxConfig
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch import convert
from tdoa_tpu_torch.ops.corr import _weight_factor, _zoom_corr_delay
from tdoa_tpu_torch.ops.kernels import zoom_probe
from tdoa_tpu_torch.ops.kernels.zoom_probe import (
    HALF_WIDTH,
    loo_zoom_delays,
    loo_zoom_windows,
    zoom_basis,
    zoom_probe_supported,
)


def _probe_case(K=4, n_st=3, F=4096, seed=0):
    """Per-bank cross-spectra of clean pure delays plus a small noise
    floor (tests/test_zoom_probe.py's construction): one unambiguous
    peak per window, so the comparison measures numerics."""
    rng = np.random.default_rng(seed)
    pairs = tuple((i, j) for i in range(n_st) for j in range(i + 1, n_st))
    m = len(pairs)
    delays = rng.uniform(-40, 40, size=m)
    f = np.fft.fftfreq(F)
    s2 = np.exp(-((np.arange(F) % F) / F - 0.5) ** 2 * 40.0)
    s2 = np.fft.fftshift(s2) + 0.01
    cr = np.zeros((K, m, F), np.float32)
    ci = np.zeros((K, m, F), np.float32)
    psd = np.zeros((K, n_st, F), np.float32)
    for k in range(K):
        jitter = rng.normal(scale=0.05, size=m)
        for p, d in enumerate(delays):
            ang = -2.0 * np.pi * f * (d + jitter[p])
            w = s2 * (1.0 + 0.1 * rng.standard_normal(F))
            cr[k, p] = (w * np.cos(ang)).astype(np.float32)
            ci[k, p] = (w * np.sin(ang)).astype(np.float32)
        for s in range(n_st):
            psd[k, s] = (s2 * (1.0 + 0.05 * rng.standard_normal(F))
                         + 0.02).astype(np.float32)
    coarse = np.round(delays).astype(np.float32)
    n_seg_total = 4 * K
    q, r = divmod(n_seg_total, K)
    n_seg_loo = np.repeat(
        n_seg_total - (q + (np.arange(K) < r).astype(np.int64)), m
    ).astype(np.float32)
    return pairs, cr, ci, psd, coarse, n_seg_loo


def _both(pairs, cr, ci, psd, coarse, n_seg_loo, eps=1e-3):
    F = cr.shape[-1]
    ds_j = loo_zoom_delays_pallas(
        C(jnp.asarray(cr), jnp.asarray(ci)), jnp.asarray(psd), pairs,
        jnp.asarray(coarse), jnp.asarray(n_seg_loo), F, eps, interpret=True)
    cross, psd_t, _ = convert.banks_from_planar(
        cr, ci, psd, np.zeros(psd.shape[:2], np.float32))
    ds_t = loo_zoom_delays(cross, psd_t, pairs, torch.from_numpy(coarse),
                           torch.from_numpy(n_seg_loo), eps)
    return np.asarray(ds_j), ds_t.numpy()


@pytest.mark.parametrize("seed,negative", [(0, False), (3, True), (8, True)])
def test_plain_probe_matches_jax(seed, negative):
    """Delays within 2e-3 samples. Negative coarse delays exercise the
    deramp residue of negative products (the probes' true peaks then sit
    >16 lags away and the windows saturate — identically)."""
    pairs, cr, ci, psd, coarse, n_seg_loo = _probe_case(seed=seed)
    if negative:
        coarse = -np.abs(coarse) - 7.0
    ds_j, ds_t = _both(pairs, cr, ci, psd, coarse, n_seg_loo)
    np.testing.assert_allclose(ds_t, ds_j, atol=2e-3)


def test_plain_probe_matches_jax_on_kernel1_banks():
    """The probe on real kernel-1 banks (F = 65536, K = 4): the JAX
    kernel's outputs carried into the port by convert.banks_from_planar,
    delays within 2e-3 samples."""
    pairs = ((0, 1), (0, 2), (1, 2))
    x = fm_block(3, 4 * 45056, [0.0, 21.3, -8.6], seed=7)
    cg, pg, eg = accumulate_cross_spectra_pallas(
        C(jnp.asarray(x[0]), jnp.asarray(x[1])), pairs, precision="bf16",
        remove_dc=True, n_splits=4, interpret=True)
    coarse = np.array([21.0, -9.0, -30.0], np.float32)
    n_seg_loo = np.full(12, 3.0, np.float32)
    ds_j, ds_t = _both(pairs, np.asarray(cg.re), np.asarray(cg.im),
                       np.asarray(pg), coarse, n_seg_loo)
    np.testing.assert_allclose(ds_t, ds_j, atol=2e-3)
    # Parabolic zoom peaks (no phase-slope refine) land near the truth.
    np.testing.assert_allclose(ds_t.mean(0), [21.3, -8.6, -29.9], atol=1.0)


def test_probe_formula_matches_the_plain_zoom_path():
    """The kernel's formula (no per-row max normalization) and the
    _weight_factor + _zoom_corr_delay path it replaces peak at the same
    delays (the normalization is a positive per-row scalar)."""
    pairs, cr, ci, psd, coarse, n_seg_loo = _probe_case(seed=1)
    K, m, F = cr.shape
    n_st = psd.shape[1]
    cross, psd_t, _ = convert.banks_from_planar(cr, ci, psd,
                                                np.zeros((K, n_st)))
    loo_c = (cross.sum(0)[None] - cross).reshape(K * m, F)
    loo_p = (psd_t.sum(0)[None] - psd_t).reshape(K * n_st, F)
    pair_big = np.tile(np.asarray(pairs), (K, 1)) + np.repeat(
        np.arange(K), m)[:, None] * n_st
    s_k = _weight_factor(loo_c, loo_p, pair_big, "ht", 1e-3,
                         torch.from_numpy(n_seg_loo)[:, None])
    ds_plain = _zoom_corr_delay(cross.reshape(K * m, F) * s_k,
                                torch.from_numpy(coarse).repeat(K), F, 128)
    ds_kernel = loo_zoom_delays(cross, psd_t, pairs, torch.from_numpy(coarse),
                                torch.from_numpy(n_seg_loo))
    np.testing.assert_allclose(ds_kernel.reshape(-1).numpy(),
                               ds_plain.numpy(), atol=2e-3)


@pytest.mark.parametrize("F", [128, 4096, 65536])
def test_kernel_basis_matches_the_plain_basis(F):
    """The CUDA kernel's basis rule (lag 1 from the exact angle, the
    other lags by a float32 recurrence; ``zoom_basis``) against the
    plain version's basis exp(i·(k_signed·2π/F)·δ) from float32 angles,
    δ ∈ [−16, 16]: within 1e-5. Against the exact basis (float64) the
    rule is within 3e-6, closer than the plain version's own angles at
    F = 65536, where they reach ~50 rad."""
    k = torch.arange(F)
    k_signed = torch.where(k < F // 2, k, k - F).to(torch.float32)
    step = torch.tensor(2.0 * np.pi / F, dtype=torch.float32)
    delta = torch.arange(-HALF_WIDTH, HALF_WIDTH + 1, dtype=torch.float32)
    ang = (k_signed * step)[:, None] * delta[None, :]
    plain = torch.polar(torch.ones_like(ang), ang)
    got = zoom_basis(F)
    assert got.shape == plain.shape and got.dtype == torch.complex64
    assert float((got - plain).abs().max()) < 1e-5
    k64 = k.to(torch.float64)
    exact = torch.exp(2j * np.pi * torch.where(k64 < F // 2, k64, k64 - F)[:, None]
                      * delta.to(torch.float64)[None, :] / F)
    err = (got.to(torch.complex128) - exact).abs().max()
    assert float(err) < 3e-6
    if F == 65536:
        assert float(err) < float((plain.to(torch.complex128) - exact).abs().max())


def test_support_gate():
    assert zoom_probe_supported(65536, 20000, "ht")
    assert zoom_probe_supported(4096, 512, "ml")
    assert not zoom_probe_supported(65536, 20000, "phat")
    assert not zoom_probe_supported(64, 16, "ht")  # < TILE
    assert not zoom_probe_supported(3 * 4096, 16, "ht")  # not 2^n
    assert not zoom_probe_supported(65536, 40000, "ht")  # int32 guard


def test_convert_carries_banks_and_config():
    re = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    cross, psd, energy = convert.banks_from_planar(
        re, -re, np.ones((1, 2, 3)), np.ones((1, 2)))
    assert cross.dtype == torch.complex64
    np.testing.assert_array_equal(cross.imag.numpy(), -re)
    jcfg = JaxConfig(ref_freq=1.0, tgt_freq=2.0, max_lag=512,
                     prior=(41.2, -96.0, 25000.0))
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    shared = dataclasses.asdict(cfg)
    ref = dataclasses.asdict(jcfg)
    assert shared == ref
    with pytest.raises(ValueError, match="unknown"):
        convert.config_from_fields({**dataclasses.asdict(jcfg), "bogus": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("F", [65536, 4096])
def test_cuda_kernel_matches_plain(cuda_sm90, F):
    """The CUDA probe against its plain version on the card at the slice's
    shape (K = 4, m = 3, F = 65536) and at the segmented path's smallest
    FFT (4096): windows within 1e-4 of each row's peak, delays within
    2e-3 samples."""
    pairs, cr, ci, psd, coarse, n_seg_loo = _probe_case(F=F, seed=2)
    cross, psd_t, _ = convert.banks_from_planar(
        cr, ci, psd, np.zeros(psd.shape[:2]), device=cuda_sm90)
    coarse_t = torch.from_numpy(coarse).to(cuda_sm90)
    nseg_t = torch.from_numpy(n_seg_loo).to(cuda_sm90)
    before = loo_zoom_windows.launches
    got = loo_zoom_windows(cross, psd_t, pairs, coarse_t, nseg_t)
    assert loo_zoom_windows.launches == before + 1
    want = zoom_probe.loo_zoom_windows_plain(cross, psd_t, pairs, coarse_t, nseg_t)
    torch.cuda.synchronize()
    peak = want.abs().amax(dim=-1, keepdim=True)
    assert float(((got - want).abs() / peak).max()) < 1e-4
    ds = loo_zoom_delays(cross, psd_t, pairs, coarse_t, nseg_t)
    ds_cpu = loo_zoom_delays(cross.cpu(), psd_t.cpu(), pairs, coarse_t.cpu(),
                             nseg_t.cpu())
    np.testing.assert_allclose(ds.cpu().numpy(), ds_cpu.numpy(), atol=2e-3)


@pytest.mark.cuda
def test_cuda_kernel_is_deterministic(cuda_sm90):
    """Every cross-warp sum runs in a fixed order: two launches give
    bitwise-equal windows."""
    pairs, cr, ci, psd, coarse, n_seg_loo = _probe_case(F=65536, seed=4)
    cross, psd_t, _ = convert.banks_from_planar(
        cr, ci, psd, np.zeros(psd.shape[:2]), device=cuda_sm90)
    args = (cross, psd_t, pairs, torch.from_numpy(coarse).to(cuda_sm90),
            torch.from_numpy(n_seg_loo).to(cuda_sm90))
    a = loo_zoom_windows(*args)
    b = loo_zoom_windows(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
