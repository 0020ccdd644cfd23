"""The port's CAF (``tdoa_tpu_torch/ops/caf.py``) and the deramp
helpers of its processor (``_derotate``, ``_deramp_correlate``) against
``tdoa_tpu`` on the same signals.

The ``caf_pairs`` cases are the four of ``tests/test_caf.py``, the
matched-filter weighting and a 3-pair case; each runs once per package
in a module fixture. Tolerances: delay within 2e-3 samples, Doppler
within 1e-2 Hz, surface within 1e-4 of its peak. Both sides transform
the same f32 segments; the slow-time steering is one complex matrix
product here and four real ones there, so sums run in another order.
"""

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fm_block, noise_block  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax
    import jax.numpy as jnp
    from tdoa_tpu.ops import corr as jcorr
    from tdoa_tpu.ops.caf import caf_pairs as jcaf
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.pipeline import processor as jproc
    from tdoa_tpu.sim import fm_source, fractional_delay
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.ops import corr as tcorr
from tdoa_tpu_torch.ops.caf import _ieee_matmul, caf_pairs
from tdoa_tpu_torch.pipeline import processor as tproc

FS = 2e6


def _pair_with(delay, doppler_hz, n=1 << 19, seed=0, noise=0.0):
    """tests/test_caf.py's two-station signal: an FM source, delayed and
    Doppler-shifted at the second station, optional complex noise."""
    a = fm_source(jax.random.PRNGKey(seed), n, FS)
    b = fractional_delay(a, jnp.float32(delay))
    t = jnp.arange(n) / FS
    b = b * jnp.exp(2j * jnp.pi * doppler_hz * t).astype(jnp.complex64)
    if noise:
        k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed + 99), 4)
        a = a + noise * (jax.random.normal(k1, (n,))
                         + 1j * jax.random.normal(k2, (n,)))
        b = b + noise * (jax.random.normal(k3, (n,))
                         + 1j * jax.random.normal(k4, (n,)))
    return np.asarray(jnp.stack([a, b])).astype(np.complex64)


def _three_stations():
    """Three stations of one FM-like source: delays 0 / 21.3 / −7.6
    samples, Dopplers 0 / +6 / −11 Hz, noise."""
    z = fm_block(3, 1 << 18, [0.0, 21.3, -7.6], seed=11, noise=0.2)
    z = (z[0] + 1j * z[1]).astype(np.complex64)
    t = np.arange(z.shape[1]) / FS
    for s, nu in ((1, 6.0), (2, -11.0)):
        z[s] = z[s] * np.exp(2j * np.pi * nu * t).astype(np.complex64)
    return z


# name: (signal, pairs, caf_pairs settings, (delay, doppler) truth and
# bounds of the reference test, or None)
CASES = {
    "delay_and_doppler": (
        lambda: _pair_with(37.5, 9.0), [[0, 1]],
        dict(max_lag=128, seg_len=1 << 14, n_doppler=33),
        (37.5, 0.2, 9.0, 1.0)),
    "zero_doppler": (
        lambda: _pair_with(-21.25, 0.0), [[0, 1]],
        dict(max_lag=128, seg_len=1 << 14, n_doppler=17),
        (-21.25, 0.1, 0.0, 1.0)),
    "noisy_doppler": (
        lambda: _pair_with(50.0, 12.0, noise=1.0, seed=5), [[0, 1]],
        dict(max_lag=128, seg_len=1 << 14, n_doppler=33),
        (50.0, 1.5, 12.0, 2.0)),
    "surface_shape": (
        lambda: _pair_with(10.0, 3.0, n=1 << 17), [[0, 1]],
        dict(max_lag=64, seg_len=1 << 13, n_doppler=9), None),
    "matched_filter": (
        lambda: _pair_with(37.5, 9.0), [[0, 1]],
        dict(max_lag=128, seg_len=1 << 14, n_doppler=33, weighting="none"),
        (37.5, 0.2, 9.0, 1.0)),
    "three_pairs": (
        _three_stations, [[0, 1], [0, 2], [1, 2]],
        dict(max_lag=64, seg_len=1 << 13, n_doppler=65), None),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def caf_run(request):
    make, pairs, kw, truth = CASES[request.param]
    z = make()
    rj = jcaf(C(jnp.asarray(z.real), jnp.asarray(z.imag)),
              jnp.asarray(pairs, jnp.int32), FS, **kw)
    x = torch.from_numpy(np.stack([z.real, z.imag]))
    rt = caf_pairs(x, np.asarray(pairs), FS, **kw)
    return {k: np.asarray(v, np.float64) for k, v in rj._asdict().items()}, \
        {k: v.numpy().astype(np.float64) for k, v in rt._asdict().items()}, \
        truth


def test_caf_delay_matches_jax(caf_run):
    rj, rt, _ = caf_run
    np.testing.assert_allclose(rt["delay"], rj["delay"], atol=2e-3)


def test_caf_doppler_matches_jax(caf_run):
    rj, rt, _ = caf_run
    np.testing.assert_allclose(rt["doppler_hz"], rj["doppler_hz"], atol=1e-2)


def test_caf_surface_and_peak_match_jax(caf_run):
    """The |CAF| map, shape and values (1e-4 of each pair's peak), and
    the interpolated peak height."""
    rj, rt, _ = caf_run
    assert rt["surface"].shape == rj["surface"].shape
    peak = rj["surface"].max(axis=(1, 2), keepdims=True)
    assert np.abs(rt["surface"] - rj["surface"]).max() < 1e-4 * peak.min()
    np.testing.assert_allclose(rt["peak_value"], rj["peak_value"],
                               rtol=1e-4)


def test_caf_recovers_the_planted_delay_and_doppler(caf_run):
    """tests/test_caf.py's own truth bounds, on the port's result."""
    _, rt, truth = caf_run
    if truth is None:
        assert np.all(np.isfinite(rt["surface"]))
        return
    delay, d_tol, nu, nu_tol = truth
    assert abs(rt["delay"][0] - delay) < d_tol
    assert abs(rt["doppler_hz"][0] - nu) < nu_tol


def test_doppler_kills_plain_correlation_caf_survives():
    """The motivating failure on the port: 12 Hz over 0.26 s of coherent
    integration collapses the plain correlation, not the CAF."""
    z = _pair_with(50.0, 12.0, noise=1.0, seed=5)
    x = torch.from_numpy(np.stack([z.real, z.imag]))
    plain = tcorr.correlate_pairs_planar(x, np.array([[0, 1]]), max_lag=128,
                                         seg_len=1 << 14, weighting="phat")
    caf = caf_pairs(x, np.array([[0, 1]]), FS, max_lag=128, seg_len=1 << 14,
                    n_doppler=33)
    assert abs(float(caf.delay[0]) - 50.0) < 1.5
    assert (abs(float(plain.delay[0]) - 50.0) > 1.0
            or float(caf.peak_value[0]) > 3 * float(plain.peak_value[0]))


def test_caf_rejects_unknown_weighting():
    x = torch.zeros(2, 2, 1 << 12)
    with pytest.raises(ValueError, match="phat"):
        caf_pairs(x, np.array([[0, 1]]), FS, max_lag=16, seg_len=1 << 10,
                  weighting="ht")


def test_ieee_matmul_restores_the_tf32_setting():
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with _ieee_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_phase_slope_refine_without_peak_phase_matches_jax():
    """The CAF's refine call: no carrier phase given, the weighted mean
    phasor of the derampled spectrum takes its place."""
    rng = np.random.default_rng(3)
    F, d = 4096, np.array([12.3, -40.7, 0.2])
    f = np.fft.fftfreq(F)
    noise = rng.standard_normal((2, 3, F))
    cross = (np.exp(-2j * np.pi * f[None, :] * d[:, None] + 0.4j)
             + 0.3 * (noise[0] + 1j * noise[1])).astype(np.complex64)
    coarse = np.round(d).astype(np.float32)
    dj, sj, wj = jcorr._phase_slope_refine(
        C(jnp.asarray(cross.real), jnp.asarray(cross.imag)),
        jnp.asarray(coarse), F, 64)
    dt, st, wt = tcorr._phase_slope_refine(torch.from_numpy(cross),
                                           torch.from_numpy(coarse), F, 64)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-3)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-4)


def _rotating_block(n, shifts, seed, dtype=np.float32):
    """Planar [2, 3, n] of three delayed copies of one wideband source,
    each shifted by its station's frequency offset, plus DC."""
    z = noise_block(3, n, [0.0, 17.25, -30.5], seed=seed, noise=0.1,
                    dc=(0.05, -0.03))
    t = np.arange(n) / FS
    c = (z[0] + 1j * z[1]) * np.exp(2j * np.pi * np.asarray(shifts)[:, None]
                                    * t[None, :])
    return np.stack([c.real, c.imag]).astype(dtype)


@pytest.mark.parametrize("lim", [None, 40000], ids=["whole", "lim"])
def test_derotate_matches_jax(lim):
    """Demean, then counter-rotate by each station's shift, f32 angle:
    within 2e-4 of the reference (the angle reaches ~1e3 rad, where an
    f32 ulp is ~1e-4)."""
    shifts = np.array([35.0, -52.5, 8.0])
    x = _rotating_block(1 << 16, shifts, seed=4)
    want = jproc._derotate(C(jnp.asarray(x[0]), jnp.asarray(x[1])), shifts,
                           FS, lim=lim)
    got = tproc._derotate(torch.from_numpy(x), shifts, FS, lim=lim).numpy()
    n = x.shape[-1] if lim is None else lim
    assert got.shape == (2, 3, n)
    np.testing.assert_allclose(got[0], np.asarray(want.re), atol=2e-4)
    np.testing.assert_allclose(got[1], np.asarray(want.im), atol=2e-4)


def test_derotate_takes_bf16_blocks():
    """The fused path's bf16 blocks derotate in f32."""
    x = torch.from_numpy(_rotating_block(1 << 14, [10.0, 0.0, -10.0], 6))
    got = tproc._derotate(x.to(torch.bfloat16), np.zeros(3), FS)
    assert got.dtype == torch.float32
    want = x.to(torch.bfloat16).to(torch.float32)
    want = want - want.mean(-1, keepdim=True)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("weighting", ["ht", "phat"])
def test_deramp_correlate_matches_jax(weighting):
    """Derotate the first ``lim`` samples by the per-station Doppler and
    correlate with the auto-shrunk segment: delays within 2e-3 samples,
    σ within 5 %."""
    shifts = np.array([40.0, -25.0, 12.0])
    x = _rotating_block(1 << 18, shifts, seed=8)
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    lim = 1 << 17
    rj = jproc._deramp_correlate(C(jnp.asarray(x[0]), jnp.asarray(x[1])),
                                 shifts, pairs, lim, 512, 1 << 16, weighting,
                                 FS)
    rt = tproc._deramp_correlate(torch.from_numpy(x), shifts, pairs, lim, 512,
                                 1 << 16, weighting, FS)
    np.testing.assert_allclose(rt.delay.numpy(), np.asarray(rj.delay),
                               atol=2e-3)
    np.testing.assert_allclose(rt.delay.numpy(), [17.25, -30.5, -47.75],
                               atol=0.05)
    np.testing.assert_allclose(rt.delay_std.numpy(), np.asarray(rj.delay_std),
                               rtol=0.05)
    np.testing.assert_allclose(rt.quality.numpy(), np.asarray(rj.quality),
                               rtol=1e-3)


@pytest.mark.cuda
def test_cuda_caf_matches_cpu(cuda_sm90):
    """caf_pairs on the card against the CPU at the processor's CAF
    shape (2^21 samples, seg 6144 in FFTs of 8192, 64 Doppler bins):
    the steering products run in full f32 on the card, TF32 allowed or
    not — delays within 2e-3 samples, Dopplers within 1e-2 Hz, surface
    within 1e-4 of its peak."""
    n = 1 << 21
    z = fm_block(3, n, [0.0, 31.4, -12.9], seed=2, noise=0.3)
    t = np.arange(n) / FS
    # Station 1 up-shifted by 14 Hz.
    c = (z[0, 1] + 1j * z[1, 1]) * np.exp(2j * np.pi * 14.0 * t)
    z[0, 1], z[1, 1] = c.real, c.imag
    x = torch.from_numpy(z)
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    kw = dict(max_lag=2048, seg_len=1 << 13, n_doppler=64)
    want = caf_pairs(x, pairs, FS, **kw)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            got = caf_pairs(x.to(cuda_sm90), pairs, FS, **kw)
            np.testing.assert_allclose(got.delay.cpu().numpy(),
                                       want.delay.numpy(), atol=2e-3)
            np.testing.assert_allclose(got.doppler_hz.cpu().numpy(),
                                       want.doppler_hz.numpy(), atol=1e-2)
            peak = float(want.surface.max())
            assert float((got.surface.cpu() - want.surface).abs().max()) \
                < 1e-4 * peak
            assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert abs(float(want.doppler_hz[0]) - 14.0) < 1.0
