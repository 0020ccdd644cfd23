"""The port's DSP modules (``tdoa_tpu_torch/dsp/filters.py``, ``fm.py``,
``windows.py``) against ``tdoa_tpu.dsp`` on the same numpy-seeded
signals.

Tolerance: 1e-5 of the signal's peak magnitude. Both sides compute in
float32; the FIRs sum the same products in another order (the port
loops over taps, XLA convolves), the FFTs differ in rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdoa_tpu.dsp import filters as jfilt
from tdoa_tpu.dsp import fm as jfm
from tdoa_tpu.dsp import windows as jwin
from tdoa_tpu.ops.cplx import C
from tdoa_tpu_torch.dsp import filters as tfilt
from tdoa_tpu_torch.dsp import fm as tfm
from tdoa_tpu_torch.dsp import windows as twin

FS = 2e6
REL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * max(np.abs(want).max(), 1e-30))


def _iq(n, seed, noise=0.1):
    """A complex FM-like signal with noise: (complex64 numpy, JAX C,
    planar port tensor [2, n])."""
    rng = np.random.default_rng(seed)
    msg = np.convolve(rng.standard_normal(n), np.ones(16) / 16, "same")
    z = np.exp(1j * np.cumsum(0.4 * msg)) + noise * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    z = z.astype(np.complex64)
    return (z, C(jnp.asarray(z.real), jnp.asarray(z.imag)),
            torch.from_numpy(np.stack([z.real, z.imag])))


def test_windows_and_taps_equal_the_reference():
    for n in (1, 2, 64, 127):
        np.testing.assert_array_equal(twin.hann(n), jwin.hann(n))
        np.testing.assert_array_equal(twin.blackman_harris(n),
                                      jwin.blackman_harris(n))
    np.testing.assert_array_equal(tfilt.lowpass_taps(56250.0, FS, 128),
                                  jfilt.lowpass_taps(56250.0, FS, 128))
    np.testing.assert_array_equal(tfilt.bandpass_taps(1e3, 5e4, FS),
                                  jfilt.bandpass_taps(1e3, 5e4, FS))
    np.testing.assert_array_equal(tfilt.hilbert_taps(255),
                                  jfilt.hilbert_taps(255))


@pytest.mark.parametrize("stride", [1, 8, 16])
@pytest.mark.parametrize("n", [4000, 4001])
def test_fir_filter_same_padding_matches(n, stride):
    """XLA's 'SAME' padding with a stride: ceil(n/s) outputs, the
    padding total split with its smaller half on the left."""
    x = np.random.default_rng(n + stride).standard_normal((2, n)).astype(
        np.float32)
    taps = jfilt.lowpass_taps(0.45 * FS / max(stride, 2), FS, 129)
    want = jfilt.fir_filter(jnp.asarray(x), taps, stride=stride)
    got = tfilt.fir_filter(torch.from_numpy(x), taps, stride=stride)
    assert got.shape[-1] == -(-n // stride)
    _close(got, want)
    # An even tap count pads asymmetrically too.
    want = jfilt.fir_filter(jnp.asarray(x), taps[:128], stride=stride)
    _close(tfilt.fir_filter(torch.from_numpy(x), taps[:128], stride=stride),
           want)


def test_fir_decimate_and_remove_dc_match():
    z, zj, zt = _iq(6000, seed=1)
    want = jfilt.fir_decimate(zj, 8, FS)
    got = tfilt.fir_decimate(zt, 8, FS)
    _close(got[0], want.re)
    _close(got[1], want.im)
    _close(tfilt.remove_dc(zt)[0], jfilt.remove_dc(zj).re)


def test_fm_discriminate_matches():
    z, zj, zt = _iq(5000, seed=2)
    _close(tfm.fm_discriminate(zt, FS), jfm.fm_discriminate(zj, FS))


@pytest.mark.parametrize("decim,dev", [(8, None), (16, 25e3)])
def test_fm_demodulate_matches(decim, dev):
    """The reference's XLA route: 129 SAME taps, DC removed first."""
    z, zj, zt = _iq(8000, seed=3)
    _close(tfm.fm_demodulate(zt, FS, decim=decim, deviation_hz=dev),
           jfm.fm_demodulate(zj, FS, decim=decim, deviation_hz=dev))


def test_fm_modulate_round_trip_matches():
    audio = np.sin(2 * np.pi * 1e3 * np.arange(4000) / FS).astype(np.float32)
    want = jfm.fm_modulate(jnp.asarray(audio), FS)
    got = tfm.fm_modulate(torch.from_numpy(audio), FS)
    _close(got[0], want.re)
    _close(got[1], want.im)


def test_am_demodulate_matches():
    z, zj, zt = _iq(8000, seed=4, noise=0.3)
    _close(tfm.am_demodulate(zt, FS, decim=8), jfm.am_demodulate(zj, FS,
                                                                  decim=8))


@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_ssb_demodulate_matches(sideband):
    z, zj, zt = _iq(16000, seed=5, noise=0.3)
    _close(tfm.ssb_demodulate(zt, FS, sideband=sideband, decim=8),
           jfm.ssb_demodulate(zj, FS, sideband=sideband, decim=8))


def test_ssb_rejects_unknown_sideband():
    with pytest.raises(ValueError, match="sideband"):
        tfm.ssb_demodulate(torch.zeros(2, 64), FS, sideband="dsb")


@pytest.mark.parametrize("n_in,n_out", [
    (1000, 2205), (1001, 2205), (4410, 1000), (4410, 1001), (512, 512)])
def test_resample_fft_matches(n_in, n_out):
    x = np.random.default_rng(n_in + n_out).standard_normal(n_in).astype(
        np.float32)
    _close(tfilt.resample_fft(torch.from_numpy(x), n_out),
           jfilt.resample_fft(jnp.asarray(x), n_out))
