"""Kernel 3 (``tdoa_tpu_torch/ops/kernels/fm_demod.py``) against the TPU
kernel ``tdoa_tpu.ops.pallas.fm_demod.fm_demod_decimate_pallas`` run in
interpret mode, on the same numpy-seeded IQ.

Tolerance: audio within 2e-4 absolute, the tolerance
``tests/test_pallas_fm.py`` holds the TPU kernel to against its
reference chain. The two differ only in the discriminator's atan2 (the
TPU kernel's polynomial, ~2e-6 rad, against torch's accurate one,
scaled by fs/(2π·25 kHz) ≈ 12.7) and in the FIR's summation order.
"""

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax.numpy as jnp
    from tdoa_tpu.dsp.filters import lowpass_taps as jax_lowpass_taps
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.ops.pallas.fm_demod import fm_demod_decimate_pallas
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.ops.kernels.fm_demod import (
    fm_demod_decimate,
    fm_demod_decimate_plain,
    fm_taps,
    rows_aligned,
)

FS = 2e6
TOL = 2e-4


def _audio(n, seed, bw_hz=5e3):
    """Unit-rms audio band-limited to ``bw_hz`` (numpy seed)."""
    rng = np.random.default_rng(seed)
    spec = np.fft.rfft(rng.standard_normal(n))
    spec[np.fft.rfftfreq(n, 1.0 / FS) > bw_hz] = 0.0
    a = np.fft.irfft(spec, n)
    return a / a.std()


def _fm_iq(n, seed, lo_offset_hz=0.0, noise=0.0):
    """Complex FM of ``_audio`` at 25 kHz deviation, an optional LO
    offset and complex noise; returns (iq complex64, audio)."""
    audio = _audio(n, seed)
    phase = 2 * np.pi * 25e3 / FS * np.cumsum(audio)
    phase += 2 * np.pi * lo_offset_hz * np.arange(n) / FS
    rng = np.random.default_rng(seed + 1000)
    iq = np.exp(1j * phase) + noise * (rng.standard_normal(n)
                                       + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64), audio


def _planar(iq):
    """complex [C, n] or [n] → planar f32 tensor [2, C, n]."""
    iq = np.atleast_2d(iq)
    return torch.from_numpy(np.stack([iq.real, iq.imag]).astype(np.float32))


def _pallas(iq, decim):
    return np.asarray(fm_demod_decimate_pallas(
        C(jnp.asarray(iq.real), jnp.asarray(iq.imag)), FS, decim=decim,
        interpret=True))


@pytest.mark.parametrize(
    "n,decim",
    [(n, d) for d in (4, 8, 16)
     for n in (10_000, 65_535, 32 * 1024 + 7, 1 << 15)]
    # every other decimation the reference accepts, at the ragged length
    + [(32 * 1024 + 7, d) for d in (1, 2, 32, 64, 128)])
def test_plain_matches_pallas_kernel(n, decim):
    iq, _ = _fm_iq(n, seed=n % 97 + decim, noise=0.05)
    want = _pallas(iq, decim)
    got = fm_demod_decimate(_planar(iq), FS, decim=decim)
    assert got.shape == (1, n // decim)
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL)


@pytest.mark.parametrize("decim", [4, 8, 16])
def test_taps_bit_equal_to_reference(decim):
    """The FIR taps — the kernel's only weights — are built from the
    port's own copy of lowpass_taps and equal the reference's bit for
    bit, zero-padded to 128."""
    ref = jax_lowpass_taps(0.45 * FS / decim, FS, 127)
    taps = fm_taps(FS, decim)
    assert taps.dtype == np.float32 and taps.shape == (128,)
    np.testing.assert_array_equal(taps[:127], ref)
    assert taps[127] == 0.0


def test_recovers_audio():
    """The demodulated audio is the modulating audio, block-averaged to
    the output rate, delayed by the causal FIR's 63 input samples."""
    n, decim = 1 << 16, 16
    iq, audio = _fm_iq(n, seed=3)
    got = fm_demod_decimate(_planar(iq), FS, decim=decim)[0].numpy()
    want = audio.reshape(-1, decim).mean(-1)
    # y[j] ≈ audio[j·D + 63]; want[j] is centred on j·D + (D − 1)/2.
    shift = (63.0 - (decim - 1) / 2) / decim
    f = np.fft.rfftfreq(len(want))
    want = np.fft.irfft(np.fft.rfft(want) * np.exp(2j * np.pi * f * shift),
                        len(want))
    assert np.corrcoef(got[50:-50], want[50:-50])[0, 1] > 0.99


def test_lo_offset_becomes_dc():
    """A receiver LO offset is a constant instantaneous-frequency bias:
    DC in the audio, 3 kHz / 25 kHz = 0.12 of full scale."""
    iq0, _ = _fm_iq(1 << 15, seed=4)
    iq1, _ = _fm_iq(1 << 15, seed=4, lo_offset_hz=3e3)
    a0 = fm_demod_decimate(_planar(iq0), FS, decim=16)[0].numpy()
    a1 = fm_demod_decimate(_planar(iq1), FS, decim=16)[0].numpy()
    np.testing.assert_allclose(a1[20:-20] - a1[20:-20].mean(),
                               a0[20:-20] - a0[20:-20].mean(), atol=5e-3)
    assert abs(np.mean(a1[20:-20] - a0[20:-20]) - 0.12) < 1e-3


@pytest.mark.parametrize("decim", [3, 5, 256])
def test_rejects_decim_not_dividing_128(decim):
    x = _planar(_fm_iq(4096, seed=1)[0])
    with pytest.raises(ValueError, match="divide"):
        fm_demod_decimate(x, FS, decim=decim)


def test_channels_are_independent():
    """One call over C channels (a strided channel view, as the
    processor's stacked blocks) equals C single-channel calls."""
    iqs = np.stack([_fm_iq(20_000, seed=s, noise=0.1)[0] for s in range(3)])
    x = _planar(iqs)
    both = fm_demod_decimate(x[:, ::2], FS, decim=8)
    for row, c in enumerate((0, 2)):
        np.testing.assert_array_equal(
            both[row].numpy(),
            fm_demod_decimate(x[:, c:c + 1], FS, decim=8)[0].numpy())


def test_short_input_gives_empty_audio():
    x = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, 1, 7)).astype(np.float32))
    assert fm_demod_decimate(x, FS, decim=8).shape == (1, 0)


def test_rows_aligned_rule():
    """The wrapper's routing rule: the kernel's 16-byte loads only for
    rows that all start on 16-byte boundaries."""
    x = torch.zeros(2, 3, 64)
    assert rows_aligned(x)
    assert rows_aligned(x[:, ::2]) and rows_aligned(x[:, :, 4:])
    assert not rows_aligned(x[:, :, 1:])            # base one float in
    assert not rows_aligned(torch.zeros(2, 3, 63))  # odd channel stride
    one = torch.zeros(2, 1, 64)
    assert rows_aligned(one[:, :, :63])             # one channel: no stride
    assert not rows_aligned(one[:, :, 2:])
    assert not rows_aligned(torch.zeros(2, 1, 63))  # the im plane is off


@pytest.mark.parametrize("decim", [1, 2, 32, 64, 128])
def test_taps_padded_to_128_for_every_decim(decim):
    """The taps the kernel keeps in constant memory, for the decimations
    beyond the FM path's: 127 symmetric lowpass taps of unit DC gain and
    a zero, cached per (sample_rate, decim) so the pointer handed to the
    kernel stays valid."""
    taps = fm_taps(FS, decim)
    assert taps.dtype == np.float32 and taps.shape == (128,)
    assert taps.flags["C_CONTIGUOUS"] and taps[127] == 0.0
    np.testing.assert_array_equal(taps[:127], taps[126::-1])
    assert abs(float(taps.sum()) - 1.0) < 1e-5
    assert fm_taps(float(FS), decim) is taps
    assert fm_taps(FS / 2, decim) is not taps


@pytest.mark.cuda
@pytest.mark.parametrize("decim", [1, 2, 4, 8, 16, 32, 64, 128])
def test_cuda_kernel_matches_plain(cuda_sm90, decim):
    """csrc/fm_demod.cu on the card against the plain version on the
    same inputs (9 channels, ragged length, a strided channel view):
    2e-4, the CPU tolerance; one launch per call."""
    iqs = np.stack([_fm_iq(200_003, seed=s, noise=0.1)[0] for s in range(9)])
    x = _planar(iqs).to(cuda_sm90)
    before = fm_demod_decimate.launches
    got = fm_demod_decimate(x, FS, decim=decim)
    sub = fm_demod_decimate(x[:, 1::3], FS, decim=decim)
    torch.cuda.synchronize()
    assert fm_demod_decimate.launches == before + 2
    want = fm_demod_decimate_plain(x, FS, decim=decim)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL)
    np.testing.assert_allclose(sub.cpu().numpy(), want[1::3].cpu().numpy(),
                               atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("decim", [1, 8, 16, 128])
@pytest.mark.parametrize("rows", ["aligned", "odd_stride", "offset_base"])
def test_cuda_kernel_row_alignment(cuda_sm90, rows, decim):
    """Rows on the 16-byte grid take the kernel's 16-byte loads, rows off
    it (an odd channel stride; a base pointer one float in) its scalar
    loads: both within 2e-4 of the plain version, on a length that is no
    multiple of 4 and spans several tiles."""
    n = 40_002
    iqs = np.stack([_fm_iq(n, seed=20 + s, noise=0.1)[0] for s in range(3)])
    width, start = {"aligned": (n + 2, 0), "odd_stride": (n + 1, 0),
                    "offset_base": (n + 2, 1)}[rows]
    buf = torch.zeros(2, 3, width, device=cuda_sm90)
    view = buf[:, :, start:start + n]
    view.copy_(_planar(iqs))
    assert rows_aligned(view) == (rows == "aligned")
    got = fm_demod_decimate(view, FS, decim=decim)
    want = fm_demod_decimate_plain(view, FS, decim=decim)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 5, 130, 8191, 8193])
def test_cuda_kernel_short_and_ragged_lengths(cuda_sm90, n):
    """n < 4, n no multiple of 4, n around one tile: D = 1 keeps every
    sample an output, so the first (d[0] = 0) and the last are checked."""
    x = torch.from_numpy(np.random.default_rng(40 + n).standard_normal(
        (2, 2, n)).astype(np.float32)).to(cuda_sm90)
    for decim in (1, 2):
        got = fm_demod_decimate(x, FS, decim=decim)
        want = fm_demod_decimate_plain(x, FS, decim=decim)
        assert got.shape == (2, n // decim)
        assert bool(torch.isfinite(want).all())
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=TOL)


@pytest.mark.cuda
def test_cuda_kernel_taps_follow_sample_rate_and_decim(cuda_sm90):
    """The kernel's constant-memory taps are keyed by (sample_rate,
    decim): launches that alternate between pairs, with and without a
    host sync between them, and from two streams in turn, each get their
    own taps."""
    x = _planar(np.stack([_fm_iq(50_000, seed=60 + s, noise=0.1)[0]
                          for s in range(2)])).to(cuda_sm90)
    keys = [(FS, 8), (FS / 2, 8), (FS, 16), (FS, 8), (FS / 2, 16)]
    want = {k: fm_demod_decimate_plain(x, k[0], decim=k[1]).cpu().numpy()
            for k in set(keys)}
    for k in keys * 2:  # the host waits for each result
        got = fm_demod_decimate(x, k[0], decim=k[1])
        np.testing.assert_allclose(got.cpu().numpy(), want[k], atol=TOL)
    outs = [(k, fm_demod_decimate(x, k[0], decim=k[1])) for k in keys * 4]
    main = torch.cuda.current_stream(cuda_sm90)
    side = torch.cuda.Stream(device=cuda_sm90)
    side.wait_stream(main)
    for i, k in enumerate(keys * 4):  # streams in turn, keys out of step
        with torch.cuda.stream(side if i % 2 else main):
            outs.append((k, fm_demod_decimate(x, k[0], decim=k[1])))
    torch.cuda.synchronize()
    for k, got in outs:
        np.testing.assert_allclose(got.cpu().numpy(), want[k], atol=TOL)
