"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the same
inputs, made from a numpy seed (or by the JAX simulator), go through
``tdoa_tpu`` on the CPU (Pallas kernels in interpret mode) and through
``tdoa_tpu_torch`` (its kernels' plain torch versions on CPU tensors)."""

import numpy as np
import pytest
import torch

# Tier-1 runs several test workers on few cores; keep torch's pool
# small so the parity tests do not oversubscribe them.
torch.set_num_threads(2)

OMAHA_NAMES = ("kx0u", "n3pay", "kf0mtl")


def scene(omaha, block_len, seed, **kw):
    """A SimScene over the reference deployment geometry."""
    from tdoa_tpu.sim import SimScene

    return SimScene(
        station_names=omaha["names"],
        station_lla=omaha["station_lla"],
        ref_tx_lla=omaha["ref_tx_lla"],
        tgt_tx_lla=omaha["tgt_tx_lla"],
        ref_freq=omaha["ref_freq"],
        tgt_freq=omaha["tgt_freq"],
        block_len=block_len,
        seed=seed,
        **kw,
    )


def fm_block(n_st, n, delays, seed, noise=0.3, dc=(0.0, 0.0)):
    """Planar f32 [2, n_st, n] of one FM-like source delayed per station
    (frequency-domain fractional delays) plus complex noise and DC."""
    rng = np.random.default_rng(seed)
    n_pad = 1 << int(np.ceil(np.log2(n + 256)))
    msg = np.convolve(rng.standard_normal(n_pad), np.ones(64) / 64, "same")
    src = np.exp(1j * 2 * np.pi * 0.05 * np.cumsum(msg))
    spec = np.fft.fft(src)
    f = np.fft.fftfreq(n_pad)
    out = np.empty((2, n_st, n), np.float32)
    for s, d in enumerate(delays):
        z = np.fft.ifft(spec * np.exp(-2j * np.pi * f * d))[:n]
        z = 0.4 * z + noise * (rng.standard_normal(n)
                               + 1j * rng.standard_normal(n)) / np.sqrt(2)
        out[0, s] = z.real + dc[0]
        out[1, s] = z.imag + dc[1]
    return out


def noise_block(n_st, n, delays, seed, noise=0.2, dc=(0.0, 0.0)):
    """Planar f32 [2, n_st, n] of one WIDEBAND source (complex white
    noise at unit power) delayed per station (frequency-domain fractional
    delays) plus independent complex noise and DC: delays resolve to a
    few hundredths of a sample within a few segments."""
    rng = np.random.default_rng(seed)
    n_pad = 1 << int(np.ceil(np.log2(n + 256)))
    src = (rng.standard_normal(n_pad) + 1j * rng.standard_normal(n_pad)) \
        / np.sqrt(2)
    spec = np.fft.fft(src)
    f = np.fft.fftfreq(n_pad)
    out = np.empty((2, n_st, n), np.float32)
    for s, d in enumerate(delays):
        z = np.fft.ifft(spec * np.exp(-2j * np.pi * f * d))[128:128 + n]
        z = 0.4 * z + noise * (rng.standard_normal(n)
                               + 1j * rng.standard_normal(n)) / np.sqrt(2)
        out[0, s] = z.real + dc[0]
        out[1, s] = z.imag + dc[1]
    return out


@pytest.fixture
def cuda_sm90():
    """The card, for the kernel-vs-plain tests; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return dev
