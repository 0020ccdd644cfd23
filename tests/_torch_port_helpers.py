"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: the same
inputs, made from a numpy seed (or by the JAX simulator), go through
``tdoa_tpu`` on the CPU (Pallas kernels in interpret mode) and through
``tdoa_tpu_torch`` (its kernels' plain torch versions on CPU tensors)."""

import re

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


def tables(station_names, station_lla, ref_tx_lla):
    """The same station table in both packages (JAX's, the port's)."""
    from tdoa_tpu.io.stations import Station as JStation
    from tdoa_tpu.io.stations import StationTable as JTable
    from tdoa_tpu_torch.io.stations import Station, StationTable

    rows = list(zip(station_names, station_lla))
    return (
        JTable(stations=[JStation(n, *p) for n, p in rows],
               reference_tx=JStation("162400000", *ref_tx_lla)),
        StationTable(stations=[Station(n, *p) for n, p in rows],
                     reference_tx=Station("162400000", *ref_tx_lla)),
    )


def run_both(sc, cfg, jax_accumulator="auto", port_accumulator="xla"):
    """One simulated scene through both processors on the CPU:
    ``tdoa_tpu`` (``accumulator="auto"`` is its segmented XLA path off
    the TPU) and the port on CPU tensors (``"xla"``, the same path).
    Returns (jax result, port result, truth, captures)."""
    from tdoa_tpu.pipeline.processor import ProcessorConfig as JConfig
    from tdoa_tpu.pipeline.processor import TDOAProcessor as JProcessor
    from tdoa_tpu.sim.scene import simulate_scene
    from tdoa_tpu_torch.pipeline.processor import (
        ProcessorConfig,
        TDOAProcessor,
    )

    caps, truth = simulate_scene(sc)
    jt, tt = tables(sc.station_names, sc.station_lla, sc.ref_tx_lla)
    freqs = dict(ref_freq=sc.ref_freq, tgt_freq=sc.tgt_freq)
    rj = JProcessor(JConfig(**freqs, accumulator=jax_accumulator, **cfg),
                    jt).process_captures(
        {n: caps[n] for n in sc.station_names})
    caps_np = {n: tuple(np.asarray(b) for b in caps[n])
               for n in sc.station_names}
    rt = TDOAProcessor(ProcessorConfig(**freqs, accumulator=port_accumulator,
                                       **cfg),
                       tt, device="cpu").process_captures(caps_np)
    return rj, rt, truth, caps_np


def fix_offset_sigmas(fix, ref_fix):
    """How far ``fix`` lies from ``ref_fix`` in units of the reference
    fix's 1σ ellipse (Mahalanobis distance in its ENU plane)."""
    from tdoa_tpu_torch.geo import lla_to_enu

    d = lla_to_enu(np.array([fix.lat, fix.lon, ref_fix.elev]),
                   np.array([ref_fix.lat, ref_fix.lon, ref_fix.elev]))[:2]
    return float(np.sqrt(d @ np.linalg.solve(np.asarray(ref_fix.cov_en), d)))


def fix_error_m(fix, tx_lla):
    """Horizontal distance of a fix from a transmitter, m."""
    from tdoa_tpu_torch.geo import lla_to_enu

    return float(np.linalg.norm(lla_to_enu(
        np.array([fix.lat, fix.lon, tx_lla[2]]), tx_lla)[:2]))


_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?")


def assert_warnings_match(wt, wj, rtol=1e-3, atol=0.1):
    """Same warnings, word for word; the numbers they quote agree to
    ``rtol`` or ``atol`` (the last printed digit)."""
    assert len(wt) == len(wj), (wt, wj)
    for a, b in zip(wt, wj):
        assert _NUMBER.sub("#", a) == _NUMBER.sub("#", b), (a, b)
        np.testing.assert_allclose(
            [float(v) for v in _NUMBER.findall(a)],
            [float(v) for v in _NUMBER.findall(b)], rtol=rtol, atol=atol)
