"""Multi-station capture simulation with ground truth.

Torch port of ``tdoa_tpu.sim.scene``: capability parity with
simulator.go (ideal 3-station captures) and weak_signal_simulator.go
(impairment model: Gaussian noise, impulses, phase drift, DC offset —
weak_signal_simulator.go:46-53, 89-126), with two physics fixes the
rebuild needs to be self-validating:

- delays are true fractional *sample* shifts of the modulated envelope
  (sim/delay.py), not carrier-phase-only offsets;
- per-station clock offsets and drifts are modeled, so the dual-frequency
  [REF|TGT|REF] clock-cancellation path can be exercised end-to-end.

Every simulated capture ships with a ``SimTruth`` carrying the exact
geometric TDOAs and clock terms, pair-ordered like
``solve.station_pairs``. ``compute_truth`` is numpy and equals the
reference's. ``simulate_scene`` runs on the card unless a device is
given; its noise comes from a ``torch.Generator`` seeded with
``SimScene.seed`` on that device (JAX's streams cannot be reproduced in
torch), drawn in a fixed order: the multipath excess (once per scene,
when a profile has multipath), then per block REF₁, TGT, REF₂ its source
(none for a known TGT program), the block's impairment draws
(``draw_impairments``) and, on TGT, the interferer's source. The
deterministic shaping of those draws (``_receive_block``) follows the
reference step for step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.geo import enu_to_ecef, lla_to_ecef
from tdoa_tpu_torch.io.datfile import save_dat
from tdoa_tpu_torch.sim.delay import apply_channel, apply_channel_moving
from tdoa_tpu_torch.sim.source import fm_phase, fm_source
from tdoa_tpu_torch.solve.multilateration import station_pairs
from tdoa_tpu_torch.utils.constants import DEFAULT_SAMPLE_RATE, SPEED_OF_LIGHT
from tdoa_tpu_torch.utils.platform import default_device


@dataclasses.dataclass(frozen=True)
class NoiseProfile:
    """Receiver-side impairment menu (weak_signal_simulator.go:46-53)."""

    signal_amplitude: float = 0.5  # envelope amplitude at the nearest station
    noise_amplitude: float = 0.005  # AWGN std per I/Q component
    impulse_rate: float = 0.0  # fraction of samples hit by impulses
    impulse_amplitude: float = 0.0  # impulse magnitude (absolute)
    phase_drift_rad_s: float = 0.0  # slow LO phase rotation
    dc_offset: float = 0.0  # additive DC on both I and Q
    # Specular multipath: one delayed, attenuated echo of the direct
    # path per station (excess delay jittered ±20% per station).
    multipath_amplitude: float = 0.0  # echo amplitude relative to direct
    multipath_delay_samples: float = 0.0  # nominal excess delay


IDEAL_PROFILE = NoiseProfile()
# Mirrors the reference's weak-REF profile: ~80% of full-scale is noise,
# 0.1% impulse samples at 5×, 0.05 rad/s drift, small DC
# (weak_signal_simulator.go:180-195).
WEAK_REF_PROFILE = NoiseProfile(
    signal_amplitude=0.2,
    noise_amplitude=0.28,  # 0.8 envelope split across I/Q components
    impulse_rate=0.001,
    impulse_amplitude=1.0,
    phase_drift_rad_s=0.05,
    dc_offset=0.05,
)
STRONG_TGT_PROFILE = NoiseProfile(signal_amplitude=0.6, noise_amplitude=0.02)


@dataclasses.dataclass
class SimScene:
    """A static scene: receivers, two transmitters, clocks, impairments.
    The reference's fields, with their meanings."""

    station_names: Tuple[str, ...]
    station_lla: np.ndarray  # [n, 3]
    ref_tx_lla: np.ndarray  # [3] reference transmitter (known position)
    tgt_tx_lla: np.ndarray  # [3] target transmitter (to be located)
    ref_freq: float = 162_400_000.0
    tgt_freq: float = 101_900_000.0
    sample_rate: float = DEFAULT_SAMPLE_RATE
    block_len: int = 1 << 18  # samples per [REF|TGT|REF] block
    clock_offsets_s: Optional[np.ndarray] = None  # [n] at capture start
    clock_drifts_ppm: Optional[np.ndarray] = None  # [n] fractional rate error
    ref_profile: NoiseProfile = IDEAL_PROFILE
    tgt_profile: NoiseProfile = IDEAL_PROFILE
    # Co-channel interferer on the TARGET frequency: its own waveform and
    # geometry, amplitude relative to the target's at each station.
    interferer_lla: Optional[np.ndarray] = None  # [3]
    interferer_amplitude: float = 0.0
    # Target emitter velocity in the emitter's local ENU frame, m/s
    # (TGT-block Doppler; geometry at the TGT block's midpoint).
    tgt_velocity_enu: Optional[np.ndarray] = None  # [3]
    # Known target audio program (float, at ``sample_rate``): the TGT
    # block transmits its FM envelope instead of an FM-of-noise
    # realization — the audio-pattern-matching validation rung. Shorter
    # audio zero-pads (dead air); longer truncates.
    tgt_audio: Optional[np.ndarray] = None
    tgt_deviation_hz: float = 25_000.0
    # A crystal off by d ppm also offsets the LO by d·1e-6·f_c: applied
    # as a delay rate on every block when on.
    drift_doppler: bool = False
    # [n] linear receive-gain errors on everything a station hears.
    station_gain: Optional[np.ndarray] = None
    # [n] linear response errors on the TGT channel only.
    station_gain_tgt: Optional[np.ndarray] = None
    seed: int = 0


@dataclasses.dataclass
class SimTruth:
    pair_idx: np.ndarray  # [m, 2]
    tgt_tdoa_samples: np.ndarray  # [m] geometric TDOA (what a perfect fix needs)
    ref_tdoa_samples: np.ndarray  # [m] geometric TDOA of the reference tx
    clock_offset_samples: np.ndarray  # [n, 3] effective offset per block
    measured_ref_delay: np.ndarray  # [m, 2] expected REF-block correlation delays
    measured_tgt_delay: np.ndarray  # [m] expected TGT-block correlation delay
    station_delays_samples: np.ndarray  # [n, 2] (ref, tgt) geometric delays
    # [m] expected per-pair differential Doppler of the TGT block
    # (ops/caf.py sign convention); zeros for a static scene.
    tgt_fdoa_hz: Optional[np.ndarray] = None
    # [n] per-station delay rates dτ/dt (dimensionless) of the TGT block
    tgt_delay_rate: Optional[np.ndarray] = None


def _tgt_motion(scene: SimScene):
    """(tgt position at the TGT block midpoint [ecef], v_ecef m/s).

    The TGT block spans [L, 2L); its midpoint is 1.5·L samples into the
    capture. Truth geometry is evaluated there so a moving emitter's
    TDOAs match what the correlator (which averages the block) sees.
    """
    p0 = lla_to_ecef(scene.tgt_tx_lla)
    if scene.tgt_velocity_enu is None:
        return p0, np.zeros(3)
    v = np.asarray(scene.tgt_velocity_enu, np.float64)
    v_ecef = enu_to_ecef(v, scene.tgt_tx_lla) - enu_to_ecef(
        np.zeros(3), scene.tgt_tx_lla
    )
    t_mid = 1.5 * scene.block_len / scene.sample_rate
    return p0 + v_ecef * t_mid, v_ecef


def _geometric_delays_samples(scene: SimScene) -> Tuple[np.ndarray, np.ndarray]:
    st = lla_to_ecef(scene.station_lla)
    d_ref = np.linalg.norm(st - lla_to_ecef(scene.ref_tx_lla), axis=-1)
    p_tgt, _ = _tgt_motion(scene)
    d_tgt = np.linalg.norm(st - p_tgt, axis=-1)
    fs = scene.sample_rate
    return d_ref / SPEED_OF_LIGHT * fs, d_tgt / SPEED_OF_LIGHT * fs


def compute_truth(scene: SimScene) -> SimTruth:
    n = len(scene.station_names)
    tau_ref, tau_tgt = _geometric_delays_samples(scene)
    pairs = station_pairs(n)
    fs = scene.sample_rate
    offs = np.zeros(n) if scene.clock_offsets_s is None else np.asarray(scene.clock_offsets_s)
    drifts = np.zeros(n) if scene.clock_drifts_ppm is None else np.asarray(scene.clock_drifts_ppm)
    # Effective clock offset at each block's midpoint, in samples.
    block_mid_t = (np.arange(3) + 0.5) * scene.block_len / fs
    clock = (offs[:, None] + 1e-6 * drifts[:, None] * block_mid_t[None, :]) * fs  # [n, 3]

    i, j = pairs[:, 0], pairs[:, 1]
    ref_tdoa = tau_ref[j] - tau_ref[i]
    tgt_tdoa = tau_tgt[j] - tau_tgt[i]
    meas_ref = np.stack(
        [
            ref_tdoa + (clock[j, 0] - clock[i, 0]),
            ref_tdoa + (clock[j, 2] - clock[i, 2]),
        ],
        axis=-1,
    )
    meas_tgt = tgt_tdoa + (clock[j, 1] - clock[i, 1])
    # Per-station TGT-block delay rates: emitter motion (range rate/c)
    # PLUS receiver clock drift (a drifting clock IS a delay rate — it
    # shifts the LO and the sampling alike). Pairwise Doppler follows
    # (station j up-shifted positive, ops/caf.py convention).
    p_tgt, v_ecef = _tgt_motion(scene)
    st_ecef = lla_to_ecef(scene.station_lla)
    u = st_ecef - p_tgt[None, :]
    u = u / np.maximum(np.linalg.norm(u, axis=-1, keepdims=True), 1e-9)
    rdot = -u @ v_ecef  # d|station - p|/dt, per station
    delay_rate = rdot / SPEED_OF_LIGHT  # dimensionless
    if scene.drift_doppler:
        delay_rate = delay_rate + 1e-6 * drifts
    fdoa = -scene.tgt_freq * (delay_rate[j] - delay_rate[i])
    return SimTruth(
        pair_idx=pairs,
        tgt_tdoa_samples=tgt_tdoa,
        ref_tdoa_samples=ref_tdoa,
        clock_offset_samples=clock,
        measured_ref_delay=meas_ref,
        measured_tgt_delay=meas_tgt,
        station_delays_samples=np.stack([tau_ref, tau_tgt], axis=-1),
        tgt_fdoa_hz=fdoa,
        tgt_delay_rate=delay_rate,
    )


def draw_impairments(generator: torch.Generator, profile: NoiseProfile,
                     n_st: int, length: int) -> Dict[str, torch.Tensor]:
    """The random terms of one block, on the generator's device, in this
    order: ``noise`` [2, n_st, length] standard normal (I, Q); with
    impulses, ``hits`` [n_st, length] (bool, rate ``impulse_rate``) and
    ``impulse_phase`` (uniform in [0, 2π)); with a phase drift,
    ``phase0`` [n_st, 1] (uniform in [0, 2π))."""
    g, dev = generator, generator.device
    out = {"noise": torch.randn(2, n_st, length, generator=g, device=dev)}
    if profile.impulse_rate > 0:
        out["hits"] = (torch.rand(n_st, length, generator=g, device=dev)
                       < profile.impulse_rate)
        out["impulse_phase"] = (2 * np.pi) * torch.rand(
            n_st, length, generator=g, device=dev)
    if profile.phase_drift_rad_s != 0.0:
        out["phase0"] = (2 * np.pi) * torch.rand(n_st, 1, generator=g,
                                                 device=dev)
    return out


def _receive_block(
    src: torch.Tensor,  # [L] complex64 transmitted envelope
    delays: torch.Tensor,  # [n] samples (geometry + clock), f32
    amps: torch.Tensor,  # [n] f32
    carrier: float,
    profile: NoiseProfile,
    sample_rate: float,
    draws: Dict[str, torch.Tensor],
    multipath_excess: Optional[torch.Tensor] = None,  # [n] samples, scene-static
    delay_rates: Optional[torch.Tensor] = None,  # [n] dτ/dt (moving emitter)
) -> torch.Tensor:
    """One block at every station: channel + impairments. [n, L]."""
    length = int(src.shape[0])

    def chan(d, r, a):
        if delay_rates is not None:
            return apply_channel_moving(src, d, r, carrier, sample_rate, a)
        return apply_channel(src, d, carrier, sample_rate, a)

    rx = chan(delays, delay_rates, amps)
    if profile.multipath_amplitude > 0.0 and multipath_excess is not None:
        # The excess delay is drawn ONCE per scene: a static reflector
        # gives the same echo geometry in every block. A static
        # reflector's echo of a moving emitter carries the direct path's
        # Doppler: same delay rates, extra delay.
        rx = rx + chan(delays + multipath_excess, delay_rates,
                       amps * profile.multipath_amplitude)
    noise = draws["noise"]
    a = profile.noise_amplitude
    rx = rx + torch.complex(a * noise[0], a * noise[1])

    if profile.impulse_rate > 0:
        imp = profile.impulse_amplitude * torch.polar(
            torch.ones_like(draws["impulse_phase"]), draws["impulse_phase"])
        rx = rx + torch.where(draws["hits"], imp, torch.zeros_like(imp))

    if profile.phase_drift_rad_s != 0.0:
        t = torch.arange(length, dtype=torch.float32,
                         device=src.device) / sample_rate
        ang = profile.phase_drift_rad_s * t[None, :] + draws["phase0"]
        rx = rx * torch.polar(torch.ones_like(ang), ang)

    if profile.dc_offset != 0.0:
        rx = rx + complex(profile.dc_offset, profile.dc_offset)

    return rx


def simulate_scene(
    scene: SimScene, device: Optional[torch.device] = None
) -> Tuple[Dict[str, Tuple[torch.Tensor, ...]], SimTruth]:
    """Run the scene on ``device`` (default: the card). Returns
    ({station: (ref1, tgt, ref2)} complex64 [L] tensors, truth).

    Each block is an independent FM-of-noise realization from the proper
    transmitter, received at all stations with geometric + clock delays,
    path-loss amplitudes, and the block's impairment profile.
    """
    dev = default_device() if device is None else torch.device(device)
    truth = compute_truth(scene)
    tau_ref, tau_tgt = truth.station_delays_samples[:, 0], truth.station_delays_samples[:, 1]
    n = len(scene.station_names)
    fs = scene.sample_rate
    L = int(scene.block_len)

    # 1/r path-loss amplitudes from the truth's own delays (d = τ·c/fs):
    # one source of geometry for both timing and amplitude.
    d_ref = np.asarray(tau_ref) * (SPEED_OF_LIGHT / fs)
    d_tgt = np.asarray(tau_tgt) * (SPEED_OF_LIGHT / fs)
    amp_ref = scene.ref_profile.signal_amplitude * (d_ref.min() / d_ref)
    amp_tgt = scene.tgt_profile.signal_amplitude * (d_tgt.min() / d_tgt)
    if scene.station_gain is not None:
        g = np.asarray(scene.station_gain, np.float64)
        amp_ref = amp_ref * g
        amp_tgt = amp_tgt * g
    if scene.station_gain_tgt is not None:
        amp_tgt = amp_tgt * np.asarray(scene.station_gain_tgt, np.float64)

    def f32(v) -> torch.Tensor:
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    gen = torch.Generator(device=dev).manual_seed(int(scene.seed))
    def has_echo(p: NoiseProfile) -> bool:
        return p.multipath_amplitude > 0.0 and p.multipath_delay_samples > 0.0

    # One jitter draw per station for the whole scene: each profile's
    # echo sits at its nominal delay × a factor in [0.8, 1.2).
    jitter = None
    if has_echo(scene.ref_profile) or has_echo(scene.tgt_profile):
        jitter = 0.8 + 0.4 * torch.rand(n, generator=gen, device=dev)

    drifts_ppm = (np.zeros(n) if scene.clock_drifts_ppm is None
                  else np.asarray(scene.clock_drifts_ppm))
    blocks = []
    specs = [
        (scene.ref_freq, tau_ref, amp_ref, scene.ref_profile),
        (scene.tgt_freq, tau_tgt, amp_tgt, scene.tgt_profile),
        (scene.ref_freq, tau_ref, amp_ref, scene.ref_profile),
    ]
    for bi, (carrier, tau, amp, profile) in enumerate(specs):
        if bi == 1 and scene.tgt_audio is not None:
            a = np.zeros(L, np.float32)
            m = min(len(scene.tgt_audio), L)
            a[:m] = np.asarray(scene.tgt_audio[:m], np.float32)
            src = fm_phase(torch.from_numpy(a).to(dev), fs,
                           scene.tgt_deviation_hz)
        else:
            src = fm_source(L, fs, gen)
        delays = f32(tau + np.asarray(truth.clock_offset_samples[:, bi]))
        # Delay rates: clock drift applies to every block; emitter motion
        # additionally to the TGT block. None when all zero so static
        # scenes keep the cheaper static channel.
        rates = 1e-6 * drifts_ppm if scene.drift_doppler else np.zeros(n)
        if bi == 1 and truth.tgt_delay_rate is not None:
            rates = np.asarray(truth.tgt_delay_rate)  # incl. drift if on
        moving = bool(np.abs(rates).max() > 0)
        excess = (profile.multipath_delay_samples * jitter
                  if has_echo(profile) else None)
        draws = draw_impairments(gen, profile, n, L)
        rx = _receive_block(
            src, delays, f32(amp), carrier, profile, fs, draws,
            multipath_excess=excess,
            delay_rates=f32(rates) if moving else None,
        )
        del src, draws
        if (bi == 1 and scene.interferer_lla is not None
                and scene.interferer_amplitude > 0.0):
            # Independent co-channel emitter: own waveform, own geometry,
            # same station clocks; adds clean. Its amplitude is relative
            # to the TARGET's at each station, its timing its own.
            st = lla_to_ecef(scene.station_lla)
            d_int = np.linalg.norm(
                st - lla_to_ecef(np.asarray(scene.interferer_lla)), axis=-1
            )
            tau_int = d_int / SPEED_OF_LIGHT * fs
            amp_int = scene.interferer_amplitude * np.asarray(amp_tgt)
            int_src = fm_source(L, fs, gen)
            rx = rx + apply_channel(
                int_src,
                f32(tau_int + np.asarray(truth.clock_offset_samples[:, bi])),
                carrier, fs, f32(amp_int))
            del int_src
        blocks.append(rx)

    captures = {
        name: (blocks[0][k], blocks[1][k], blocks[2][k])
        for k, name in enumerate(scene.station_names)
    }
    return captures, truth


def write_scene_captures(
    scene: SimScene, out_dir: str, prefix: str = "sim-",
    epoch: int = 1_700_000_000, device: Optional[torch.device] = None,
) -> Tuple[Dict[str, str], SimTruth]:
    """Simulate on ``device`` (default: the card) and write byte-contract
    ``.dat`` files (``{prefix}{station}-{epoch}.dat``, simulator.go:163-178
    convention)."""
    captures, truth = simulate_scene(scene, device=device)
    paths = {}
    for name, (r1, t, r2) in captures.items():
        path = f"{out_dir}/{prefix}{name}-{epoch}.dat"
        save_dat(path, r1, t, r2)
        paths[name] = path
    return paths, truth
