"""The static scene: one capture window of a station network as ``.dat``
files, made on the card from a seed.

A frozen copy of the scene that the port's smoke (``chip_smoke.py``,
``_synthesize``) writes for phases 4, 5 and 12, static case: every
receiver of the configuration hears an FM-like source per block (a
low-passed Gaussian message frequency-modulated at the stated
deviation), delayed by its geometry and its clock offset at the block's
midpoint through an FFT phase ramp, plus white Gaussian noise, quantized
to u8 I/Q as the collector writes it (``[REF | TGT | REF]``, 2 bytes a
sample). Float64 on the card; only the bytes go to the host. The
emitter stands still and the receivers' clocks do not drift: a
configuration that assumes a drift is refused."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import geo
from portbench.scene import receivers, station_lla, write_files

PAD = 4096


def truth_tdoa_samples(cfg: dict) -> Dict[Tuple[str, str], float]:
    """The planted TGT TDOA of each receiver pair (i, j), i < j by name,
    in samples: what a perfect clock-corrected measurement reads."""
    names = receivers(cfg)
    st = geo.lla_to_ecef(np.stack([station_lla(cfg, n) for n in names]))
    tx = geo.lla_to_ecef(station_lla(cfg, cfg["target"]))
    tau = (np.linalg.norm(st - tx, axis=-1) / geo.SPEED_OF_LIGHT
           * cfg["sample_rate"])
    return {(names[i], names[j]): float(tau[j] - tau[i])
            for i in range(len(names)) for j in range(i + 1, len(names))}


def block_delays(cfg: dict) -> Dict[str, np.ndarray]:
    """Each block kind's delay at each receiver (``ref``, ``tgt``; in
    receiver order), samples: its geometry plus the receiver's clock
    offset."""
    fs = float(cfg["sample_rate"])
    names = receivers(cfg)
    st = geo.lla_to_ecef(np.stack([station_lla(cfg, n) for n in names]))

    def delays(tx_name):
        tx = geo.lla_to_ecef(station_lla(cfg, tx_name))
        return np.linalg.norm(st - tx, axis=-1) / geo.SPEED_OF_LIGHT * fs

    offsets = np.asarray([cfg["assumed"]["clock_offsets_s"][n]
                          for n in names]) * fs
    return {"ref": delays(cfg["ref_tx"]) + offsets,
            "tgt": delays(cfg["target"]) + offsets}


def synthesize(cfg: dict, seed: int, device: torch.device,
               delays: Optional[Dict[str, np.ndarray]] = None
               ) -> Dict[str, np.ndarray]:
    """{receiver: the file's bytes, u8 [3 · block · 2]} of one window;
    ``delays`` (default ``block_delays(cfg)``) places each block at each
    receiver."""
    a = cfg["assumed"]
    if float(a.get("receiver_drift_ppm", 0.0)) != 0.0:
        raise ValueError("the static scene plants no clock drift: "
                         f"receiver_drift_ppm is {a['receiver_drift_ppm']!r}")
    fs = float(cfg["sample_rate"])
    block = int(cfg["block_samples"])
    names = receivers(cfg)
    if delays is None:
        delays = block_delays(cfg)
    n_fft = 1 << (block + 2 * PAD).bit_length()
    g = torch.Generator(device=device).manual_seed(int(seed))
    f = torch.fft.fftfreq(n_fft, device=device, dtype=torch.float64)
    bw = float(a["message_bandwidth_hz"]) / fs
    dphi = 2 * np.pi * float(a["deviation_hz"]) / fs

    def source():
        msg = torch.fft.fft(torch.randn(n_fft, device=device, generator=g,
                                        dtype=torch.float64))
        msg[f.abs() > bw] = 0
        msg = torch.fft.ifft(msg).real
        msg = msg / msg.std()
        phase = torch.cumsum(dphi * msg, 0)
        del msg
        return torch.fft.fft(torch.polar(torch.ones_like(phase), phase))

    raw: Dict[str, list] = {n: [] for n in names}
    for kind in ("ref", "tgt", "ref"):
        spec = source()
        for s, name in enumerate(names):
            d = float(delays[kind][s])
            z = torch.fft.ifft(spec * torch.polar(
                torch.ones_like(f), -2 * np.pi * f * d))[PAD:PAD + block]
            noise = torch.randn(2, block, device=device, generator=g,
                                dtype=torch.float64)
            iq = torch.stack([a["signal_amplitude"] * z.real
                              + a["noise_amplitude"] * noise[0],
                              a["signal_amplitude"] * z.imag
                              + a["noise_amplitude"] * noise[1]], dim=-1)
            u8 = torch.clamp(torch.floor(iq * 127.5 + 128.0), 0, 255)
            raw[name].append(u8.to(torch.uint8).reshape(-1).cpu().numpy())
            del z, noise, iq, u8
        del spec
    return {n: np.concatenate(raw.pop(n)) for n in names}


def write_scene(cfg: dict, seed: int, out_dir: str, device: torch.device
                ) -> List[str]:
    """Write one window's files into ``out_dir`` and return their paths
    in receiver order."""
    return write_files(synthesize(cfg, seed, device), out_dir)
