"""Minimal WAV audio I/O for the audio-pattern-matching path.

Copy of ``tdoa_tpu.io.wav`` (numpy and the standard library only).

The reference's audio-pattern-matching plan starts from a recorded audio
file ("Sample rate: 44.1 kHz or 48 kHz … Format: WAV, uncompressed",
docs/audio-pattern-matching.md:31-36). This codec reads exactly that —
uncompressed PCM WAV (8/16/24/32-bit int or 32-bit float) — with the
standard library's ``wave`` container parser plus a numpy decode, and
writes 16-bit PCM for round-trips in tests and simulators.

Multi-channel files are averaged to mono: the FM modulator carries a
single audio program (stereo MPX regeneration is out of scope — the
matched filter needs the program content, not the pilot structure).
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[float, np.ndarray]:
    """Read an uncompressed WAV file.

    Returns ``(sample_rate_hz, audio)`` with ``audio`` a float32 mono
    vector scaled to [-1, 1] full scale.
    """
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        fs = float(w.getframerate())
        n = w.getnframes()
        raw = w.readframes(n)
    if width == 1:
        # 8-bit WAV is unsigned, centered at 128.
        x = np.frombuffer(raw, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        # Sign-extend little-endian 24-bit into int32.
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x = x / float(1 << 23)
    elif width == 4:
        # wave only passes through PCM; 4-byte PCM is int32. (Float32
        # WAV uses format tag 3, which `wave` rejects at open — decoded
        # here only if a permissive parser handed us the frames.)
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported WAV sample width: {width} bytes")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return fs, np.ascontiguousarray(x, np.float32)


def write_wav(path: str, sample_rate: float, audio: np.ndarray) -> None:
    """Write mono float audio ([-1, 1] full scale) as 16-bit PCM WAV."""
    a = np.asarray(audio, np.float32).reshape(-1)
    pcm = np.clip(np.round(a * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(round(sample_rate)))
        w.writeframes(pcm.tobytes())
