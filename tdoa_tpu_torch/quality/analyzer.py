"""Signal-quality analysis — analyzer.go / fast_analyzer.go capability
(torch port of ``tdoa_tpu.quality.analyzer``).

Per-block metrics computed in one device pass over the raw u8 bytes (the
reference scans byte-by-byte on the host, analyzer.go:141-183): DC
offset, RMS power, I/Q imbalance, clipping (bytes touching 0/255 —
analyzer.go semantics preserved bit-exactly by analyzing *bytes*, not
floats), overload/dead-zone flags, plus the percentile-split spectral SNR
(dsp/snr.py). The recommendation engine and TDOA-suitability verdict
mirror analyzer.go:379-629 / 460-471.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.dsp.snr import spectral_snr
from tdoa_tpu_torch.utils.constants import IQ_CENTER, IQ_SCALE, NUM_BLOCKS
from tdoa_tpu_torch.utils.platform import default_device


@dataclasses.dataclass
class BlockStats:
    """Metrics for one frequency block (REF or TGT)."""

    snr_db: float
    power: float  # mean |x|², full scale ≡ 1
    rms: float
    dc_offset_i: float  # in byte units relative to 127.5
    dc_offset_q: float
    iq_imbalance_db: float  # 10·log10(P_I / P_Q)
    clip_fraction: float  # bytes at 0 or 255
    overload_fraction: float  # |sample| > 0.9 full scale
    dead_fraction: float  # bytes within ±1 of center (127/128)
    min_byte: int
    max_byte: int

    @property
    def is_clipping(self) -> bool:
        return self.clip_fraction > 1e-4  # analyzer.go clipping flag

    @property
    def is_overloaded(self) -> bool:
        return self.overload_fraction > 0.01

    @property
    def is_dead(self) -> bool:
        return self.dead_fraction > 0.99

    @property
    def is_noisy(self) -> bool:
        return self.snr_db < 10.0


def _block_metrics(raw: torch.Tensor, nfft: int = 8192) -> torch.Tensor:
    """One device pass over interleaved u8 I/Q bytes ``raw`` [B, 2n] (one
    row per block) → float32 [B, 11]: SNR, power, RMS, DC I and Q,
    imbalance, clip, overload and dead fractions, min and max byte.

    The bytes are read as u8 pairs ``[B, n, 2]`` (no uint16 arithmetic,
    which CUDA tensors lack). Fractions are int64 counts, each divided
    once, and the byte means behind the DC offsets come from int64 sums:
    exact at any length, where the reference's float32 means of booleans
    and bytes round once a block passes 2^24 elements (a 10 s block is
    2·10^7 samples); below that both are exact and equal."""
    n = int(raw.shape[-1]) // 2
    iq = raw.view(*raw.shape[:-1], n, 2)

    def frac(count: torch.Tensor) -> torch.Tensor:
        return (count.double() / n).float()

    def byte_frac(mask: torch.Tensor) -> torch.Tensor:
        """Fraction over ALL bytes (analyzer.go scans byte-by-byte): the
        mean of the I and Q bytes' fractions, as the reference forms it."""
        c = frac(torch.count_nonzero(mask, dim=-2))
        return 0.5 * (c[..., 0] + c[..., 1])

    dc = (iq.sum(dim=-2, dtype=torch.int64).double() / n
          - IQ_CENTER).float()
    f = (iq.to(torch.float32) - IQ_CENTER) / IQ_SCALE  # [B, n, (I, Q)]
    f2 = f * f
    p = f2.mean(dim=-2)
    p_i, p_q = p[..., 0], p[..., 1]
    power = p_i + p_q
    clip = byte_frac((iq == 0) | (iq == 255))
    overload = frac(torch.count_nonzero(f2.sum(dim=-1) > 0.81, dim=-1))
    dead = byte_frac((iq == 127) | (iq == 128))  # |byte − 127.5| < 1.5
    snr_db, _, _ = spectral_snr(torch.view_as_complex(f), nfft=nfft)
    imbalance = 10.0 * torch.log10(torch.clamp(p_i, min=1e-30)
                                   / torch.clamp(p_q, min=1e-30))
    flat = iq.flatten(-2)
    return torch.stack([
        snr_db, power, torch.sqrt(power), dc[..., 0], dc[..., 1], imbalance,
        clip, overload, dead,
        flat.amin(dim=-1).to(torch.float32),
        flat.amax(dim=-1).to(torch.float32),
    ], dim=-1)


def _analyze_rows(rows: np.ndarray, nfft: int,
                  device: torch.device) -> List[BlockStats]:
    """``_block_metrics`` over equal-length byte rows [B, 2n] on
    ``device``: one host→device copy, one pass, one device→host copy."""
    if not (rows.flags.c_contiguous and rows.flags.writeable):
        rows = rows.copy()
    vals = _block_metrics(torch.from_numpy(rows).to(device),
                          nfft=nfft).cpu().numpy()
    return [
        BlockStats(
            snr_db=float(v[0]), power=float(v[1]), rms=float(v[2]),
            dc_offset_i=float(v[3]), dc_offset_q=float(v[4]),
            iq_imbalance_db=float(v[5]), clip_fraction=float(v[6]),
            overload_fraction=float(v[7]), dead_fraction=float(v[8]),
            min_byte=int(v[9]), max_byte=int(v[10]),
        )
        for v in vals
    ]


def analyze_block_bytes(raw: np.ndarray, nfft: int = 8192,
                        device: Optional[torch.device] = None) -> BlockStats:
    """Analyze one block's raw interleaved u8 bytes on ``device`` (default:
    the card, ``utils.platform.default_device``, an error without one)."""
    dev = default_device() if device is None else torch.device(device)
    return _analyze_rows(np.asarray(raw, np.uint8)[None], nfft, dev)[0]


@dataclasses.dataclass
class SignalAnalysis:
    """Full dual-frequency capture analysis (REF vs TGT separately,
    analyzer.go:84-128)."""

    ref: BlockStats
    tgt: BlockStats
    path: str = ""

    @property
    def suitable(self) -> bool:
        ok, _ = assess_tdoa_suitability(self)
        return ok


def analyze_capture(
    path: str, nfft: int = 8192, max_samples_per_block: int = 1 << 21,
    device: Optional[torch.device] = None,
) -> SignalAnalysis:
    """Analyze a ``.dat`` file on ``device`` (default: the card, an error
    without one): block 1+3 = REF, block 2 = TGT.

    ``max_samples_per_block`` bounds work like the fast analyzer's 32768
    cap (fast_analyzer.go) while defaulting far higher since the device
    pass is cheap. REF and TGT go through one pass when their byte counts
    are equal (always, unless the budget is not a multiple of two IQ
    pairs).
    """
    dev = default_device() if device is None else torch.device(device)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = len(raw) // (2 * NUM_BLOCKS) * 2  # bytes per block
    take = min(n, 2 * max_samples_per_block)
    # REF really is both bracketing blocks (analyzer.go:116-121 semantics):
    # a retune glitch or gain fault confined to the SECOND REF block must
    # show in the verdict, so sample half the budget from each.
    # Even byte count (whole IQ pairs), at least one pair per block so
    # tiny-but-valid captures stay analyzable.
    half = max(take // 2 // 2 * 2, 2 if take >= 2 else 0)
    ref_bytes = np.concatenate([raw[:half], raw[2 * n: 2 * n + half]])
    tgt_bytes = raw[n: n + take]
    if len(ref_bytes) == len(tgt_bytes):
        ref, tgt = _analyze_rows(np.stack([ref_bytes, tgt_bytes]), nfft, dev)
    else:
        ref = _analyze_rows(ref_bytes[None], nfft, dev)[0]
        tgt = _analyze_rows(np.asarray(tgt_bytes)[None], nfft, dev)[0]
    return SignalAnalysis(ref=ref, tgt=tgt, path=path)


def assess_tdoa_suitability(a: SignalAnalysis) -> Tuple[bool, List[str]]:
    """TDOA-suitability verdict (analyzer.go:460-471 + snr_analysis.go
    tiers: ≥15 dB usable, ≥20 dB precise, ≥25 dB sub-sample)."""
    problems: List[str] = []
    for name, blk in (("REF", a.ref), ("TGT", a.tgt)):
        if blk.is_dead:
            problems.append(f"{name}: receiver appears dead (all-center bytes)")
        if blk.is_clipping:
            problems.append(
                f"{name}: ADC clipping ({blk.clip_fraction*100:.2f}% of bytes)"
            )
        if blk.is_overloaded:
            problems.append(f"{name}: overloaded (reduce gain)")
        if blk.snr_db < 15.0:
            problems.append(
                f"{name}: SNR {blk.snr_db:.1f} dB below the 15 dB correlation floor"
            )
    return (not problems), problems


def generate_recommendations(a: SignalAnalysis) -> List[str]:
    """Human-readable gain/hardware/collection advice
    (analyzer.go:379-629 capability)."""
    recs: List[str] = []
    for name, blk in (("REF", a.ref), ("TGT", a.tgt)):
        g = f"[{name}]"
        if blk.is_dead:
            recs.append(f"{g} No signal: check antenna, frequency, and device.")
            continue
        if blk.is_clipping or blk.is_overloaded:
            recs.append(f"{g} Reduce gain: signal is clipping/overloading the ADC.")
        elif blk.snr_db < 15.0:
            recs.append(
                f"{g} Increase gain or improve antenna: SNR {blk.snr_db:.1f} dB "
                f"< 15 dB minimum for correlation."
            )
        elif blk.snr_db < 25.0:
            recs.append(
                f"{g} Usable ({blk.snr_db:.1f} dB); ≥25 dB recommended for "
                f"sub-sample TDOA precision."
            )
        else:
            recs.append(f"{g} Good: SNR {blk.snr_db:.1f} dB.")
        if abs(blk.dc_offset_i) > 5 or abs(blk.dc_offset_q) > 5:
            recs.append(
                f"{g} Large DC offset (I {blk.dc_offset_i:+.1f}, "
                f"Q {blk.dc_offset_q:+.1f} bytes): enable offset tuning or "
                f"check the tuner."
            )
        if abs(blk.iq_imbalance_db) > 3:
            recs.append(
                f"{g} I/Q imbalance {blk.iq_imbalance_db:+.1f} dB: hardware issue."
            )
    return recs


def _issue_count(b: BlockStats) -> int:
    """Quality-issue tally (analyzer.go:450-458 countQualityIssues)."""
    issues = 0
    issues += b.is_clipping
    issues += b.is_overloaded
    issues += b.is_dead
    issues += b.is_noisy
    issues += (max(abs(b.dc_offset_i), abs(b.dc_offset_q)) > 10.0)
    issues += (abs(b.iq_imbalance_db) > 0.9)  # ≈ the 0.1 linear ratio
    return int(issues)


def compare_signals(a: SignalAnalysis) -> List[str]:
    """REF-vs-TGT balance narrative (analyzer.go:398-448
    compareSignals): SNR balance with gain advice, issue-count
    comparison, and the joint EXCELLENT/POOR/MARGINAL verdict."""
    lines: List[str] = []
    r, t = a.ref, a.tgt
    lines.append(f"SNR: reference {r.snr_db:.1f} dB, target {t.snr_db:.1f} dB")
    if r.snr_db > t.snr_db + 10:
        lines.append("reference significantly stronger — consider "
                     "reducing reference gain")
    elif t.snr_db > r.snr_db + 10:
        lines.append("target significantly stronger — consider "
                     "reducing target gain")
    else:
        lines.append("signal levels reasonably balanced")
    ri, ti = _issue_count(r), _issue_count(t)
    lines.append(f"quality issues: reference {ri}, target {ti}")
    if ri == 0 and ti == 0:
        lines.append("both signals appear suitable for TDOA processing")
    elif ri > ti:
        lines.append("reference signal needs more attention")
    elif ti > ri:
        lines.append("target signal needs more attention")
    ok_r = not (r.is_clipping or r.is_overloaded or r.is_dead
                or r.snr_db < 15.0)
    ok_t = not (t.is_clipping or t.is_overloaded or t.is_dead
                or t.snr_db < 15.0)
    if ok_r and ok_t:
        lines.append("verdict: EXCELLENT — both signals suitable for "
                     "TDOA correlation")
    elif not ok_r and not ok_t:
        lines.append("verdict: POOR — both signals need improvement")
    elif not ok_r:
        lines.append("verdict: MARGINAL — reference signal needs "
                     "improvement")
    else:
        lines.append("verdict: MARGINAL — target signal needs "
                     "improvement")
    return lines


def fast_csv_line(a: SignalAnalysis) -> str:
    """Machine-readable calibrator interface (fast_analyzer.go:44-50):
    ``REF,snr,power,clip,ovl`` then ``TGT,...``."""
    lines = []
    for name, blk in (("REF", a.ref), ("TGT", a.tgt)):
        lines.append(
            f"{name},{blk.snr_db:.2f},{blk.power:.6e},"
            f"{blk.clip_fraction:.6f},{blk.overload_fraction:.6f}"
        )
    return "\n".join(lines)
