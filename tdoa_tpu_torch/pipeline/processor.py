"""The end-to-end TDOA processor: captures → TDOAs → position fix.

Torch port of ``tdoa_tpu.pipeline.processor`` for the IQ and FM modes:

- ``load_files`` decodes each ``.dat`` on the device, into bf16 planar
  blocks when the fused correlator runs and f32 otherwise;
- ``process_blocks`` correlates REF₁, TGT and REF₂ either through
  kernel 1 (segment FFT + banked cross-spectra, ``accumulator="pallas"``)
  or through the segmented correlator over all three blocks at once
  (``accumulator="xla"``, short blocks, long lags, and FM mode, which
  correlates the audio kernel 3 demodulates); both finish with the
  split-σ probe (kernel 2 for HT/ML), then remove each pair's clock
  offset, interpolated between the two REF blocks, with the known REF
  transmitter's geometry;
- ``process_files_overlapped`` and ``tail_session`` keep the captures
  on the host (``HostCapture``) and stream them to the device chunk by
  chunk (``pipeline/ingest.py``) instead of staging whole blocks;
- ``lo_compensation="auto"`` probes the REF₁ block with the CAF
  (``ops/caf.py``), solves per-station LO offsets and derotates all
  three blocks before they correlate; ``solve_velocity`` runs the CAF
  over the TGT block, re-measures the TDOAs by deramp-and-correlate
  when the Doppler is significant, and solves the emitter velocity;
  ``multi_emitter > 1`` separates co-channel emitters, jointly in (lag,
  Doppler) on the CAF surface or by lag alone on the plain window;
- the host gates, the float32 multistart LM solve, the multipath σ
  accounting and the ghost/outlier analysis (with the FDOA evidence of
  a velocity run) follow the reference line for line (numpy / CPU
  tensors).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.dsp.multipath import (
    lobe_centroid_drift as _lobe_centroid_drift,
    lobe_centroid_drift_offset,
)
from tdoa_tpu_torch.geo import lla_to_ecef, lla_to_enu
from tdoa_tpu_torch.io.datfile import (
    _ChunkRing,
    iq_bytes_as_u16,
    load_window,
    u16_to_iq_planar,
)
from tdoa_tpu_torch.io.stations import (
    StationTable,
    load_station_table,
    station_from_filename,
)
from tdoa_tpu_torch.ops.corr import (
    TARGET_SEGS,
    auto_seg_len,
    clock_correct_blocks,
    correlate_pairs,
    correlate_pairs_fused,
    correlate_pairs_planar,
    resolve_seg,
)
from tdoa_tpu_torch.ops.kernels.fm_demod import fm_demod_decimate
from tdoa_tpu_torch.ops.kernels.lm_solve import lm_solve
from tdoa_tpu_torch.solve.ghost import DECISION_THRESHOLD_NATS, GhostVerdict
from tdoa_tpu_torch.solve.multilateration import (
    FixResult,
    rank_candidates_by_power,
    refit_to_candidate,
    solve_fix,
    station_pairs,
)
from tdoa_tpu_torch.utils.constants import (
    DEFAULT_MAX_LAG,
    DEFAULT_SAMPLE_RATE,
    SPEED_OF_LIGHT,
)
from tdoa_tpu_torch.utils.platform import default_device


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    """The reference's configuration, field for field."""

    ref_freq: float
    tgt_freq: float
    sample_rate: float = DEFAULT_SAMPLE_RATE
    max_lag: int = DEFAULT_MAX_LAG
    # Segment length of the segmented correlator (auto_seg_len shrinks
    # it for short captures; FM mode divides it by fm_decim).
    seg_len: Optional[int] = 1 << 16
    weighting: str = "ht"  # Hannan-Thomson ML weighting (ops/corr.py)
    clock_correction: bool = True
    mode: str = "iq"  # "iq" raw correlation | "fm" audio-domain correlation
    fm_decim: int = 8  # audio decimation for mode="fm" (divides 128)
    solve_z: bool = False
    truncate_samples: Optional[int] = None
    # "auto": the fused kernels when the geometry allows (_fused_eligible:
    # 8 kernel segments a block), else the segmented correlator;
    # "pallas"/"xla" force one.
    accumulator: str = "auto"
    # Multi-emitter resolution: >1 separates up to this many co-channel
    # emitters from the per-pair top-K correlation peaks by TDOA
    # cycle-consistency (solve/association.py) and solves each set.
    multi_emitter: int = 1
    emitter_tol_samples: float = 3.0
    # Joint velocity estimation: run the CAF over the TGT block, remove
    # the clock-drift-induced Doppler measured from the dual REF blocks,
    # and least-squares the emitter velocity at the fix (solve/fdoa.py).
    solve_velocity: bool = False
    caf_seg_len: int = 1 << 13  # Doppler span ±1/(2·T_seg) ≈ ±163 Hz
    caf_n_doppler: int = 64
    caf_max_samples: int = 1 << 21  # cap CAF input (memory/time)
    # Receiver LO-offset compensation ("auto" | "off"). A real TCXO off
    # by d ppm shifts its LO by d·1e-6·f_c (~16 Hz at VHF per 0.1 ppm),
    # smearing EVERY block's full-capture correlation — including the
    # REF blocks the clock correction depends on. "auto" probes the
    # REF1 block with the CAF, solves per-station LO offsets, and
    # derotates all three blocks (scaled by each block's carrier)
    # before the main correlation.
    lo_compensation: str = "off"
    power_disambiguation: bool = False
    # FDOA ghost disambiguation (solve_velocity runs only): only near
    # the TRUE intersection do the measured pairwise Dopplers fit one
    # emitter velocity; a candidate whose fitted speed exceeds
    # max_emitter_speed_mps loses to one within it.
    fdoa_disambiguation: bool = True
    # Speed plausibility ceiling for the FDOA ghost ranking ONLY (never
    # gates the velocity solve itself).
    max_emitter_speed_mps: float = 700.0
    ghost_threshold_nats: float = DECISION_THRESHOLD_NATS
    prior: Optional[Tuple[float, float, float]] = None
    multipath_mitigation: bool = True
    outlier_rejection: bool = True


@dataclasses.dataclass
class TDOAResult:
    fix: FixResult
    station_names: List[str]
    pair_idx: np.ndarray  # [m, 2]
    tgt_delay_samples: np.ndarray  # [m] raw TGT correlation delays
    ref_delay_samples: np.ndarray  # [m, 2] raw REF-block delays (blocks 1, 3)
    clock_offset_samples: np.ndarray  # [m] interpolated pair clock offsets
    corrected_tdoa_samples: np.ndarray  # [m] what the solver consumed
    tdoa_seconds: np.ndarray  # [m]
    quality: np.ndarray  # [m] TGT peak-to-sidelobe ratios
    peak_value: np.ndarray  # [m] TGT correlation peaks
    tdoa_std_s: Optional[np.ndarray] = None  # [m] 1σ TDOA errors, seconds
    clock_drift_ppm: Optional[np.ndarray] = None  # [m] from the two REF blocks
    warnings: List[str] = dataclasses.field(default_factory=list)
    # Per-emitter fixes from multi-emitter association (config
    # multi_emitter > 1); strongest emitter first. None when disabled.
    emitters: Optional[List["EmitterFix"]] = None
    # Emitter velocity from the CAF + FDOA solve (config solve_velocity):
    # ENU m/s at the fix, rms Doppler residual, per-pair FDOA (Hz,
    # clock-drift-corrected). None when disabled.
    velocity_enu: Optional[np.ndarray] = None
    velocity_residual_hz: Optional[float] = None
    velocity_sigma_enu: Optional[np.ndarray] = None  # 1σ per axis, m/s
    fdoa_hz: Optional[np.ndarray] = None
    excluded_stations: Optional[List[str]] = None
    solve_weights: Optional[np.ndarray] = None  # [m] weights of the final solve
    multipath_flagged: Optional[np.ndarray] = None  # [m] bool
    multipath_sigma_samples: Optional[np.ndarray] = None  # [m]
    multipath_echo_separation_samples: Optional[np.ndarray] = None  # [m]
    multipath_echo_ratio: Optional[np.ndarray] = None  # [m]
    ghost: Optional[GhostVerdict] = None


@dataclasses.dataclass
class HostCapture:
    """Host-resident capture handle for the overlapped-ingest path
    (pipeline/ingest.py): the station's packed-u16 view of its .dat
    bytes (io.datfile.iq_bytes_as_u16 over a read-only mmap — nothing
    is decoded or transferred until the chunk pipeline streams it) plus
    its per-block sample count."""

    u16: np.ndarray  # [3·block_len] packed I/Q words
    block_len: int

    def subsample_planar(self, block: int, limit: int = 1 << 20,
                         run: int = 1 << 18,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
        """Decode ``limit`` samples of one block (0=REF1, 1=TGT,
        2=REF2) as ``limit // run`` CONTIGUOUS runs evenly spaced
        across the block, to planar f32 ``[2, limit]`` on ``device``
        (default: the card) — for the eager analyses (received-power
        ghost ranking). Contiguous runs, not a bare stride: strided
        decimation has no anti-alias filter, so out-of-band energy
        folds into the Welch PSD `_station_signal_power` computes, and
        per-station strides (block_len is per station) land the common
        emitter band on different bins per station. Runs of 2¹⁸ keep
        every downstream 4096-sample Welch segment inside one
        contiguous span (joints fall on segment boundaries), and every
        station returns exactly ``limit`` samples regardless of its
        block length. Mean |x|² still samples the whole block (the
        runs are spread), so keyed/intermittent emitters average the
        same way the stride did."""
        dev = default_device() if device is None else torch.device(device)
        base = block * self.block_len
        if self.block_len <= limit:
            # a copy: the mmap is read-only, a tensor wants writable memory
            words = np.array(self.u16[base:base + self.block_len])
        else:
            nruns = max(1, limit // run)
            span = self.block_len - run
            words = np.concatenate([
                self.u16[base + (span * k) // max(nruns - 1, 1):
                         base + (span * k) // max(nruns - 1, 1) + run]
                for k in range(nruns)
            ])
        return u16_to_iq_planar(torch.from_numpy(words).to(dev))


def _stack_station_subsamples(subs: List[torch.Tensor]) -> torch.Tensor:
    """Stack per-station subsample_planar outputs ``[2, L_s]`` into one
    planar ``[2, n_st, L]`` block. subsample_planar returns exactly
    ``limit`` samples only for stations whose block exceeds the limit; a
    station below it returns its whole (shorter) block, so a capture set
    straddling the limit is ragged. Trim every station to the shortest —
    truncation keeps the power estimates honest (every retained sample
    is real data, and the Welch estimator drops any final partial
    segment itself)."""
    n = min(int(s.shape[-1]) for s in subs)
    return torch.stack([s[:, :n] for s in subs], dim=1)


@dataclasses.dataclass
class EmitterFix:
    """One resolved co-channel emitter: its associated TDOA set + fix."""

    fix: FixResult
    tdoa_samples: np.ndarray  # [m] clock-corrected, associated per pair
    peak_value: np.ndarray  # [m] correlation peak heights of the set
    max_inconsistency_samples: float  # worst cycle-consistency residual
    # Per-emitter Doppler/velocity (solve_velocity + multi_emitter):
    # the CAF surface is read at THIS emitter's lag per pair, so mixed
    # windows get attributable FDOA. None when unavailable.
    fdoa_hz: Optional[np.ndarray] = None  # [m] drift-corrected
    velocity_enu: Optional[np.ndarray] = None  # [3] m/s
    velocity_sigma_enu: Optional[np.ndarray] = None  # [3] 1σ m/s
    # [m] the per-pair weights this emitter's solve used (quadratic
    # associated-peak weighting) — downstream re-solves (the stream
    # tracker) must use them, mirroring TDOAResult.solve_weights.
    solve_weights: Optional[np.ndarray] = None


def process_blocks(
    ref1: torch.Tensor,  # [2, n_st, L] planar (I, Q)
    tgt: torch.Tensor,
    ref2: torch.Tensor,
    pairs: np.ndarray,  # [m, 2]
    ref_geo_tdoa: torch.Tensor,  # [m] reference-tx geometric TDOA, samples
    max_lag: int = DEFAULT_MAX_LAG,
    seg_len: Optional[int] = None,
    weighting: str = "phat",
    clock_correction: bool = True,
    mode: str = "iq",  # "iq" | "fm"
    fm_decim: int = 8,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    accumulator: str = "xla",  # "xla" | "pallas"
):
    """3 blocks × all pairs → clock-corrected TDOAs. Returns the
    reference's tuple (corrected, tgt_delay, ref_delays [m,2], clock,
    quality [3,m], peak [3,m], corrected_std, tgt_window, tgt_std,
    block windows complex [3,m,W]); delays and σs in IQ samples.

    ``accumulator="pallas"`` in IQ mode correlates each block through the
    fused kernels (``correlate_pairs_fused``: bf16 operand storage,
    in-kernel DC removal). Otherwise the three blocks stack to one f32
    ``[2, 3·n_st, L]`` signal, each channel is demeaned, and one
    ``correlate_pairs_planar`` call correlates every block's pairs.

    ``mode="fm"`` correlates the FM-demodulated audio instead of raw IQ:
    kernel 3 (``ops/kernels/fm_demod.py``) demodulates every channel and
    decimates by ``fm_decim`` — on every device, the reference's TPU
    route (the port's ``dsp.fm.fm_demodulate`` is the reference's XLA
    route and is not called here) — then each channel's audio mean (a
    receiver LO offset) is removed. Audio correlation is plain
    (``weighting="none"``): GCC whitening of the oversampled audio votes
    the peak to lag 0. Delays come back in audio samples and are scaled
    by ``fm_decim`` to IQ samples."""
    if accumulator == "pallas" and mode == "iq":
        pairs_t = tuple(map(tuple, np.asarray(pairs).tolist()))
        outs = [
            correlate_pairs_fused(
                blk.to(torch.bfloat16).contiguous(), pairs_t,
                max_lag=max_lag, weighting=weighting, remove_dc=True,
            )
            for blk in (ref1, tgt, ref2)
        ]
        return clock_correct_blocks(
            torch.stack([o.delay for o in outs]),
            torch.stack([o.delay_std for o in outs]),
            torch.stack([o.quality for o in outs]),
            torch.stack([o.peak_value for o in outs]),
            torch.stack([o.corr for o in outs]),
            torch.stack([o.corr_c for o in outs]),
            ref_geo_tdoa.to(outs[0].delay.device), clock_correction,
        )

    n_st = int(ref1.shape[1])
    p = np.asarray(pairs, np.int64).reshape(-1, 2)
    m = len(p)
    # [2, 3·n_st, L] f32, demeaned in place (a fresh tensor): each block
    # widened straight into its rows, with no stack in the blocks' own
    # dtype beside it (a 100 s window's blocks are GBs).
    x = torch.empty(2, 3 * n_st, int(ref1.shape[-1]), dtype=torch.float32,
                    device=ref1.device)
    for k, blk in enumerate((ref1, tgt, ref2)):
        x[:, k * n_st:(k + 1) * n_st] = blk
    x -= x.mean(-1, keepdim=True)
    # Pair lists for each block, offset into the stacked station axis.
    all_pairs = (p[None] + np.arange(3)[:, None, None] * n_st).reshape(3 * m, 2)
    if mode == "fm":
        audio = fm_demod_decimate(x, sample_rate, decim=fm_decim)
        del x
        # Receiver LO offset = constant discriminator bias; remove per
        # channel (the kernel leaves DC to the caller).
        audio -= audio.mean(-1, keepdim=True)
        x_corr = torch.stack([audio, torch.zeros_like(audio)])
        scale = float(fm_decim)
        max_lag_c = max(max_lag // fm_decim + 2, 16)
        seg_c = (None if seg_len is None
                 else max(seg_len // fm_decim, 4 * max_lag_c))
        weighting = "none"
    elif mode == "iq":
        x_corr = x
        scale = 1.0
        max_lag_c = max_lag
        # Short captures: shrink the segment so the Welch average still
        # holds ≥8 segments; long captures keep the configured segment.
        seg_c = auto_seg_len(int(x.shape[-1]), max_lag, seg_len)
    else:
        raise ValueError(f"unknown processing mode: {mode!r}")
    res = correlate_pairs_planar(x_corr, all_pairs, max_lag=max_lag_c,
                                 seg_len=seg_c, weighting=weighting)
    return clock_correct_blocks(
        res.delay.reshape(3, m) * scale,
        res.delay_std.reshape(3, m) * scale,
        res.quality.reshape(3, m),
        res.peak_value.reshape(3, m),
        res.corr.reshape(3, m, -1),
        res.corr_c.reshape(3, m, -1),
        ref_geo_tdoa.to(res.delay.device), clock_correction,
    )


def _horiz_m(a_lat, a_lon, b_lat, b_lon, elev) -> float:
    """Horizontal ENU separation in meters between two lat/lon points."""
    return float(np.linalg.norm(lla_to_enu(
        np.array([a_lat, a_lon, elev]), np.array([b_lat, b_lon, elev])
    )[:2]))


def _station_mean_power(x: torch.Tensor) -> np.ndarray:
    """Per-station mean |x|² of planar ``x`` [2, n_st, L] from a strided
    subsample (≤1M samples per station)."""
    n = int(x.shape[-1])
    step = max(1, n // (1 << 20))
    re = x[0, :, ::step].to(torch.float32)
    im = x[1, :, ::step].to(torch.float32)
    return (re * re + im * im).mean(-1).cpu().numpy().astype(np.float64)


def _station_signal_power(x: torch.Tensor, chunk: int = 1 << 18) -> np.ndarray:
    """Per-station SIGNAL power of planar ``x`` [2, n_st, L]: Welch PSD
    over a central chunk, median noise floor, and the UNCLIPPED
    floor-subtracted sum over the common signal band (bins where some
    station clears its floor by 5 estimator σ) — the 1/r ghost
    ranking's amplitude profile, floored at each estimate's own 1σ and
    falling back to mean power when no band is detectable."""
    n = int(x.shape[-1])
    seg = 4096
    take = min(n, chunk)
    off = (n - take) // 2
    nseg = max(1, take // seg)
    sl = x[:, :, off:off + nseg * seg].to(torch.float32).cpu().numpy()
    re = sl[0].astype(np.float64)
    im = sl[1].astype(np.float64)
    z = (re + 1j * im).reshape(re.shape[0], nseg, seg)
    psd = np.mean(np.abs(np.fft.fft(z, axis=-1)) ** 2, axis=1) / seg
    floor = np.median(psd, axis=-1, keepdims=True)  # [n_st, 1]
    zscore = (psd - floor) / np.maximum(floor / np.sqrt(nseg), 1e-30)
    band = (zscore > 5.0).any(axis=0)
    if not band.any():
        return _station_mean_power(x)
    nb = int(np.count_nonzero(band))
    sig = np.sum(psd[:, band] - floor, axis=-1) / seg
    lim = floor[:, 0] * np.sqrt(nb / nseg) / seg
    return np.maximum(sig, lim)


def _derotate(block: torch.Tensor, shifts_hz: np.ndarray,
              sample_rate: float, lim: Optional[int] = None) -> torch.Tensor:
    """Counter-rotate each station's planar block [2, n_st, L] by its
    frequency shift [n_st] (Hz): f32 [2, n_st, lim].

    DC is removed BEFORE the rotation: rotated DC becomes a coherent
    in-band tone that later mean-subtraction cannot remove, and PHAT
    whitening then elevates it into a delay-peak bias. The angle is
    float32, as the reference computes it."""
    n = int(block.shape[-1]) if lim is None else lim
    dev = block.device
    t = torch.arange(n, dtype=torch.float32, device=dev) / sample_rate
    s = torch.as_tensor(np.asarray(shifts_hz, np.float32), device=dev)
    ang = (-2.0 * np.pi) * s[:, None] * t[None, :]  # [n_st, n]
    del t
    cr_, sr_ = torch.cos(ang), torch.sin(ang)
    del ang
    br = block[0, :, :n].to(torch.float32)
    bi = block[1, :, :n].to(torch.float32)
    br = br - br.mean(-1, keepdim=True)
    bi = bi - bi.mean(-1, keepdim=True)
    return torch.stack([br * cr_ - bi * sr_, br * sr_ + bi * cr_])


def _deramp_correlate(
    tgt: torch.Tensor,  # planar [2, n_st, L]
    s_dop: np.ndarray,  # [n_st] per-station frequency shifts, Hz
    pairs: np.ndarray,
    lim: int,
    max_lag: int,
    seg_len,
    weighting: str,
    sample_rate: float,
):
    """Counter-rotate the TGT block (see _derotate) and re-run the
    plain correlator over the first ``lim`` samples — truncated because
    a mover's envelope delay drifts: over a long capture the full-block
    peak smears/walks while a ~1 s window keeps the drift below half a
    sample at aircraft speeds."""
    yd = _derotate(tgt, s_dop, sample_rate, lim=lim)
    # Same segment auto-shrink as the primary path (process_blocks
    # mode="iq"): its σ feeds the adoption gate against the primary's
    # K=4 split σ, and a short window without the shrink would land on
    # S≤2 segments, an estimator the gate cannot compare.
    return correlate_pairs_planar(
        yd, pairs, max_lag=max_lag,
        seg_len=auto_seg_len(lim, max_lag, seg_len),
        weighting=weighting,
    )


# Memory the batch path holds beyond the counted tensors: the
# allocator's rounding and the host analyses' device temporaries (the
# kernel route peaked up to 0.4 GB above the count at 100 s on the H100).
ROUTE_SLACK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class BatchRoute:
    """The batch path's route for one station count and block length on
    one card: ``"pallas"`` (kernel 1) or ``"xla"`` (the segmented
    correlator), each route's reckoned device bytes from where the
    verdict was asked (``batch_route_bytes``; ``kernel_bytes`` None
    where no launch of kernel 1 holds one pair) and the free bytes it
    saw."""

    route: str
    kernel_bytes: Optional[int]
    segmented_bytes: int
    free_bytes: int


def batch_route_bytes(n_stations: int, block_len: int, lo_compensation: bool,
                      seg_fft_len: int, launch: Optional[int],
                      staged: Optional[torch.dtype] = None):
    """(kernel route, segmented route) device bytes that
    ``process_captures`` still allocates for three blocks of
    ``block_len`` samples of ``n_stations``, in units of one planar f32
    block. ``staged`` None: asked before the decode, so the captures as
    ``load_files`` decodes them and process_captures' stacks of them
    count (bf16, 1.5 + 1.5, for the kernel route; f32, 3 + 3, for the
    segmented one), with LO compensation 5 more (the derotated f32
    blocks in place of the stacks and one block's derotation
    temporaries). Else the dtype of the stacks process_captures holds,
    derotated where LO compensation ran: the captures and stacks are
    allocated already, and the kernel route adds only a block's bf16
    operand copy where the stacks are wider. Then kernel 1's ``launch``
    bytes (``corr_accum.launch_bytes``; None: no launch holds one pair),
    or process_blocks' f32 stack (3), the segmented correlator's chunk
    buffers and five copies of its K = 4 banks of the 3·m stacked pairs
    at ``seg_fft_len``; ``ROUTE_SLACK_BYTES`` on each."""
    from tdoa_tpu_torch.ops.corr import SEG_CHUNK_BYTES

    blk = 2 * n_stations * block_len * 4
    if staged is None:
        lo = 5 * blk if lo_compensation else 0
        k_blocks, s_blocks = 3 * blk + lo, 6 * blk + lo
    else:
        k_blocks, s_blocks = (0 if staged == torch.bfloat16 else blk // 2), 0
    kernel = (None if launch is None
              else k_blocks + launch + ROUTE_SLACK_BYTES)
    m = n_stations * (n_stations - 1) // 2
    banks = 4 * 3 * m * seg_fft_len * 8
    segmented = (s_blocks + 3 * blk + 3 * SEG_CHUNK_BYTES + 5 * banks
                 + ROUTE_SLACK_BYTES)
    return kernel, segmented


# The batch route's verdicts, one per (stations, block length, LO
# compensation, segmented FFT length, card): TDOAProcessor.batch_route.
_BATCH_ROUTES: Dict[tuple, BatchRoute] = {}


def _planar(b, device) -> torch.Tensor:
    """A capture block as a planar [2, L] tensor on ``device``: complex
    numpy/torch blocks convert to float32, planar tensors pass through."""
    if isinstance(b, torch.Tensor) and not b.is_complex():
        return b.to(device)
    z = b if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.require(np.asarray(b), requirements="W"))  # copy if read-only
    z = z.to(device=device, dtype=torch.complex64)
    return torch.stack([z.real, z.imag])


class TDOAProcessor:
    """High-level orchestrator with the reference CLI contract
    (``processor ref_freq target_freq csv dat1 dat2 dat3...``)."""

    def __init__(self, config: ProcessorConfig, stations: StationTable,
                 device: Optional[torch.device] = None):
        """``device`` defaults to the card (``default_device``, which
        raises when none is visible); pass ``"cpu"`` for the kernels'
        plain versions on the CPU."""
        self.config = config
        self.stations = stations
        self.device = torch.device(device) if device is not None \
            else default_device()
        # What this window's ingest did, cleared as each ``load_files``
        # and ``process_files_overlapped`` starts: the batch ingest's
        # ``read_s`` (the time a file read was in progress),
        # ``read_busy_s`` (the reads' times summed over the ring's
        # readers), ``readers`` (the threads that read a chunk),
        # ``h2d_s`` (the host's waits for the copies through the ring,
        # the last ones included), ``h2d_bytes``, ``staged_chunks`` (the
        # chunks through the ring, 0 on the CPU) and ``pinned_allocs``
        # (the ring's pinned buffers made this window: all of them on
        # the first window on a card, 0 after) (``load_window``'s
        # ``diag``); the overlapped ingest's chunk size and count,
        # ``gather_s``, ``wait_s``, ``h2d_bytes`` and
        # ``transfer_stream_s`` (``ingest_overlapped``'s ``diag``).
        # Then the stage "checks" sets ``fetch_s`` (the host clock
        # around the fetch of the outputs to the host, the lag windows
        # through pinned buffers),
        # ``d2h_bytes`` (the bytes of that fetch, 0 on the CPU),
        # ``pairs`` (pairs correlated) and ``pairs_weighted`` (pairs past
        # the quality gate that the first solve weights); the window's
        # end sets ``lm_launches`` (its solves' launches of kernel 4, 0
        # on the CPU).
        self.ingest_diag: dict = {}
        # The batch ingest's pinned ring and its reader threads
        # (``load_window``), made by the first ``load_files`` on a card
        # and kept for the processor's life; none on the CPU.
        self._ring: Optional[_ChunkRing] = None
        # The pinned host buffers the stage "checks" fetches the lag
        # windows into (``_fetch_pinned``), one a name, kept while the
        # shape holds.
        self._pinned: Dict[str, torch.Tensor] = {}
        # Optional per-stage wall-clock accounting: any object whose
        # ``stage(name)`` is a context manager around one stage, e.g.
        # utils.profiling.StageTimer. The stages of a window follow one
        # another, none inside another, and some open more than once:
        # "load+decode" or "mmap", "prepare", "lo-compensate",
        # "correlate+clock", "ingest+correlate+clock" or
        # "tail-finalize+clock", "checks", "solve", "caf+deramp",
        # "multipath", "re-solve (echo-bias σ)", "analyze", "velocity",
        # "associate+solve-emitters", "assemble", "unmap".
        self.timer = None

    def _fetch_pinned(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the host: a card's tensor through the pinned buffer
        ``name``, which the next window overwrites, so nothing read from
        it may outlive this window. (A pageable fetch of 24 stations'
        lag windows, 309 MB, ran at ~2 GB/s.)"""
        if t.device.type == "cpu":
            return t
        buf = self._pinned.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self._pinned[name] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        return buf.copy_(t)

    def _stage(self, name: str):
        """The timer's stage ``name``, or nothing without a timer."""
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.stage(name)

    @classmethod
    def from_csv(
        cls, ref_freq: float, tgt_freq: float, csv_path: str,
        device: Optional[torch.device] = None, **cfg
    ) -> "TDOAProcessor":
        table = load_station_table(csv_path, reference_freq=ref_freq)
        return cls(ProcessorConfig(ref_freq=ref_freq, tgt_freq=tgt_freq, **cfg),
                   table, device=device)

    def _ref_geo_tdoa_samples(self, names: Sequence[str], pairs: np.ndarray) -> np.ndarray:
        """Geometric REF-transmitter TDOA per pair, in samples (zero when
        the REF transmitter's position is unknown)."""
        if self.stations.reference_tx is None:
            return np.zeros(len(pairs))
        lla = self.stations.lla_array(names)
        st = lla_to_ecef(lla)
        tx = lla_to_ecef(self.stations.reference_tx.lla())
        d = np.linalg.norm(st - tx, axis=-1)
        tau = d / SPEED_OF_LIGHT * self.config.sample_rate
        return tau[pairs[:, 1]] - tau[pairs[:, 0]]

    def _check_supported(self) -> None:
        cfg = self.config
        if cfg.lo_compensation not in ("auto", "off"):
            raise ValueError(
                f"lo_compensation must be 'auto' or 'off', got "
                f"{cfg.lo_compensation!r}"
            )
        if cfg.accumulator not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"accumulator must be 'auto', 'pallas' or 'xla', got "
                f"{cfg.accumulator!r}")

    def _fused_eligible(self, n_stations: int, min_block_samples: int,
                        staged: Optional[torch.dtype] = None) -> bool:
        """Whether the fused kernels run: the IQ mode, the kernel's
        alias-free lag window and ``TARGET_SEGS`` kernel segments per
        block on any device; on CUDA also the batch route's verdict
        (``batch_route``; ``staged``: the dtype of the stacks the caller
        already holds on the card, None before the decode). The one
        predicate behind both the accumulator="auto" decision and the
        bf16-decode decision.

        The reference's TPU route asks for one segment. The kernel's
        segment is fixed, so a shorter block holds fewer Welch segments
        than the segmented correlator's ``auto_seg_len`` shrinks its own
        segment to reach: with 2 or 3 the split σ's banks hold one
        segment, whose HT coherence is identically 1, and σ comes out
        over 10× the segmented route's, which silences the ghost and the
        audio-match cross-validation warnings (ROADMAP Queue 3). Such
        blocks take the segmented route, as the reference's own
        ``accumulator="auto"`` does off the TPU."""
        from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN, SEG_LEN

        cfg = self.config
        ok = (
            cfg.mode == "iq"
            and cfg.max_lag <= FFT_LEN - SEG_LEN
            and min_block_samples >= TARGET_SEGS * SEG_LEN
        )
        if ok and self.device.type == "cuda":
            ok = self.batch_route(n_stations, min_block_samples,
                                  staged).route == "pallas"
        return ok

    def _seg_fft_len(self, block_len: int) -> int:
        cfg = self.config
        return resolve_seg(block_len, cfg.max_lag,
                           auto_seg_len(block_len, cfg.max_lag, cfg.seg_len),
                           None)[1]

    def _card(self) -> torch.device:
        return torch.device("cuda", torch.cuda.current_device()
                            if self.device.index is None
                            else self.device.index)

    def route_bytes(self, n_stations: int, block_len: int,
                    staged: Optional[torch.dtype] = None):
        """(kernel route, segmented route) device bytes of the batch path
        on this processor's card for ``n_stations`` of ``block_len``
        samples, the length processed (after ``truncate_samples``):
        ``batch_route_bytes`` with kernel 1's launch at the block's own
        segments."""
        from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN, launch_bytes

        launch = launch_bytes(n_stations, station_pairs(n_stations), True, 4,
                              self._card(), block_len // SEG_LEN)
        return batch_route_bytes(n_stations, block_len,
                                 self.config.lo_compensation == "auto",
                                 self._seg_fft_len(block_len), launch, staged)

    def batch_route(self, n_stations: int, block_len: int,
                    staged: Optional[torch.dtype] = None) -> BatchRoute:
        """The batch route's verdict on this processor's card, taken once
        per station count, block length, LO setting, segmented FFT
        length and card, by whichever of ``load_files`` (before the
        decode) and ``process_captures`` (holding its stacks, of dtype
        ``staged``) asks first, and kept: the other asks at another free
        memory and must never disagree. Each route's need
        (``route_bytes``, from where it is asked) against the free
        memory (``mem_get_info``'s and what the allocator holds unused):
        the kernel route where its need fits; else the segmented route
        where its need fits, whether no launch of kernel 1 holds one
        pair or the memory refused it; else a ``RuntimeError`` naming
        both needs."""
        dev = self._card()
        key = (n_stations, block_len, self.config.lo_compensation == "auto",
               self._seg_fft_len(block_len), dev.index)
        verdict = _BATCH_ROUTES.get(key)
        if verdict is not None:
            return verdict
        kernel, segmented = self.route_bytes(n_stations, block_len, staged)
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        for route, need in (("pallas", kernel), ("xla", segmented)):
            if need is not None and need < free:
                verdict = BatchRoute(route, kernel, segmented, free)
                _BATCH_ROUTES[key] = verdict
                return verdict
        k_need = ("no launch holds one pair" if kernel is None
                  else f"needs {kernel / 1e9:.2f} GB")
        raise RuntimeError(
            f"{n_stations} stations of {block_len}-sample blocks fit neither "
            f"batch route on {dev}: kernel 1 {k_need}, the segmented "
            f"correlator {segmented / 1e9:.2f} GB, {free / 1e9:.2f} GB free; "
            f"shorter captures, fewer stations, or process_files_overlapped")

    def _reject_outliers(
        self,
        fix: FixResult,
        w: np.ndarray,
        tdoa_s: np.ndarray,
        tdoa_std_s: np.ndarray,
        names: Sequence[str],
        pairs: np.ndarray,
        lla: np.ndarray,
        worst_pair,  # callable(fix, weights) -> (score, pair index)
        warnings: List[str],
    ) -> Tuple[FixResult, np.ndarray, List[str]]:
        """Leave-stations-out outlier rejection on an inconsistent set.

        One corrupted station (multipath lock, co-channel interference)
        gives clean, confident peaks at wrong delays, poisoning n-1
        pairs in a way the per-pair quality gate cannot see. With >= 5
        stations the remaining network keeps a consistency redundancy
        (n-1 independent arrival differences vs 2 position unknowns),
        so excluding the bad station restores consistency while
        excluding any good one does not. An exclusion is adopted only
        when it is UNIQUE in restoring consistency; when no single
        exclusion works and >= 6 stations are active, station *pairs*
        are tried the same way (two outliers). Anything else stays
        advisory: a warning reports the per-exclusion residuals and the
        fix is left alone.
        """
        cfg = self.config
        n = len(names)
        if n < 5:
            return fix, w, []

        def solve_without(excl):
            mask = np.array(
                [float(i not in excl and j not in excl) for i, j in pairs]
            )
            w_x = w * mask
            if np.count_nonzero(w_x) < 3:
                return None
            return w_x, solve_fix(
                lla, tdoa_s, weights=w_x, pair_idx=pairs,
                solve_z=cfg.solve_z, tdoa_sigma_s=tdoa_std_s,
                device=self.device,
            )

        def consistent(t):
            excl_w, excl_fix = t[1]
            return worst_pair(excl_fix, excl_w)[0] <= 1.0

        tried = [
            ((s,), r) for s in range(n) if (r := solve_without({s}))
        ]
        passing = [t for t in tried if consistent(t)]
        if not passing and n >= 6:
            # Two outliers: no single exclusion can restore consistency,
            # but a unique pair of exclusions can (the remaining >= 4
            # stations keep one redundancy).
            tried = [
                ((a, b), r)
                for a in range(n) for b in range(a + 1, n)
                if (r := solve_without({a, b}))
            ]
            passing = [t for t in tried if consistent(t)]
        if len(passing) != 1:
            detail = ", ".join(
                f"without {'+'.join(names[s] for s in excl)}: "
                f"{r[1].rms_residual_m:.0f} m"
                for excl, r in tried
            )
            warnings.append(
                f"leave-one-station-out test is inconclusive "
                f"({len(passing)} exclusions restore consistency; "
                f"rms {detail}) — no station excluded"
            )
            return fix, w, []
        excl, (w_x, fix_x) = passing[0]
        excluded = [names[s] for s in excl]
        plural = len(excluded) > 1
        warnings.append(
            f"station{'s' if plural else ''} {' and '.join(excluded)} "
            f"excluded as outlier{'s' if plural else ''}: "
            f"{'their' if plural else 'its'} pairs are inconsistent "
            f"with the rest of the network (rms "
            f"{fix.rms_residual_m:.0f} m with "
            f"{'them' if plural else 'it'}, "
            f"{fix_x.rms_residual_m:.0f} m without) — suspect multipath "
            f"lock or co-channel interference there"
        )
        return fix_x, w_x, excluded

    def _analyze_fix(
        self,
        fix: FixResult,
        w: np.ndarray,
        tdoa_s: np.ndarray,
        tdoa_std_s: np.ndarray,
        names: Sequence[str],
        pairs: np.ndarray,
        lla: np.ndarray,
        tgt: torch.Tensor,
        ref1: torch.Tensor,
        warnings: List[str],
        deramp_note: str = "",
        fdoa_hz: Optional[np.ndarray] = None,
    ) -> Tuple[FixResult, np.ndarray, List[str], Optional[GhostVerdict]]:
        """Post-solve analysis of the FINAL TDOA set: consistency gate,
        outlier rejection, ghost-ambiguity detection (the unified
        prior + FDOA + power posterior, solve/ghost.py), and the
        out-of-prior warning. Must run after any step that can replace
        the fix/weights wholesale (the Doppler deramp re-solve).
        ``fdoa_hz``: the CAF's per-pair differential Dopplers (emitter
        motion only, drift-corrected), when solve_velocity measured
        them. Returns the possibly-updated
        (fix, weights, excluded_station_names, ghost_verdict)."""
        cfg = self.config
        # Mutually inconsistent TDOAs leave residuals the per-pair
        # quality gate cannot see: a co-channel interferer or strong
        # multipath produces clean, confident peaks on DIFFERENT
        # emitters/paths. The test is PER PAIR and normalized by each
        # pair's own 1σ: a pair whose residual at the fix exceeds
        # max(5σ, 100 m) is inconsistent beyond its error bar. (An
        # aggregate rms-vs-median-σ gate fails exactly when needed:
        # corruption that inflates the honest split-half σs raises the
        # aggregate gate until a 6 km mixed-emitter residual passes.)
        gate_m = np.maximum(
            5.0 * np.asarray(tdoa_std_s, np.float64) * SPEED_OF_LIGHT,
            100.0,
        )
        rd_m = np.asarray(tdoa_s, np.float64) * SPEED_OF_LIGHT

        def worst_pair(f: FixResult, weights) -> Tuple[float, int]:
            """(max |residual|/gate over active pairs, argmax pair)."""
            st_enu = lla_to_enu(lla, f.origin_lla)
            di = np.linalg.norm(f.enu - st_enu[pairs[:, 0]], axis=-1)
            dj = np.linalg.norm(f.enu - st_enu[pairs[:, 1]], axis=-1)
            r = np.abs((dj - di) - rd_m) / gate_m
            r = np.where(np.asarray(weights, np.float64) > 0.0, r, 0.0)
            k = int(np.argmax(r))
            return float(r[k]), k

        excluded: List[str] = []
        if cfg.outlier_rejection and worst_pair(fix, w)[0] > 1.0:
            fix, w, excluded = self._reject_outliers(
                fix, w, tdoa_s, tdoa_std_s, names, pairs, lla,
                worst_pair, warnings,
            )
        score, k_bad = worst_pair(fix, w)
        if score > 1.0:
            i, j = pairs[k_bad]
            warnings.append(
                f"TDOA set is internally inconsistent (pair "
                f"{names[i]}-{names[j]} residual {score * gate_m[k_bad]:.0f} "
                f"m vs its {gate_m[k_bad]:.0f} m error-bar gate): suspect "
                f"co-channel interference, multipath, or a wrong station "
                f"assignment{deramp_note}"
            )
        sigma_m = float(np.median(np.asarray(tdoa_std_s))) * SPEED_OF_LIGHT

        def runnerup(f: FixResult):
            """(location, rms, horizontal separation) of candidate #2."""
            second = f.candidates_lla[1]
            return (
                second,
                float(f.candidates_rms[1]),
                _horiz_m(second[0], second[1], f.lat, f.lon, f.elev),
            )

        # Ghost ambiguity: with 3 stations TDOA hyperbolas can intersect
        # TWICE, and both intersections satisfy every pair exactly — the
        # residual cannot choose (Monte Carlo found a silent 548 m miss
        # whose runner-up candidate sat 8 m from truth). When a distant
        # second solution fits within the measurement noise of the best,
        # the fix is genuinely ambiguous and must say so. Three physical
        # signals can still choose — operator prior, differential-
        # Doppler consistency, received-power consistency — combined
        # into ONE posterior-odds score (solve/ghost.py) whose
        # calibrated nats threshold drives the single swap decision
        # (round 3 ran them as a cascade of separately-thresholded
        # rules, each blind to the others' evidence).
        ghost_verdict = None
        if (fix.candidates_lla is not None
                and len(fix.candidates_lla) > 1
                and fix.candidates_rms is not None):
            second, rms2, sep = runnerup(fix)
            ell_a = fix.ellipse[0] if fix.ellipse is not None else 0.0
            close_fit = rms2 <= max(
                2.0 * fix.rms_residual_m, 3.0 * sigma_m, 5.0
            )
            if close_fit and sep > max(100.0, 3.0 * ell_a):
                from tdoa_tpu_torch.solve.ghost import ghost_posterior

                k_cand = len(fix.candidates_lla)
                n_active = int(np.count_nonzero(
                    np.asarray(w, np.float64) > 0))
                # ---- evidence, all on the CURRENT candidate order ----
                # Received power: timing cannot choose between the
                # intersections, but 1/r path loss can lean — the true
                # location's distances must match the received
                # amplitude profile (the REF block calibrates
                # per-station gain differences away, possible only when
                # the REF transmitter position is known).
                ref_tx = self.stations.reference_tx
                fix.candidates_power_score = rank_candidates_by_power(
                    fix.candidates_lla,
                    lla,
                    _station_signal_power(tgt),
                    ref_power=(
                        None if ref_tx is None
                        else _station_signal_power(ref1)
                    ),
                    ref_tx_lla=(
                        None if ref_tx is None else ref_tx.lla()
                    ),
                )
                # Coverage prior: operator knowledge of the
                # surveillance area. Fed to the posterior only when it
                # can actually discriminate (≥1 candidate inside) — a
                # prior excluding ALL candidates is evidence of a prior
                # mismatch, not of either candidate.
                prior_dist = prior_radius = None
                n_inside = None
                if cfg.prior is not None:
                    p_lat, p_lon, p_rad = cfg.prior
                    prior_dist = np.array([
                        _horiz_m(c[0], c[1], p_lat, p_lon, fix.elev)
                        for c in fix.candidates_lla
                    ])
                    prior_radius = float(p_rad)
                    n_inside = int(
                        np.count_nonzero(prior_dist <= prior_radius)
                    )
                # FDOA: both intersections satisfy the TDOAs, but the
                # measured pairwise Dopplers fit a single emitter
                # velocity only where the emitter→station geometry is
                # the true one — and a ghost often "fits" only via an
                # unphysical speed (the distant intersection's
                # unit-vector differences shrink, inflating |v|). Runs
                # only on CAF-significant Doppler (the caller's gate);
                # the speed barrier works even on an exactly-determined
                # fit, so only >= n_dim_v active pairs are required.
                fdoa_res = speeds = None
                fdoa_dof = 0
                n_dim_v = 3 if cfg.solve_z else 2
                if (fdoa_hz is not None and cfg.fdoa_disambiguation
                        and n_active >= n_dim_v):
                    from tdoa_tpu_torch.solve.fdoa import solve_velocity_enu

                    nu_g = np.asarray(fdoa_hz, np.float64)
                    st_g = lla_to_enu(lla, fix.origin_lla)
                    sols = [
                        solve_velocity_enu(
                            st_g, pairs,
                            lla_to_enu(np.asarray(c, np.float64),
                                       fix.origin_lla),
                            nu_g, cfg.tgt_freq, weights=w,
                            solve_z=cfg.solve_z,
                        )
                        for c in fix.candidates_lla
                    ]
                    fdoa_res = np.array([s.residual_hz for s in sols])
                    speeds = np.array([s.speed for s in sols])
                    fdoa_dof = max(0, n_active - n_dim_v)

                # ---- one posterior from everything ----
                def posterior(with_power: bool):
                    return ghost_posterior(
                        k_cand,
                        rms_m=np.asarray(fix.candidates_rms, np.float64),
                        sigma_m=sigma_m,
                        n_pairs_active=n_active,
                        power_scores=(
                            fix.candidates_power_score if with_power
                            else None
                        ),
                        n_stations=len(names),
                        fdoa_resid_hz=fdoa_res,
                        fdoa_dof=fdoa_dof,
                        speeds_mps=speeds,
                        max_speed_mps=cfg.max_emitter_speed_mps,
                        prior_dist_m=(
                            prior_dist if n_inside else None
                        ),
                        prior_radius_m=prior_radius,
                        threshold_nats=cfg.ghost_threshold_nats,
                    )

                verdict = posterior(with_power=True)
                # Power evidence may MOVE the fix only with the opt-in
                # flag (power_disambiguation — it rests on free-space
                # propagation assumptions the other signals don't
                # need): without it, the decision stands on the
                # prior/FDOA/timing evidence ALONE — disagreeing power
                # evidence stays visible in the reported posterior but
                # cannot veto the swap (an earlier form required
                # actionable.best == verdict.best, which let
                # uncalibrated power scores silently pin a
                # prior/FDOA-decided fix to the wrong intersection).
                no_power = posterior(with_power=False)
                actionable = (
                    verdict if cfg.power_disambiguation else no_power
                )
                swap_to = actionable.best if actionable.decided else 0
                # "Power moved the fix" only when power was PIVOTAL —
                # the power-free posterior would NOT have made the same
                # decision (not merely when power evidence existed:
                # that labeled prior-driven swaps as power-driven).
                power_moved = bool(
                    swap_to != 0 and cfg.power_disambiguation
                    and not (no_power.decided
                             and no_power.best == swap_to)
                )
                if swap_to != 0:
                    perm = np.asarray(
                        [swap_to] + [i for i in range(k_cand)
                                     if i != swap_to]
                    )
                    fix = refit_to_candidate(
                        fix, swap_to, lla, pairs,
                        weights=w, tdoa_sigma_s=tdoa_std_s,
                    )
                    # Keep every evidence array aligned with the
                    # reported candidate order (refit_to_candidate
                    # already reorders the fix's own arrays). The
                    # reported posterior's ``best`` follows its own
                    # argmax through the permutation — usually 0 (the
                    # swapped-to candidate), but honestly non-zero when
                    # power evidence disagreed with a power-free
                    # decision.
                    verdict = dataclasses.replace(
                        verdict,
                        log_odds=verdict.log_odds[perm],
                        best=int(np.nonzero(perm == verdict.best)[0][0]),
                        components={k2: v[perm] for k2, v
                                    in verdict.components.items()},
                    )
                    if prior_dist is not None:
                        prior_dist = prior_dist[perm]
                    if fdoa_res is not None:
                        fdoa_res = fdoa_res[perm]
                        speeds = speeds[perm]
                    second, rms2, sep = runnerup(fix)
                ghost_verdict = verdict

                # ---- per-signal notes (evidence the posterior saw,
                # in the reported candidate order) ----
                prior_txt = ""
                if prior_dist is not None:
                    if n_inside == 1:
                        prior_txt = (
                            f"; coverage prior "
                            f"({prior_radius / 1000.0:.0f} km around "
                            f"{cfg.prior[0]:.4f},{cfg.prior[1]:.4f}) "
                            f"selects the only in-prior solution"
                        )
                    elif n_inside == 0:
                        prior_txt = (
                            "; coverage prior excludes ALL candidates "
                            "— suspect geometry or a prior mismatch"
                        )
                    else:
                        prior_txt = (
                            f"; coverage prior keeps {n_inside} "
                            f"candidates — inconclusive"
                        )
                fdoa_txt = ""
                if fdoa_res is not None:
                    ll_f = verdict.components.get("fdoa")
                    k_f = int(np.argmax(ll_f))
                    m_f = float(ll_f[k_f] - np.delete(ll_f, k_f).max())
                    pref_f = ("the primary" if k_f == 0
                              else f"candidate #{k_f + 1}")
                    if m_f >= cfg.ghost_threshold_nats:
                        fdoa_txt = (
                            f"; differential-Doppler consistency "
                            f"selects {pref_f} solution (fit residuals "
                            f"{'/'.join(f'{r:.2f}' for r in fdoa_res)}"
                            f" Hz, fitted speeds "
                            f"{'/'.join(f'{s:.0f}' for s in speeds)}"
                            f" m/s)"
                        )
                    else:
                        fdoa_txt = (
                            f"; differential-Doppler consistency is "
                            f"inconclusive (residuals "
                            f"{'/'.join(f'{r:.2f}' for r in fdoa_res)}"
                            f" Hz, speeds "
                            f"{'/'.join(f'{s:.0f}' for s in speeds)}"
                            f" m/s)"
                        )
                scores = np.asarray(
                    fix.candidates_power_score, np.float64
                )
                best_p = int(np.argmin(scores))
                margin_p = float(
                    np.delete(scores, best_p).min() - scores[best_p]
                )
                cal_txt = (
                    "REF-gain-calibrated" if ref_tx is not None
                    else "UNcalibrated per-station gains"
                )
                if margin_p >= 0.1:
                    pref = (
                        "primary" if best_p == 0
                        else f"candidate #{best_p + 1}"
                    )
                    power_txt = (
                        f"; received-power ranking (1/r path loss, "
                        f"{cal_txt}, advisory) prefers the {pref} "
                        f"solution (consistency {scores.min():.2f} vs "
                        f"next {scores.min() + margin_p:.2f} log-σ)"
                    )
                    if power_moved and best_p == 0:
                        power_txt += (
                            " — fix moved to the power-preferred "
                            "solution (power_disambiguation on)"
                        )
                else:
                    power_txt = (
                        f"; received-power ranking ({cal_txt}) is "
                        f"inconclusive (best margin {margin_p:.2f} "
                        f"log-σ)"
                    )
                # ---- the unified verdict ----
                runner = (
                    int(np.argsort(verdict.log_odds)[-2])
                    if k_cand > 1 else 0
                )
                contribs = ", ".join(
                    f"{k2} {float(v[verdict.best] - v[runner]):+.1f}"
                    for k2, v in verdict.components.items()
                )
                post_txt = (
                    f"; unified posterior: "
                    + ("the primary" if verdict.best == 0
                       else f"candidate #{verdict.best + 1}")
                    + f" leads by {verdict.margin_nats:.1f} nats "
                    f"({contribs}) vs the "
                    f"{cfg.ghost_threshold_nats:.1f}-nat decision "
                    f"threshold"
                    + (" — fix moved to the posterior-preferred "
                       "solution" if swap_to != 0
                       else (" — decided, already the primary"
                             if actionable.decided
                             and actionable.best == 0
                             else " — abstaining, fix unmoved"))
                )
                warnings.append(
                    f"ambiguous fix (TDOA ghost): a second solution "
                    f"{sep:.0f} m away at {second[0]:.6f},{second[1]:.6f} "
                    f"fits equally well (rms {rms2:.1f} m vs "
                    f"{fix.rms_residual_m:.1f} m) — a fourth station or "
                    f"a coverage prior disambiguates"
                    f"{prior_txt}{fdoa_txt}{power_txt}{post_txt}"
                )

        if cfg.prior is not None:
            p_lat, p_lon, p_rad = cfg.prior
            d_fix = _horiz_m(fix.lat, fix.lon, p_lat, p_lon, fix.elev)
            if d_fix > p_rad:
                warnings.append(
                    f"fix is {d_fix / 1000.0:.1f} km outside the "
                    f"coverage prior ({p_rad / 1000.0:.0f} km around "
                    f"{p_lat:.4f},{p_lon:.4f})"
                )
        return fix, w, excluded, ghost_verdict

    def _separate_emitters(
        self,
        caf_info: Optional[dict],
        clock,
        lla: np.ndarray,
        pairs: np.ndarray,
        names: Sequence[str],
        drift_ppm: np.ndarray,
        lo_ppm: Optional[np.ndarray],
        win64: np.ndarray,
        tdoa_std_s: np.ndarray,
        tgt: torch.Tensor,
        warnings: List[str],
    ) -> List[EmitterFix]:
        """The multi-emitter branch of ``process_captures``: associate
        the per-pair candidate peaks into cycle-consistent TDOA sets —
        jointly in (lag, Doppler) on the CAF surface when a velocity run
        left one (``caf_info``) whose window holds every raw lag, else
        by lag alone on the plain TGT window — and solve each set."""
        from tdoa_tpu_torch.solve.association import (
            associate_emitters,
            associate_emitters_joint,
            top_k_peaks,
            top_k_peaks_2d,
        )
        from tdoa_tpu_torch.solve.fdoa import solve_velocity_enu

        cfg = self.config
        k = cfg.multi_emitter + 2  # slack for sidelobes/noise peaks
        clock_np = np.asarray(clock, np.float64)
        per_fdoa: List[Optional[np.ndarray]] = []
        # The CAF surface spans only ±min(max_lag, 2048) lags. Raw TGT
        # lags = geometry (≤ baseline/c) + clock offsets, which can
        # reach thousands of samples on unsynchronized clocks — the
        # reason max_lag defaults to 20000. Joint association is only
        # valid when the window provably contains them.
        joint_ok = False
        if caf_info is not None:
            ecef_st = lla_to_ecef(lla)
            bl_max = max(
                np.linalg.norm(ecef_st[i] - ecef_st[j]) for i, j in pairs
            )
            bound = (
                bl_max / SPEED_OF_LIGHT * cfg.sample_rate
                + np.abs(clock_np).max()
                + 64.0
            )
            joint_ok = bound < caf_info["max_lag"]
            if not joint_ok:
                warnings.append(
                    "raw TGT lags may exceed the CAF window "
                    f"(bound {bound:.0f} vs ±{caf_info['max_lag']}"
                    " samples): multi-emitter association fell "
                    "back to the lag-only path (no per-emitter "
                    "Doppler)"
                )
        drift_nu_me = (
            np.zeros_like(drift_ppm) if lo_ppm is not None
            else cfg.tgt_freq * 1e-6 * drift_ppm
        )
        if joint_ok:
            # Joint (lag, Doppler) association on the CAF surface: a
            # mover whose Doppler decorrelates the plain full-block sum
            # (anything beyond ~1/T_block) is invisible in the plain
            # window but is a clean peak here, and every emitter gets
            # its OWN FDOA set. Lags are parabolic-only (~0.1 sample)
            # and windowed to the CAF's ±max_lag.
            from tdoa_tpu_torch.solve.association import caf_lag_resolution
            from tdoa_tpu_torch.solve.fdoa import station_doppler_from_pairs

            surf = caf_info["surface"]
            lag_res = caf_lag_resolution(surf)
            # Wider slate than the lag-only path (+4, not +2): a
            # smeared mover colliding in LAG with a static emitter
            # leaves a ridge whose Doppler sidelobes occupy several 2D
            # top-k slots at one lag; with only +2 the mover's own
            # (weaker) candidate can fall off the list. The joint
            # gate's second (Doppler) axis keeps the extra noise
            # candidates from assembling spurious sets.
            lags, dops, vals = top_k_peaks_2d(surf, k + 2, guard_lag=lag_res)
            cand_tdoa = (lags - caf_info["max_lag"]) - clock_np[:, None]
            ndop = surf.shape[1]
            dop_step = 2.0 * caf_info["span_hz"] / (ndop - 1)
            cand_nu_raw = -caf_info["span_hz"] + dops * dop_step
            cand_fdoa = cand_nu_raw + drift_nu_me[:, None]
            # Lag tolerance at the CAF's own resolution: its envelope
            # peak localizes only to a fraction of the main-lobe width;
            # Doppler consistency carries the fine discrimination
            # between hypotheses.
            joint = associate_emitters_joint(
                cand_tdoa,
                cand_fdoa,
                vals,
                pairs,
                len(names),
                tol_samples=max(cfg.emitter_tol_samples, 0.5 * lag_res),
                tol_hz=max(4.0, 2.0 * caf_info["bin_hz"]),
                max_emitters=cfg.multi_emitter,
            )
            sets = [es for es, _ in joint]
            per_fdoa = [f for _, f in joint]
            # Each pair's true dominant peak (σ scaling below).
            dominant = vals[:, 0]
            # Per-emitter deramp refinement: counter-rotate the
            # stations by THIS emitter's Doppler solution and
            # re-correlate — its peak sharpens to full sub-sample
            # precision; take the peak nearest the coarse lag (the
            # other emitters' peaks, now smeared, sit elsewhere).
            refined_sets = []
            for es, e_f in zip(sets, per_fdoa):
                nu_raw_e = e_f - drift_nu_me
                s_e = station_doppler_from_pairs(pairs, nu_raw_e, len(names))
                re_ = _deramp_correlate(
                    tgt, s_e, pairs, caf_info["lim"],
                    caf_info["max_lag"], cfg.seg_len,
                    cfg.weighting, cfg.sample_rate,
                )
                win_e = re_.corr.cpu().numpy().astype(np.float64)
                raw_coarse = es.tdoa + clock_np
                refined = np.array(es.tdoa, copy=True)
                for pk in range(len(pairs)):
                    c0 = int(round(raw_coarse[pk])) + caf_info["max_lag"]
                    lo = max(1, c0 - lag_res)
                    hi = min(win_e.shape[1] - 1, c0 + lag_res + 1)
                    if hi <= lo:
                        continue
                    seg = win_e[pk, lo:hi]
                    i0 = int(np.argmax(seg)) + lo
                    ym1, y0, yp1 = win_e[pk, i0 - 1:i0 + 2]
                    den = ym1 - 2 * y0 + yp1
                    off = (0.5 * (ym1 - yp1) / den
                           if abs(den) > 1e-12 else 0.0)
                    off = float(np.clip(off, -0.5, 0.5))
                    refined[pk] = (
                        i0 + off - caf_info["max_lag"] - clock_np[pk]
                    )
                refined_sets.append(es._replace(tdoa=refined))
            sets = refined_sets
        else:
            # Lag-only association on the plain correlation window. The
            # window's lag axis is in correlation units: decimated
            # audio samples for mode="fm" (rescale), IQ samples
            # otherwise — mirrors process_blocks' max_lag_c.
            if cfg.mode == "fm":
                scale = float(cfg.fm_decim)
                max_lag_c = max(cfg.max_lag // cfg.fm_decim + 2, 16)
            else:
                scale = 1.0
                max_lag_c = cfg.max_lag
            cand = top_k_peaks(win64, k=k)
            cand_tdoa = (cand.lag - max_lag_c) * scale - clock_np[:, None]
            sets = associate_emitters(
                cand_tdoa,
                cand.value,
                pairs,
                len(names),
                tol_samples=cfg.emitter_tol_samples,
                max_emitters=cfg.multi_emitter,
            )
            per_fdoa = [None] * len(sets)
            dominant = cand.value[:, 0]
        emitters = []
        for es, e_fdoa in zip(sets, per_fdoa):
            ew = (es.value / max(es.value.max(), 1e-9)) ** 2
            # tdoa_std_s was measured on each pair's DOMINANT peak
            # (phase-slope refinement); an associated candidate that is
            # a weaker peak has proportionally lower correlation SNR,
            # and its lag comes from the coarser parabolic fit. Scale
            # sigma by the peak ratio so a secondary emitter's ellipse
            # is not copied from the primary's confidence.
            ratio = dominant / np.maximum(es.value, 1e-12)
            e_sigma = tdoa_std_s * np.maximum(ratio, 1.0)
            efix = solve_fix(
                lla,
                es.tdoa / cfg.sample_rate,
                weights=ew,
                pair_idx=pairs,
                solve_z=cfg.solve_z,
                tdoa_sigma_s=e_sigma,
                device=self.device,
            )
            e_vel = e_vsig = None
            if e_fdoa is not None:
                ev = solve_velocity_enu(
                    lla_to_enu(lla, efix.origin_lla),
                    pairs, efix.enu, e_fdoa, cfg.tgt_freq,
                    weights=ew, solve_z=cfg.solve_z,
                    fdoa_sigma_floor_hz=caf_info["bin_hz"] / 8.0,
                )
                e_vel = ev.vel_enu
                e_vsig = ev.sigma_enu
            emitters.append(
                EmitterFix(
                    fix=efix,
                    tdoa_samples=es.tdoa,
                    peak_value=es.value,
                    max_inconsistency_samples=es.max_inconsistency,
                    fdoa_hz=e_fdoa,
                    velocity_enu=e_vel,
                    velocity_sigma_enu=e_vsig,
                    solve_weights=np.asarray(ew, np.float64),
                )
            )
        if len(emitters) > 1:
            warnings.append(
                f"{len(emitters)} co-channel emitters resolved; the "
                f"primary fix reflects the per-pair dominant peaks "
                f"(see emitters[] for the separated fixes)"
            )
        elif not emitters:
            # Association was requested and found NOTHING cycle-
            # consistent: the per-pair candidate peaks disagree in lag
            # (or Doppler, on the joint path). That is itself a
            # diagnosis and must never pass silently, because the
            # primary fix may then be a lock on one emitter of several,
            # or a mixture.
            warnings.append(
                "multi-emitter association found no cycle-"
                "consistent candidate sets (per-pair peaks "
                "disagree in lag/Doppler): the primary fix may "
                "mix co-channel emitters or lock onto just one "
                "of them"
            )
        return emitters

    def process_captures(
        self, captures: Dict[str, Tuple], *,
        tail: Optional["TailIngest"] = None,
    ) -> TDOAResult:
        """Run the pipeline on in-memory blocks {station: (ref1, tgt,
        ref2)}: complex arrays (numpy or torch) or planar [2, L] tensors
        (the ``.dat`` ingest path) — or on ``HostCapture`` handles, which
        stream through the overlapped ingest.

        ``tail``: a ``pipeline.ingest.TailIngest`` session that already
        streamed (part of) this window while its files were growing —
        the correlate step then drains and finalizes the session
        instead of re-streaming from byte 0, and everything downstream
        (gates, warnings, solve, ghost/outlier analysis) runs
        unchanged. Requires every capture to be a ``HostCapture`` in
        the session's exact station order."""
        cfg = self.config
        stage = self._stage
        lm_launches = lm_solve.launches
        # Stages follow one another, none inside another: the
        # window is their one parent.
        with stage("prepare"):
            names = [n for n in captures.keys()]
            if len(names) < 3:
                raise ValueError("need at least 3 stations for a 2D fix")
            pairs = station_pairs(len(names))

            # Overlapped-ingest mode: every station arrives as a
            # host-resident HostCapture and the correlation step streams it
            # chunk-by-chunk (pipeline/ingest.py) instead of staging whole
            # blocks on device. Everything downstream of the correlate step
            # runs UNCHANGED. The analyses that sample the waveform eagerly
            # (received-power ghost ranking) read contiguous-run host
            # subsamples.
            host_mode = all(
                isinstance(captures[n], HostCapture) for n in names
            )
            if tail is not None:
                if not host_mode:
                    raise ValueError(
                        "tail sessions need HostCapture captures"
                    )
                if tail.names != names:
                    raise ValueError(
                        f"tail session stations {tail.names} != window "
                        f"stations {names}"
                    )
                if not tail.check_final_sizes(
                    [captures[n].u16.shape[0] for n in names]
                ):
                    raise ValueError(
                        f"tail session block-length mismatch — "
                        f"{tail.mismatch}; reprocess via the batch path"
                    )
            if host_mode:
                unsupported = [
                    opt for opt, on in (
                        ("mode='fm'", cfg.mode != "iq"),
                        ("lo_compensation", cfg.lo_compensation == "auto"),
                        ("solve_velocity", cfg.solve_velocity),
                        ("multi_emitter", cfg.multi_emitter > 1),
                    ) if on
                ]
                if unsupported:
                    raise ValueError(
                        "overlapped ingest supports the standard IQ path; "
                        f"{', '.join(unsupported)} need the whole blocks on "
                        "device — use process_files/process_captures"
                    )
            self._check_supported()

            def prep(b) -> torch.Tensor:
                b = _planar(b, self.device)
                if cfg.truncate_samples is not None:
                    b = b[:, :cfg.truncate_samples]
                return b

            def stack(idx: int) -> torch.Tensor:
                return torch.stack([prep(captures[n][idx]) for n in names],
                                   dim=1)

            # Capture-time geometry: REF1/REF2 midpoints are two ORIGINAL
            # block lengths apart even when the analysis window is truncated.
            if host_mode:
                orig_block_len = min(captures[n].block_len for n in names)

                # Small contiguous-run subsamples stand in for the waveform
                # in the eager power analyses (mean power AND the Welch
                # spectral estimator — see HostCapture.subsample_planar).
                def stack_sub(idx: int) -> torch.Tensor:
                    return _stack_station_subsamples([
                        captures[n].subsample_planar(idx, device=self.device)
                        for n in names
                    ])

                ref1, tgt, ref2 = stack_sub(0), stack_sub(1), stack_sub(2)
            else:
                orig_block_len = min(int(captures[n][0].shape[-1])
                                     for n in names)
                ref1, tgt, ref2 = stack(0), stack(1), stack(2)
            ref_geo = self._ref_geo_tdoa_samples(names, pairs)
        warnings: List[str] = []
        lo_ppm = None
        if cfg.lo_compensation == "auto":
            from tdoa_tpu_torch.ops.caf import caf_pairs
            from tdoa_tpu_torch.solve.fdoa import station_doppler_from_pairs

            with stage("lo-compensate"):
                lim0 = min(int(ref1.shape[-1]), cfg.caf_max_samples)
                probe_lag = min(cfg.max_lag, 2048)
                # The CAF probe's window is only ±probe_lag, but raw REF
                # lags = geometry + clock offsets — thousands of samples
                # on unsynchronized clocks (the reason max_lag defaults
                # to 20000). When the configured lag budget exceeds the
                # probe window, pre-align: a coarse plain correlation
                # over the FULL ±max_lag measures the raw lags, a
                # min-norm per-station solve turns them into integer
                # shifts, and each station's probe slice starts at its
                # own shift — residual probe lags are then sub-sample.
                probe_sig = ref1[:, :, :lim0].to(torch.float32)
                probe_ok = True
                if cfg.max_lag > probe_lag:
                    lim_c = min(lim0, 1 << 20)
                    coarse = correlate_pairs(
                        ref1[:, :, :lim_c].to(torch.float32),
                        pairs,
                        max_lag=cfg.max_lag,
                        seg_len=cfg.seg_len,
                        weighting=cfg.weighting,
                    )
                    raw_lag = coarse.delay.cpu().numpy().astype(np.float64)
                    q_coarse = coarse.quality.cpu().numpy().astype(np.float64)
                    if np.abs(raw_lag).max() + 64.0 > probe_lag:
                        if q_coarse.min() < 5.0:
                            probe_ok = False
                            warnings.append(
                                "lo-compensation skipped: raw REF lags "
                                f"(max {np.abs(raw_lag).max():.0f} "
                                f"samples) exceed the probe window "
                                f"±{probe_lag} and the coarse "
                                "clock pre-alignment found no reliable "
                                "REF peaks (min peak-to-sidelobe "
                                f"{q_coarse.min():.1f})"
                            )
                        else:
                            off = station_doppler_from_pairs(
                                pairs, raw_lag, len(names)
                            )
                            off = np.round(off - off.min()).astype(int)
                            aligned_len = lim0 - int(off.max())
                            if aligned_len < 4 * cfg.caf_seg_len:
                                probe_ok = False
                                warnings.append(
                                    "lo-compensation skipped: clock "
                                    f"offsets (max {off.max()} samples) "
                                    "leave too little aligned REF1 "
                                    f"overlap ({aligned_len} samples) "
                                    "for the CAF probe"
                                )
                            else:
                                probe_sig = torch.stack([
                                    ref1[:, k, int(off[k]):int(off[k])
                                         + aligned_len]
                                    for k in range(len(names))
                                ], dim=1).to(torch.float32)
                if probe_ok:
                    lim_p = int(probe_sig.shape[-1])
                    probe = caf_pairs(
                        probe_sig,
                        pairs,
                        sample_rate=cfg.sample_rate,
                        max_lag=probe_lag,
                        seg_len=cfg.caf_seg_len,
                        n_doppler=cfg.caf_n_doppler,
                    )
                    nu_ref = probe.doppler_hz.cpu().numpy().astype(np.float64)
                    seg_r0, _ = resolve_seg(
                        lim_p, probe_lag, cfg.caf_seg_len, None
                    )
                    bin0 = (
                        cfg.sample_rate / seg_r0
                    ) / (cfg.caf_n_doppler - 1)
                    # Peak-to-floor gate: a station with no usable REF
                    # reception gives an arbitrary (lag, Doppler)
                    # argmax; applying it would smear EVERY station's
                    # blocks.
                    p_surf = probe.surface.cpu().numpy().astype(np.float64)
                    psr = probe.peak_value.cpu().numpy().astype(np.float64) / (
                        p_surf.mean(axis=(1, 2)) + 1e-30
                    )
                else:
                    psr = np.zeros(len(pairs))
                    nu_ref = np.zeros(len(pairs))
                    bin0 = np.inf
                del probe_sig
                if psr.min() >= 5.0 and np.abs(nu_ref).max() > 2.0 * bin0:
                    s_ref = station_doppler_from_pairs(
                        pairs, nu_ref, len(names)
                    )
                    # LO offset scales with the tuned carrier: the REF
                    # block measures drift·f_ref; each block derotates
                    # by drift·f_block. One block at a time, so only one
                    # block's rotation tables are ever alive.
                    lo_ppm = s_ref / cfg.ref_freq * 1e6
                    ref1 = _derotate(ref1, s_ref, cfg.sample_rate)
                    ref2 = _derotate(ref2, s_ref, cfg.sample_rate)
                    tgt = _derotate(tgt, lo_ppm * 1e-6 * cfg.tgt_freq,
                                    cfg.sample_rate)

        if host_mode and tail is not None:
            with stage("tail-finalize+clock"):
                out = tail.finalize([captures[n].u16 for n in names])
        elif host_mode:
            from tdoa_tpu_torch.pipeline.ingest import ingest_overlapped

            bl = orig_block_len
            if cfg.truncate_samples is not None:
                bl = min(bl, cfg.truncate_samples)
            with stage("ingest+correlate+clock"):
                out = ingest_overlapped(
                    [captures[n].u16 for n in names],
                    pairs,
                    ref_geo,
                    block_len=bl,
                    block_lens=[captures[n].block_len for n in names],
                    max_lag=cfg.max_lag,
                    seg_len=cfg.seg_len,
                    weighting=cfg.weighting,
                    clock_correction=cfg.clock_correction,
                    diag=self.ingest_diag,
                    accumulator=cfg.accumulator,
                    device=self.device,
                )
        else:
            # The route, decided on the stacks the correlation reads:
            # the derotated ones where LO compensation ran.
            with stage("prepare"):
                accumulator = cfg.accumulator
                if accumulator == "auto":
                    accumulator = (
                        "pallas"
                        if self._fused_eligible(len(names),
                                                int(ref1.shape[-1]),
                                                ref1.dtype)
                        else "xla"
                    )
            with stage("correlate+clock"):
                out = process_blocks(
                    ref1, tgt, ref2, pairs,
                    torch.as_tensor(ref_geo, dtype=torch.float32),
                    max_lag=cfg.max_lag,
                    seg_len=cfg.seg_len,
                    weighting=cfg.weighting,
                    clock_correction=cfg.clock_correction,
                    mode=cfg.mode,
                    fm_decim=cfg.fm_decim,
                    sample_rate=cfg.sample_rate,
                    accumulator=accumulator,
                )
        with stage("checks"):
            t_fetch = time.perf_counter()
            *small, tgt_window, tgt_std, win_c_blocks = out
            (corrected, tgt_d, ref_d, clock, quality, peaks,
             corr_std) = (t.cpu() for t in small)
            tgt_std = tgt_std.cpu()
            # The two large outputs through pinned buffers, which the
            # next window's fetch overwrites: what outlives this window
            # is copied out of them (``win64``, the widened ``cx``), and
            # the rest is read before it returns. The lag windows [3
            # (block), m, W] complex64 are widened where read.
            tgt_window = self._fetch_pinned("tgt_window", tgt_window)
            win_c_blocks = self._fetch_pinned("win_c", win_c_blocks).numpy()
            self.ingest_diag["fetch_s"] = time.perf_counter() - t_fetch
            self.ingest_diag["d2h_bytes"] = sum(
                t.numel() * t.element_size() for t in out
                if t.device.type != "cpu")
            self.ingest_diag["pairs"] = len(pairs)
            corrected = np.asarray(corrected, np.float64)
            tdoa_s = corrected / cfg.sample_rate
            tdoa_std_s = np.asarray(corr_std, np.float64) / cfg.sample_rate
            # REF clock-correction variance (s²): the composite σ minus the
            # TGT block's own — re-attached to any re-measured TGT σ (the
            # deramp path) so σs stay commensurate across candidate sets.
            ref_var_s2 = np.maximum(
                tdoa_std_s ** 2
                - (np.asarray(tgt_std, np.float64) / cfg.sample_rate) ** 2,
                0.0,
            )
            ref_d = np.asarray(ref_d, np.float64)
            # REF-block midpoints sit 2 original block lengths apart.
            drift_ppm = ((ref_d[:, 1] - ref_d[:, 0]) / (2 * orig_block_len)
                         * 1e6)
            if lo_ppm is not None:
                rel = ", ".join(
                    f"{n} {p_:+.3f}" for n, p_ in zip(names, lo_ppm)
                )
                warnings.append(
                    f"receiver LO offsets measured from the REF block and "
                    f"compensated (relative ppm: {rel})"
                )
            if cfg.clock_correction and self.stations.reference_tx is None:
                warnings.append(
                    f"reference transmitter position unknown (no station row "
                    f"named '{cfg.ref_freq:.0f}'): clock correction cancels "
                    f"clock offsets but leaves the REF transmitter's per-pair "
                    f"geometric TDOA in every measurement — the fix may be "
                    f"biased"
                )
            lla = self.stations.lla_array(names)
            ecef = lla_to_ecef(lla)
            q_arr = np.asarray(quality[1], np.float64)
            for k, (i, j) in enumerate(pairs):
                bl = np.linalg.norm(ecef[i] - ecef[j])
                max_tdoa = bl / SPEED_OF_LIGHT
                if abs(tdoa_s[k]) > max_tdoa * 1.05:
                    warnings.append(
                        f"pair {names[i]}-{names[j]}: TDOA "
                        f"{tdoa_s[k]*1e6:.2f} us "
                        f"exceeds baseline limit {max_tdoa*1e6:.2f} us"
                    )
                if q_arr[k] < 5.0:
                    warnings.append(
                        f"pair {names[i]}-{names[j]}: weak correlation "
                        f"(peak-to-sidelobe {q_arr[k]:.1f}) — measurement "
                        f"downweighted"
                    )

            # Co-channel presence check: a second emitter at comparable
            # power puts a second strong peak in every pair's correlation.
            # When all pairs lock the SAME second emitter the TDOA set is
            # cycle-consistent and the fix lands cleanly — on whichever
            # source won the peak race — so no residual or quality gate can
            # see it. The secondary peak can. The detection runs in every
            # mode (the lobe-shape detector below stands down on it); the
            # WARNING is mode-1 only — with multi_emitter > 1 the
            # association path already separates and reports the sources.
            from tdoa_tpu_torch.solve.association import top_k_peaks

            win64 = np.asarray(tgt_window, np.float64)
            cand = top_k_peaks(win64, 2)
            second_frac = cand.value[:, 1] / np.maximum(
                cand.value[:, 0], 1e-30
            )
            strong = second_frac >= 0.6
            secondary_fired = bool(
                np.count_nonzero(strong) >= max(1, (len(pairs) + 1) // 2)
            )
            if secondary_fired and cfg.multi_emitter == 1:
                warnings.append(
                    f"strong secondary correlation peaks on "
                    f"{int(np.count_nonzero(strong))}/{len(pairs)} pairs "
                    f"(>= 60% of the primary): a co-channel emitter or "
                    f"strong multipath is present and the single-emitter "
                    f"fix may belong to either source — rerun with "
                    f"--multi-emitter 2 to separate them"
                )
            # In-peak multipath detector: an echo INSIDE the correlation
            # peak width merges with the direct path — no secondary peak,
            # no quality drop, and a 3-station fix absorbs the common bias
            # with near-zero residual (a Monte Carlo silent miss, seed
            # 6204). The merged lobe's shape gives it away: a clean GCC
            # peak's power centroid is stable as the measuring window
            # widens (|skew| change < 0.5 over L=20→60 on clean AND noisy
            # scenes), while a direct+echo composite drags the centroid
            # further with every widening (drift > 1.0 on 11/13 planted-
            # echo scenes). Computed on the plain windows, so it stands
            # down when motion smear explains the distortion (deramp) or a
            # resolvable second source already fired the stronger warning.
            # (IQ mode only: FM-mode audio correlation is plain-weighted and
            # oversampled — its lobes are legitimately wide and asymmetric.)
            # The echo-bias offset below reads the same windows' wide
            # centroid: both come from one pass.
            if cfg.mode == "iq":
                lobe_drift, lobe_offset = lobe_centroid_drift_offset(win64)
            else:
                lobe_drift = np.zeros(len(pairs))
            # Windows the echo-bias σ accounting reads: the REPORTED
            # measurement's. A deramp adoption below swaps in the deramped
            # windows (motion smear removed there — any residual centroid
            # drag on them is echo, not motion).
            echo_win = win64

            q = np.asarray(quality[1], np.float64)
            # Quadratic quality weighting with a hard gate: a pair whose
            # correlation peak barely clears the sidelobe floor carries no
            # usable timing — letting it vote at all can drag the solve by
            # hundreds of km (its residual is unbounded). Gate only while
            # enough healthy pairs remain to fix a position.
            w = (q / np.maximum(q.max(), 1e-9)) ** 2
            gated = w * (q >= 5.0)
            if np.count_nonzero(gated) >= min(3, len(pairs)):
                w = gated
            self.ingest_diag["pairs_weighted"] = int(np.count_nonzero(w))
        with stage("solve"):
            fix = solve_fix(
                lla,
                tdoa_s,
                weights=w,
                pair_idx=pairs,
                solve_z=cfg.solve_z,
                tdoa_sigma_s=tdoa_std_s,
                device=self.device,
            )
        # Consistency / outlier / ghost / prior analysis runs AFTER
        # the deramp re-solve below has settled the final TDOA set
        # (solve_velocity can replace fix/weights wholesale) — see
        # _analyze_fix.

        velocity_enu = velocity_residual_hz = fdoa_out = None
        velocity_sigma = None
        caf_info = None
        deramp_note = ""
        nu_emitter = None
        motion_detected = False  # significant Doppler seen by the CAF
        if cfg.solve_velocity:
            from tdoa_tpu_torch.ops.caf import caf_pairs
            from tdoa_tpu_torch.solve.fdoa import (
                solve_velocity_enu,
                station_doppler_from_pairs,
            )

            with stage("caf+deramp"):
                lim = min(int(tgt.shape[-1]), cfg.caf_max_samples)
                caf_max_lag = min(cfg.max_lag, 2048)
                caf = caf_pairs(
                    tgt[:, :, :lim].to(torch.float32),
                    pairs,
                    sample_rate=cfg.sample_rate,
                    max_lag=caf_max_lag,
                    seg_len=cfg.caf_seg_len,
                    n_doppler=cfg.caf_n_doppler,
                )
                nu = caf.doppler_hz.cpu().numpy().astype(np.float64)
                # A pair's relative clock drift (measured from the dual
                # REF blocks) is a delay rate alpha = drift_ppm·1e-6 and
                # contributes Doppler -f_tgt·alpha that is NOT emitter
                # motion — subtract it. UNLESS LO compensation already
                # derotated the blocks: the drift Doppler is then gone
                # from the signal and adding the (still-real) timing-
                # drift term would double-correct.
                drift_nu = (
                    np.zeros_like(drift_ppm) if lo_ppm is not None
                    else cfg.tgt_freq * 1e-6 * drift_ppm
                )
                nu_emitter = nu + drift_nu
                # The CAF's Doppler grid spacing, from the segment
                # length caf_pairs ACTUALLY used (resolve_seg shrinks
                # seg_len by max_lag for the alias-free window).
                seg_r, _ = resolve_seg(lim, caf_max_lag, cfg.caf_seg_len, None)
                bin_hz = (cfg.sample_rate / seg_r) / (cfg.caf_n_doppler - 1)
                # Doppler — emitter motion OR receiver LO offset (the
                # raw nu carries both) — smears the PLAIN correlation:
                # exactly what the CAF compensates. When significant,
                # run deramp-and-correlate: solve per-station frequency
                # shifts from the raw pairwise Doppler, counter-rotate
                # each station's TGT block, and re-run the full-
                # precision plain correlator. The CAF's own delay has
                # coarse-peak ambiguity on broad narrowband peaks; the
                # deramped plain path recovers sub-0.01-sample accuracy.
                deramped = np.abs(nu).max() > 2.0 * bin_hz
                motion_detected = bool(deramped)
                if deramped:
                    s_dop = station_doppler_from_pairs(pairs, nu, len(names))
                    r2 = _deramp_correlate(
                        tgt, s_dop, pairs, lim, cfg.max_lag,
                        cfg.seg_len, cfg.weighting, cfg.sample_rate,
                    )
                    r2_delay = r2.delay.cpu().numpy().astype(np.float64)
                    corrected2 = r2_delay - np.asarray(clock, np.float64)
                    q2 = r2.quality.cpu().numpy().astype(np.float64)
                    w2 = (q2 / np.maximum(q2.max(), 1e-9)) ** 2
                    gated2 = w2 * (q2 >= 5.0)  # same gate as the
                    # primary solve: a noise-floor pair must not vote
                    if np.count_nonzero(gated2) >= min(3, len(pairs)):
                        w2 = gated2
                    # The deramp re-measures only the TGT block; its
                    # corrected TDOAs still carry the SAME REF clock
                    # correction, so the composite σ keeps the REF
                    # variance term — comparing a TGT-only σ against
                    # the primary's composite would bias adoption
                    # toward the deramped set and under-report the
                    # adopted ellipse.
                    std2 = np.sqrt(
                        (r2.delay_std.cpu().numpy().astype(np.float64)
                         / cfg.sample_rate) ** 2
                        + ref_var_s2
                    )
                    fix2 = solve_fix(
                        lla,
                        corrected2 / cfg.sample_rate,
                        weights=w2,
                        pair_idx=pairs,
                        solve_z=cfg.solve_z,
                        tdoa_sigma_s=std2,
                        device=self.device,
                    )
                    # Adopt when the deramp demonstrably SHARPENED the
                    # measurement (median per-pair σ). The residual test
                    # alone is a coin flip at 3 stations — 3 TDOAs always
                    # fit 2 unknowns with near-zero residual, smeared or
                    # not. The σ test is the physical one: deramping
                    # re-concentrates the correlation peak, and a failed
                    # deramp (wrong per-station Doppler solve) leaves σ
                    # large. A residual win may still adopt, but only when
                    # σ did not materially degrade (≤1.5×) — otherwise a
                    # failed deramp that wins the residual coin flip would
                    # slip through.
                    med, med2 = np.median(tdoa_std_s), np.median(std2)
                    if (med2 <= med
                            or (fix2.rms_residual_m <= fix.rms_residual_m
                                and med2 <= 1.5 * med)):
                        # Adopt the deramped measurement WHOLESALE so the
                        # reported fields stay mutually consistent
                        # (delays, qualities, sigmas, weights, fix).
                        fix = fix2
                        tgt_d = r2_delay
                        corrected = corrected2
                        tdoa_s = corrected / cfg.sample_rate
                        q = q2
                        w = w2
                        tdoa_std_s = std2
                        echo_win = r2.corr.cpu().numpy().astype(np.float64)
                        deramp_note = " even after Doppler deramp"
                        warnings.append(
                            "significant differential Doppler (up to "
                            f"{np.abs(nu).max():.1f} Hz — emitter motion "
                            "and/or receiver LO offset): TDOAs re-"
                            "measured by deramp-and-correlate and the "
                            "position re-solved"
                        )
        # Lobe-shape verdict, now that motion is ruled in or out: a
        # smeared mover's plain window is EXPECTED to be distorted
        # whether or not the deramp re-solve was adopted (the σ gate
        # can reject it without making the distortion multipath), and
        # a resolvable second source already set secondary_fired (in
        # any multi_emitter mode) — otherwise a drifting centroid is
        # the only trace an in-peak echo leaves.
        multipath_flagged = None
        multipath_sigma = None
        echo_sep = None
        echo_ratio = None
        echo_env_confirmed = False
        if cfg.mode == "iq" and cfg.multipath_mitigation:
            with stage("multipath"):
                # Honest echo-bias accounting, CONTINUOUS (not gated on the
                # warning threshold): the centroid-offset statistic maps
                # each pair's lobe contamination to a calibrated σ addend,
                # plus a scene floor once any pair confirms an echo
                # environment (dsp/multipath.py echo_bias_sigma — the
                # calibration table and the measured evidence that delay
                # RE-ESTIMATION is worse than the plain GCC-HT read live
                # there). Clean scenes stay untouched (offset < knee).
                # Runs UNCONDITIONALLY on ``echo_win`` — the reported
                # measurement's windows — because the statistic is
                # self-gating (clean lobes sit under the knee) while the
                # old motion/secondary stand-down gates silenced it on
                # exactly the scenes that needed it (round-4 calibration:
                # 2 of 3 uncovered multipath tail trials were strong
                # echoes whose 60%+ secondary peaks fired secondary_fired,
                # which then suppressed the σ accounting on the reported
                # single-emitter fix). An adopted deramp reads the
                # DERAMPED windows, where a true mover's lobes are clean
                # (offset ~0 ⇒ no inflation) and only genuine echo drag
                # survives; a non-adopted deramp reports the plain set, so
                # its plain-window drag — echo or residual motion smear —
                # belongs in the reported error budget either way. A
                # co-channel source OUTSIDE the lobe (distinct peak beyond
                # ±60 lags) leaves the centroid alone; one inside it drags
                # the reported fix exactly like an echo and is covered the
                # same way.
                from tdoa_tpu_torch.dsp.multipath import (
                    _ECHO_ENV_THRESHOLD,
                    REF_ECHO_CONSISTENCY_THRESHOLD,
                    echo_bias_sigma,
                    lobe_centroid_offset,
                    mitigate_flagged_pairs,
                    ref_lobe_echo_consistency,
                )

                # Environment confirmation for the σ floor: the drift
                # statistic on the SAME windows the offset reads (equal to
                # lobe_drift unless a deramp adoption swapped the windows).
                drift_echo = (
                    lobe_drift if echo_win is win64
                    else _lobe_centroid_drift(echo_win)
                )
                off_echo = (
                    lobe_offset if echo_win is win64
                    else lobe_centroid_offset(echo_win)
                )
                # Third, INDEPENDENT confirmation lane (round 5): dual-REF
                # lobe-shape consistency. A static station-local reflector
                # marks BOTH REF blocks' lobes the same way (~1/3 capture
                # apart) while noise jitter is independent between them —
                # this sees echo environments whose TGT statistics stay
                # inside clean ranges (the invisible-echo class; 14% of it
                # detected at zero false positives over 80 clean scenes,
                # REFECHO_PROBE.json). Premise: the reflectors are
                # station-local, so the REF channel traverses them too.
                s_ref = ref_lobe_echo_consistency(
                    win_c_blocks[0], win_c_blocks[2])
                ref_echo_env = bool(
                    s_ref.size
                    and float(s_ref.max()) > REF_ECHO_CONSISTENCY_THRESHOLD
                )
                # Scene-level echo-environment confirmation: any lane over
                # its threshold. Drives the σ floor here AND the heavy-tail
                # contour scales below.
                echo_env_confirmed = bool(
                    (drift_echo.size and float(drift_echo.max()) > 1.0)
                    or (off_echo.size
                        and float(off_echo.max()) > _ECHO_ENV_THRESHOLD)
                    or ref_echo_env
                )
                mp_sigma = echo_bias_sigma(
                    off_echo,
                    env_confirmed=bool(
                        drift_echo.size and float(drift_echo.max()) > 1.0
                    ) or ref_echo_env,
                )
                if ref_echo_env:
                    k_r = int(np.argmax(s_ref))
                    i_r, j_r = pairs[k_r]
                    warnings.append(
                        f"REF-block lobes carry a consistent echo signature "
                        f"(dual-REF centroid consistency "
                        f"{float(s_ref.max()):.2f} > "
                        f"{REF_ECHO_CONSISTENCY_THRESHOLD} on "
                        f"{names[i_r]}-{names[j_r]}): station-local "
                        f"multipath environment — echo-bias σ floor "
                        f"applied to every pair"
                    )
                if np.any(mp_sigma > 0):
                    multipath_sigma = mp_sigma
                    # Pre-inflation noise σ: the independent part of the
                    # station-correlated covariance rebuilt after
                    # _analyze_fix (the echo part enters through the
                    # per-station bias model there, not this diagonal).
                    tdoa_noise_s = tdoa_std_s.copy()
                    tdoa_std_s = np.sqrt(
                        tdoa_std_s ** 2 + (mp_sigma / cfg.sample_rate) ** 2
                    )
            if multipath_sigma is not None:
                with stage("re-solve (echo-bias σ)"):
                    fix = solve_fix(
                        lla, tdoa_s, weights=w, pair_idx=pairs,
                        solve_z=cfg.solve_z, tdoa_sigma_s=tdoa_std_s,
                        device=self.device,
                    )
        if (not motion_detected and not secondary_fired
                and np.max(lobe_drift) > 1.0):
            with stage("multipath"):
                k_d = int(np.argmax(lobe_drift))
                i_d, j_d = pairs[k_d]
                flagged = lobe_drift > 1.0
                multipath_flagged = flagged.copy()
                n_d = int(np.count_nonzero(flagged))
                # Diagnose the flagged lobes: the two-path decomposition's
                # SEPARATION and amplitude ratio are template-bias-free
                # (differences), so they reliably measure the echo's
                # geometry even though its absolute positions must not
                # replace the TDOA (dsp/multipath.py evidence table).
                fits = [None] * len(pairs)
                if cfg.multipath_mitigation:
                    cx = win_c_blocks.astype(np.complex128)
                    _, _, fits = mitigate_flagged_pairs(
                        cx[1], flagged, q, lobe_drift, cfg.max_lag,
                        ref_win_c=cx[[0, 2]],
                    )
                detail = []
                for k in np.flatnonzero(flagged):
                    fit = fits[k]
                    if fit is None or not fit.decisive:
                        continue
                    if echo_sep is None:
                        echo_sep = np.full(len(pairs), np.nan)
                        echo_ratio = np.full(len(pairs), np.nan)
                    echo_sep[k] = fit.separation
                    echo_ratio[k] = fit.echo_ratio
                    excess_km = (fit.separation / cfg.sample_rate
                                 * SPEED_OF_LIGHT / 1000.0)
                    detail.append(
                        f"{names[pairs[k][0]]}-{names[pairs[k][1]]}: echo "
                        f"{fit.separation:.1f} samples (~{excess_km:.1f} km "
                        f"excess path) at {fit.echo_ratio:.2f} relative "
                        f"amplitude"
                    )
                sigma_note = (
                    "the error budget carries the calibrated echo-bias σ "
                    "(multipath_sigma_samples) and the position was "
                    "re-solved with it"
                    if multipath_sigma is not None
                    else "enable multipath_mitigation to fold the "
                         "calibrated echo-bias σ into the error budget"
                )
                diag_note = (
                    " — two-path diagnosis: " + "; ".join(detail)
                    if detail else ""
                )
                warnings.append(
                    f"correlation main lobe is asymmetric on "
                    f"{n_d}/{len(pairs)} pairs (worst {names[i_d]}-"
                    f"{names[j_d]}, centroid drift "
                    f"{lobe_drift[k_d]:.1f} samples): in-peak multipath "
                    f"echo (or uncompensated emitter motion — rerun with "
                    f"--solve-velocity); {sigma_note}{diag_note}"
                )
        # The TDOA set is final now (plain or deramp-adopted): run the
        # consistency gate, outlier rejection, ghost/prior/power
        # analysis, and the out-of-prior warning on what will actually
        # be reported.
        with stage("analyze"):
            fix, w, excluded_stations, ghost_verdict = self._analyze_fix(
                fix, w, tdoa_s, tdoa_std_s, names, pairs, lla, tgt, ref1,
                warnings, deramp_note=deramp_note,
                # Only Doppler the CAF deemed significant (> 2 grid bins —
                # the same adaptive gate as the deramp decision) may rank
                # ghost candidates: below it the "measured" Doppler is
                # sub-bin interpolation noise and any verdict from it would
                # be noise-driven.
                fdoa_hz=nu_emitter if motion_detected else None,
            )

        if cfg.solve_velocity:
            with stage("velocity"):
                # Velocity at the (possibly re-solved) fix, in the solver's
                # own ENU frame. Weights: the post-analysis w — the deramped
                # qualities when adopted (the smeared plain correlation's
                # qualities systematically zero the highest-Doppler pairs),
                # with any outlier station's pairs zeroed.
                st_v = lla_to_enu(lla, fix.origin_lla)
                vsol = solve_velocity_enu(
                    st_v, pairs, fix.enu, nu_emitter, cfg.tgt_freq,
                    weights=w, solve_z=cfg.solve_z,
                    # σ floor: ~1/8 Doppler bin (sub-bin parabolic
                    # interpolation accuracy) — with barely more pairs than
                    # unknowns the fit residual underestimates.
                    fdoa_sigma_floor_hz=bin_hz / 8.0,
                )
                velocity_enu = vsol.vel_enu
                velocity_residual_hz = vsol.residual_hz
                velocity_sigma = vsol.sigma_enu
                fdoa_out = nu_emitter
                # Plausibility check (a warning, not a gate): an FDOA set
                # mixing two co-channel emitters (or reading a ghost
                # geometry) "fits" only with an absurd velocity. Flag it so
                # a mixed-emitter lock is never silent.
                spd = float(np.linalg.norm(velocity_enu))
                sig_h = float(np.linalg.norm(velocity_sigma[:2]))
                if spd > cfg.max_emitter_speed_mps or (
                    sig_h > cfg.max_emitter_speed_mps / 2.0
                ):
                    warnings.append(
                        f"velocity estimate implausible "
                        f"({spd:.0f} m/s, 1σ {sig_h:.0f} m/s vs the "
                        f"{cfg.max_emitter_speed_mps:.0f} m/s emitter "
                        f"ceiling): the FDOA set likely mixes "
                        f"co-channel emitters or reads a ghost "
                        f"geometry — treat the fix and velocity with "
                        f"suspicion"
                    )
                if cfg.multi_emitter > 1:
                    # Kept for joint (lag, Doppler) association; the host
                    # copy of the surface is only paid when the
                    # multi-emitter branch will actually read it.
                    caf_info = {
                        "surface": caf.surface.cpu().numpy().astype(np.float64),
                        "max_lag": caf_max_lag,
                        "span_hz": cfg.sample_rate / (2.0 * seg_r),
                        "bin_hz": bin_hz,
                        "lim": lim,
                    }

        emitters: Optional[List[EmitterFix]] = None
        if cfg.multi_emitter > 1:
            with stage("associate+solve-emitters"):
                emitters = self._separate_emitters(
                    caf_info, clock, lla, pairs, names, drift_ppm, lo_ppm,
                    win64, tdoa_std_s, tgt, warnings)

        # The fix's covariance is rebuilt last: velocity and the
        # emitters read no covariance.
        with stage("assemble"):
            if multipath_sigma is not None and fix.cov_en is not None:
                # Fix-level echo covariance (round-4): echo biases live at
                # STATIONS, so pairs sharing one are correlated — the
                # independent per-pair model's multipath fix coverage sat
                # at 72.7% 3σ while per-pair coverage was 95-96%.
                # Apportion the calibrated per-pair σ addends to
                # per-station biases (σ_pair² ≈ τ_i² + τ_j²) and
                # rebuild the FINAL fix's covariance (post ghost
                # swaps/exclusions, final weights) with the sandwich
                # model; every internal re-solve keeps the cheap
                # independent model — only the reported ellipse changes.
                from tdoa_tpu_torch.dsp.multipath import (
                    STATION_BIAS_FIX_INFLATION,
                    STATION_BIAS_FIX_INFLATION_CONFIRMED,
                    station_bias_apportion,
                )
                from tdoa_tpu_torch.solve.multilateration import (
                    error_ellipse,
                    fix_covariance_enu_correlated,
                )

                # One γ for every echo-engaged fix (round-5: the two tiers
                # are equal — the maha tail lives in the UNCONFIRMED class,
                # so a confirmed-only inflation could never reach it; the
                # tail is covered by conf_scales below instead).
                tau_m = (
                    (STATION_BIAS_FIX_INFLATION_CONFIRMED
                     if echo_env_confirmed else STATION_BIAS_FIX_INFLATION)
                    * station_bias_apportion(pairs, len(names),
                                             multipath_sigma)
                    / cfg.sample_rate * SPEED_OF_LIGHT
                )
                cov_mp = fix_covariance_enu_correlated(
                    lla_to_enu(lla, fix.origin_lla), pairs, fix.enu,
                    tdoa_noise_s * SPEED_OF_LIGHT, tau_m, weights=w,
                )
                if np.all(np.isfinite(cov_mp)):
                    from tdoa_tpu_torch.dsp.multipath import (
                        ECHO_TAIL_CONF_SCALES,
                    )

                    fix = dataclasses.replace(
                        fix, cov_en=cov_mp, ellipse=error_ellipse(cov_mp),
                        # EVERY echo-engaged fix carries the calibrated
                        # heavy-tail contour scales: the kσ confidence
                        # contour is the k·s_k ellipse. A single Gaussian
                        # scale cannot calibrate both the echo-bias median
                        # and its tail, and the tail's worst rows are the
                        # UNCONFIRMED ones (TGT statistics under the env
                        # thresholds) — so the scales must not be gated on
                        # confirmation (round-5 fit, MULTIPATH_CAL_r05).
                        conf_scales=ECHO_TAIL_CONF_SCALES,
                    )

            self.ingest_diag["lm_launches"] = (lm_solve.launches
                                               - lm_launches)
            return TDOAResult(
                fix=fix,
                station_names=names,
                pair_idx=pairs,
                tgt_delay_samples=np.asarray(tgt_d, np.float64),
                ref_delay_samples=ref_d,
                clock_offset_samples=np.asarray(clock, np.float64),
                corrected_tdoa_samples=corrected,
                tdoa_seconds=tdoa_s,
                quality=q,
                peak_value=np.asarray(peaks[1], np.float64),
                tdoa_std_s=tdoa_std_s,
                clock_drift_ppm=drift_ppm,
                warnings=warnings,
                emitters=emitters,
                velocity_enu=velocity_enu,
                velocity_residual_hz=velocity_residual_hz,
                velocity_sigma_enu=velocity_sigma,
                fdoa_hz=fdoa_out,
                excluded_stations=excluded_stations or None,
                solve_weights=np.asarray(w, np.float64),
                multipath_flagged=multipath_flagged,
                multipath_sigma_samples=multipath_sigma,
                multipath_echo_separation_samples=echo_sep,
                multipath_echo_ratio=echo_ratio,
                ghost=ghost_verdict,
            )

    def process_files(self, dat_paths: Sequence[str]) -> TDOAResult:
        """Load ``.dat`` files (station identity from filenames) and
        process them."""
        return self.process_captures(self.load_files(dat_paths))

    def tail_session(
        self, station_names: Sequence[str], block_len: int,
        chunk_samples: Optional[int] = None,
    ):
        """Create a ``pipeline.ingest.TailIngest`` session for a
        growing capture window over these stations — pair basis,
        REF-transmitter geometry, correlator settings and device all
        taken from this processor, so ``process_captures(...,
        tail=session)`` is numerically the processor's own host-mode
        path. The station order is normalized (sorted) to match the
        stream service's window grouping; build the captures dict in
        ``session.names`` order at finalize time."""
        from tdoa_tpu_torch.pipeline.ingest import TailIngest

        cfg = self.config
        names = sorted(station_names)
        pairs = station_pairs(len(names))
        bl = int(block_len)
        if cfg.truncate_samples is not None:
            bl = min(bl, cfg.truncate_samples)
        return TailIngest(
            names,
            pairs,
            self._ref_geo_tdoa_samples(names, pairs),
            block_len=bl,
            capture_block_len=int(block_len),
            max_lag=cfg.max_lag,
            seg_len=cfg.seg_len,
            weighting=cfg.weighting,
            clock_correction=cfg.clock_correction,
            chunk_samples=chunk_samples,
            accumulator=cfg.accumulator,
            device=self.device,
        )

    def _stations_of(self, dat_paths: Sequence[str]) -> List[str]:
        """The station of each capture file, from its name; raises
        ``FileNotFoundError`` for a missing file and ``ValueError`` for a
        name that matches no station or a second file of one station."""
        known = self.stations.names
        stations: List[str] = []
        for path in dat_paths:
            if not os.path.exists(path):
                raise FileNotFoundError(f"capture file not found: {path}")
            st = station_from_filename(path, known)
            if st is None:
                raise ValueError(
                    f"cannot infer station from filename: {path} "
                    f"(known stations: {', '.join(known)})"
                )
            if st in stations:
                raise ValueError(
                    f"two capture files resolve to station '{st}' "
                    f"(second: {path}); pass one file per station"
                )
            stations.append(st)
        return stations

    def process_files_overlapped(
        self, dat_paths: Sequence[str]
    ) -> TDOAResult:
        """Like process_files, but the captures stay HOST-resident and
        stream to the device chunk by chunk, the file read, the copy and
        the accumulation overlapped (pipeline/ingest.py). Files are
        mmap'ed read-only — peak host memory is O(chunk), not
        O(capture). Standard IQ path only (fm/LO-compensation/velocity/
        multi-emitter need whole blocks on device and raise)."""
        self.ingest_diag.clear()
        captures: Dict[str, HostCapture] = {}
        with self._stage("mmap"):
            for st, path in zip(self._stations_of(dat_paths), dat_paths):
                raw = np.memmap(path, dtype=np.uint8, mode="r")
                if raw.size < 6:
                    raise ValueError(f"capture too short: {path}")
                captures[st] = HostCapture(
                    u16=iq_bytes_as_u16(raw[: (raw.size // 2) * 2]),
                    block_len=raw.size // 2 // 3,
                )
        res = self.process_captures(captures)
        with self._stage("unmap"):
            captures.clear()  # the last references to the mmaps
        return res

    def load_files(
        self, dat_paths: Sequence[str]
    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Load ``.dat`` files into {station: (ref1, tgt, ref2)} planar
        blocks on the processor's device: bf16, the fused kernels'
        operand storage, when they will run (the ``_fused_eligible``
        predicate of process_captures' accumulator="auto" decision, with
        the block length from the file size: 3 blocks × 2 bytes per
        sample), else f32.

        On a card the files are read in chunks through the processor's
        pinned ring (``load_window``): its reader threads read the
        window's chunks at once, in file order, each chunk's copy
        enqueued behind its read and each file's decode behind its
        copies; the host waits for the last copy at the end. The ring,
        its readers and their slots are made by the first such window
        and reused after."""
        cfg = self.config
        self.ingest_diag.clear()
        block_samples = [os.path.getsize(p) // (2 * 3)
                         for p in dat_paths if os.path.exists(p)]
        if cfg.truncate_samples is not None:
            block_samples = [min(b, cfg.truncate_samples)
                             for b in block_samples]
        fused = (
            cfg.accumulator in ("auto", "pallas")
            and bool(block_samples)
            and self._fused_eligible(len(set(dat_paths)), min(block_samples))
        )
        dtype = torch.bfloat16 if fused else torch.float32
        captures: Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
        with self._stage("load+decode"):
            stations = self._stations_of(dat_paths)
            if self.device.type == "cuda" and self._ring is None:
                self._ring = _ChunkRing(self.device)
            for cap in load_window(dat_paths, stations, dtype, self.device,
                                   self.ingest_diag, self._ring):
                captures[cap.station] = (cap.ref1, cap.tgt, cap.ref2)
        return captures
