#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tdoa_tpu_torch``) on one H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel3-only   # phases 1-2 and kernel 3 alone

Phases, each printing its own lines; any failure exits non-zero:

1. device  — CUDA with compute capability 9.0, versions, card name and
             power limit, TF32 off;
2. build   — the four hand-written kernels from ``tdoa_tpu_torch/csrc/``
             (one nvcc per source, started together);
3. kernels — each kernel against its plain torch version on the card
             (kernel 1, one item's accumulators a CTA while the
             segments stream past: 3 stations, K = 4, DC sums on, bf16,
             at 16 segments and at a 10 s block's 443 segments, and 12
             stations × 5 segments × K = 2, and at the streaming
             shapes: one bank over 96 segments and over 59 segments (a
             capture's short last chunk), each on the overlapped
             ingest's 9 rows and on a tail session's 3; at phase 11's
             shapes: 12 stations × 443 segments × K = 4 (66 pairs in one
             launch at full length; also forced into 2 tiles, bitwise
             the single launch), 16 and 24 stations
             pair-tiled (2 and 6 launches), and the overlapped ingest's
             stacked rows of 12, 16 and 24 stations (198, 360 and 828
             pairs: a launch per 12-row block, 2 tiles per 16-row
             block, 6 per 24-row block) at 96 and 59 segments, K = 1;
             14 stations × 443 segments × K = 4 (2 tiles); the sharded
             step's 36 stacked f32 rows of 12 stations (a launch per
             12-row block) at a 2-rank chunk's 220 segments, one bank,
             and at its comparator's 440 segments, K = 4; at phase 12's
             (a 100 s block: 1479 segments): 3 and 12 stations × K = 4,
             and the block's
             short last chunk of 39 segments on 9 and 3 rows and on 12
             stations' 36 stacked rows; 24 stations × K = 4 (6 tiles)
             and the last chunk on their 72 stacked rows (18 launches);
             the sharded step's f32 chunks of 9 rows on whole 100 s
             blocks (1479, 739 and 369 segments, one bank) and its
             comparators (1479, 1478 and 1476 segments, K = 4);
             launches are counted
             by (rows, segments, banks, pairs) and no path may launch it
             at a shape not checked here; kernel 2: K = 4,
             m = 3, F = 65536 on the 443-segment banks, and the
             segmented path's 9 pairs of 9 channels, and m = 66, 120,
             276 (phase 11's batch banks) and 198, 360, 828 (its
             overlapped paths'), 91 and 273 (14 stations, kernel and
             segmented routes), and (K = 2, m = 198) (the 12-station
             sharded step's 2 rank groups); kernel 3: 9
             channels × 20 M samples, D = 8, then 3 channels × 2 M
             samples on rows that are not 16-byte aligned, its scalar
             loads, and at D = 16; and 4 channels × 20 M samples, D = 8,
             the audio match's stations and template; 9 channels ×
             66,666,666 samples, D = 8, the FM path's 100 s blocks (rows
             off the 16-byte grid), and 4 channels of them, the audio
             match's; no path may
             launch it at a shape not checked here); kernel 4 (the LM
             solve) at the cells' solves, 9 starts in 2D over 3 and 276
             pairs (3 and 24 stations; every start that both versions
             converge within 0.5 m and 0.05 m rms), each launched twice
             on the same input (the outputs must be bitwise equal), then
             each timed at the main path's shapes beside its bound (bytes
             over 3.35 TB/s or f32 operations over 67 TFLOP/s, the
             larger): CUDA events around a loop of wrapper calls
             (``ms``, the host's share included where it is the slower
             side), and the kernel's own device time per call from
             ``torch.profiler`` (``device_ms``; kernel 1's two stages
             summed); kernel 4 also as the whole ``solve_fix``, beside
             the plain loop's ``solve_fix`` on the CPU (host clock);
4. slice   — a synthesized 3-station 30 s capture (three 10 s blocks of
             20 M samples, ``lat-lon-table.csv`` geometry, an FM-like
             source, per-station clock offsets, noise) written as u8
             ``.dat`` files and run through ``TDOAProcessor.process_files``
             on three paths, each run twice (warm-up, then timed with
             every launch count set to 0 just before it; each path's
             solves launch kernel 4):
             the fused IQ path (kernels 1 and 2; within 0.5 sample /
             200 m of the truth), ``accumulator="xla"`` (the segmented
             correlator and kernel 2, not kernel 1; 0.5 sample / 200 m)
             and ``mode="fm"`` (kernel 3; 16 samples / 4 km);
5. overlap — the same files through ``process_files_overlapped`` (warm-up,
             then timed beside a batch run: within 0.5 sample / 200 m of
             the truth and 0.05 sample of phase 4's fused result, one
             launch of kernel 1 per planned chunk, every σ > 0); the
             streaming loop alone under
             ``torch.cuda.set_sync_debug_mode("error")`` (no chunk makes
             the host wait for the card), its state through ``acc_save``
             and ``acc_load`` to a bitwise-equal finalize; and a
             ``TailIngest`` session fed the files in ten growth steps
             (every chunk within the first nine tenths dispatched before
             the last tenth lands), finished by
             ``process_captures(caps, tail=session)`` to the same bounds;
6. motion  — two more full-width scenes, made the way the JAX package's
             simulator makes them (``sim/scene.py``, ``sim/delay.py``:
             each delay rate α turns the carrier by exp(−j2π f α (t −
             t_mid)), the envelope sits at the block midpoint's delay):
             (a) per-station receiver LO errors of a few tenths of a ppm
             (a drifting clock: a delay rate on every block) and a
             130 m/s mover on TGT, run with ``lo_compensation="auto",
             solve_velocity=True`` (TDOAs within 0.5 sample of the
             midpoint geometry, fix within 200 m, velocity within 5 m/s
             and 5σ + 1 m/s per axis, FDOA within 1 Hz of the planted
             Doppler, the deramp re-solve taken); (b) a mover and an
             equal-power static co-channel interferer, run with
             ``solve_velocity=True, multi_emitter=2`` (two emitters, each
             fix within 1000 m of its own truth, the mover's velocity
             within 10 m/s, the static one's within 3σ + 2 m/s of zero).
             Beside them, printed and not asserted: each option alone
             (LO compensation, velocity without it, the lag-only
             multi-emitter route). Every setting is timed in turns with
             the plain fused path on the same files, with its stages.
             Kernel 2 is held to the shapes phase 3 checked, by
             ``(K, m, F)``, as kernel 1 is. Last, the CAF, a block's
             derotation and the deramp re-correlation are timed alone
             at the processor's shapes;
7. audio   — scenes made by the port's own simulator on the card
             (``tdoa_tpu_torch/sim``): (a) a known-audio scene (the TGT
             emitter broadcasts a 10 s, 44.1 kHz recording of 10 kHz
             band-limited noise, FM at 50 kHz deviation; the recording
             written as a WAV), its ``.dat`` files through
             ``match_captures`` in the audio, rf and auto modes at the
             reference tests' ``max_lag`` 1024 and an LO span of ±1.5 Hz
             (``AM_LO_SPAN``; the default ±200 Hz printed beside)
             (corrected TDOAs within 4
             samples of the truth and of the pairwise pass, the audio
             fix within 4 km, auto staying audio; kernel 1 three times,
             kernel 3 once at 4 × 20 M where the audio domain runs, never
             in the rf domain), timed in turns with ``process_files``
             with stage times; the audio_match CLI on the same files
             (its TDOAs within 1e-6 µs of the in-process run) and at its
             defaults (printed); the rf domain's peak memory and the
             CAF's device time over the 10 s block; (b) an FM-threshold
             scene in memory (auto within 4 samples); (c) the simulator
             CLI's 30 s files through the processor CLI (0.5 sample,
             200 m) and the caf_search CLI (0.5 sample, 1 Hz);
8. tools   — the capture-quality and station tools on phase 4's files
             and on impaired copies of the first (TGT clipped, a dead
             station, +12 bytes of DC on I, the second REF block at a
             quarter of the power, the file one byte short):
             ``analyze_capture`` (2^21 samples a block, and the whole
             10 s block) and ``validate_dat_structure`` on the card and
             on the CPU (byte fractions, min/max bytes and flags equal,
             DC within 1e-3 bytes, power within 1e-5 relative, SNR within
             1e-2 dB, or above 120 dB on both for a dead block, whose
             noise bins hold only FFT rounding; every planted impairment
             reported by its own problem line or flag), each pass timed
             (median of 5 warm runs, the profiler's device time beside);
             the analyzer, fast_analyzer and reader CLIs in their own
             processes (exit codes); the gain calibrator against the
             simulated receiver on the card and the CPU (the same gain
             history, both frequencies converged); every station tool's
             CLI in this process, warm (median of 5): analyzer,
             fast_analyzer, reader, gain_calibrator, a 30 s ``collector
             --backend sim`` window (written and validated), simple_corr
             and correlation_sanity (PASS), coverage, snr_analysis; the
             processor CLI's ``--profile`` (a stage report with
             load+decode, correlate+clock, solve) and ``--trace DIR``
             (kernels 1 and 2 as device events in the trace), each
             launching kernels 1 and 2 three times at shapes phase 3
             checked, and its capture→fix with and without ``--profile``
             in turns;
9. sharded — the sequence-parallel step (``tdoa_tpu_torch/parallel``)
             on phase 4's files, each block cut to its first 440 kernel
             segments (f32, divisible over 1, 2 and 4 ranks): worlds of
             1 rank (NCCL) and of 2 and 4 ranks sharing the card (gloo
             on CUDA tensors), each started by ``parallel.launch.spawn``
             and running the kernel route (kernel 1 on every rank's
             chunk) and the segmented route (a warm-up, then a timed run
             with the counts set to 0 just before it): corrected TDOAs
             within 1e-3 sample of the unsharded path on the same
             capture and 0.5 sample of the truth, each rank's wall time
             and peak memory, kernel launches gathered from the ranks;
             then ``parallel.dryrun`` on the 4-rank world (meshes of 2
             and 4 ranks, 3 and 5 stations, within 1e-3 sample of one
             device). The kernels' shapes here (f32 single-bank chunks
             of 9 rows, kernel 2 on 2 rank groups, the dry run's) are
             checked in phase 3;
10. calibration — the gates of ``scripts/monte_carlo_torch.py`` (every
             regime, 2 trials, its floor, no silent failure) and of
             ``scripts/ellipse_calibration_torch.py`` (4 trials of each
             gated regime, pooled 3σ coverage ≥ 90 %) on the card, at
             the scripts' own seeds; the trials' kernel shapes (kernel 2
             on the segmented route's banks — their 2^17- and
             2^18-sample blocks hold fewer than the 8 kernel segments
             the kernel route needs — and kernel 3 on the audio-match
             trial's 4 × 2^17) are checked in phase 3; then a reduced
             pass of ``scripts/ghost_calibration_torch.py`` (``gather``
             at 1 trial a ghost regime, ``validate`` on those records:
             printed, not gated at that size) and of
             ``scripts/multipath_tailcal_torch.py`` (``capture`` of 2
             multipath trials, read back; ``fit`` over the repository's
             ``calib_data/mp_base_*.npz``, which must reproduce
             ``MULTIPATH_CAL_r05.json``);
11. network — a 12-station 30 s scene (the 5 stations of
             ``tests/test_multistation.py`` and 7 more within ~25 km, a
             CSV in the temp directory, each station's own clock
             offset, st4's TGT block delayed 160 samples: the reference
             test's planted outlier) written as u8 ``.dat`` files:
             ``process_files`` (warm-up, then timed; st4 the one station
             excluded, every clean pair's corrected TDOA within 0.5
             sample of the truth, the fix within 200 m; the host's
             leave-stations-out re-solves timed) and
             ``process_files_overlapped`` (within 0.05 sample of the
             batch result, kernel 1 on the stacked rows); a
             ``TailIngest`` session on the same files fed in ten growth
             steps and finished by ``process_captures(caps,
             tail=session)`` (st4 alone excluded, within 0.05 sample of
             ``process_files``, every chunk within the first nine tenths
             dispatched before the last tenth lands, last byte → fix
             timed); the sharded step on the files' first 440 kernel
             segments in a world of 2 gloo ranks on the card, kernel
             route, within 1e-3 sample of the unsharded path on the same
             blocks; 14 stations (2 tiles a block) through
             ``process_blocks`` once on each route, within 0.5 sample of
             the planted delays; then the station sweep's (``scripts/station_sweep_torch.py``) 16-
             and 24-station ``process_blocks`` once each (kernel 1
             pair-tiled, within 0.5 sample of the planted delays), the
             route and tiles printed, and the same blocks as u8 I/Q
             through ``ingest_overlapped`` (warm-up, then timed; kernel
             1 on every block's tiles of the stacked rows, within 0.05
             sample of ``process_blocks`` on the same bytes);
12. window — the collector's longest window, 100 s (``cli/collector.py``'s
             MAX_DURATION_S: three blocks of 66,666,666 samples, 1479
             whole kernel segments each): ``dsp.fm.running_sum`` over a
             block (two calls bitwise equal, within float32 rounding of
             float64); a synthesized 3-station capture written as
             ``.dat`` files through phase 4's three paths (the same
             bounds), the processor CLI in this process (0.5 sample, 200
             m), ``process_files_overlapped`` (16 chunks: 15 of 96
             segments and one of 39; 0.05 sample of the fused result)
             and a tail session in ten growth steps (last byte → fix);
             the collector CLI at ``--duration 100`` (``--backend sim``,
             one call a station) and ``process_files`` on its three
             files (0.5 sample, 200 m of the simulator's truth), and the
             stream service over their directory with ``--watch
             --overlap-ingest 100`` (a tail session; fix 200 m); phase
             11's 12-station scene over 100 s, its bytes in host memory:
             the batch kernel route (decoded on the card as
             ``load_files`` decodes) and the overlapped ingest (st4
             alone excluded, clean pairs 0.5 sample, fix 200 m, the
             overlapped result within 0.05 sample of the batch one).
             Then the window's scenes: (A) the network extended to 24
             stations, its bytes in host memory: the batch route's
             verdict (each route's reckoned memory) printed, the batch
             kernel route with the outlier rejection (its host
             re-solves timed), the overlapped ingest and a tail session
             in ten growth steps (the same bounds); (B) phase 6's
             scenes (a) and (b) through ``process_files`` at its checked
             settings and bounds (stage times), and ``_derotate`` of one
             block alone (its peak memory); (C) phase 7's known-audio
             scene (a 33.75 s recording) through ``match_captures`` in
             every mode and the audio_match CLI at phase 7's bounds
             (the LO span scaled to the block), the domains' device
             time and memory, the template's f32 phase within 1e-2 rad
             of float64; (D) phase 9 on the 3-station capture's whole
             blocks: worlds of 1, 2 and 4 ranks on both routes, each
             within 1e-3 sample of the unsharded path on the samples
             its chunk plan keeps and 0.5 sample of the truth.
             Each path a warm-up and a timed run; capture→fix, last
             byte → fix and peak device memory per route printed.

The last two lines are the card's ``nvidia-smi`` name and power limit,
then ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent

SEED = 1234
FS = 2_000_000.0
BLOCK = 20_000_000  # 10 s at 2 Msps
CLOCK_OFFSETS_S = (12e-6, -31e-6, 48e-6)  # 24 / -62 / 96 samples
K1_TOL = 1e-4  # relative to each row's peak magnitude
K2_TOL = 2e-3  # samples
K3_TOL = 2e-4  # audio, absolute (tests/test_pallas_fm.py's tolerance)
FM_DECIM = 8
# Kernel 1's launches are counted by (rows, segments, banks, pairs):
# its shape on the batch path, and its streaming shapes: a default chunk
# and a 10 s block's short last chunk (443 = 4·96 + 59), each over the
# stacked 9 rows of the overlapped ingest and over the 3 rows of a tail
# session's block.
BATCH_SHAPE = (3, 443, 4, 3)
STREAM_SHAPES = ((9, 96, 1, 9), (9, 59, 1, 9), (3, 96, 1, 3),
                 (3, 59, 1, 3))
# Kernel 2's shapes (banks, pairs, FFT length): the split-σ probes of
# the fused path, the LO probe's coarse pre-alignment and the deramp
# re-correlations over 2^21 samples (3 pairs), of the segmented and
# overlapped paths' stacked blocks (9 pairs), and of a deramp over 2^18
# samples at max_lag 512 (8 segments of 32256 in FFTs of 32768).
K2_SHAPES = ((4, 3, 65536), (4, 9, 65536), (4, 3, 32768))
# Phase 9, the sequence-parallel step on phase 4's capture truncated to
# 440 kernel segments (divisible over 1, 2 and 4 ranks), f32: kernel 1
# on each rank's chunk of the 9 stacked rows (one bank, no DC sums) and
# on the unsharded comparator's K = 4 banks; kernel 2 on 2 rank groups
# (4 groups: K2_SHAPES). ``parallel.dryrun`` at 4 ranks: kernel 1 on one
# segment a rank and on its comparator's 4 segments in 2 banks; kernel 2
# on the segmented route's 1024-point spectra (3 and 5 stations, 3
# blocks) and on 2 groups of the 3 kernel-route pairs.
SHARD_SEGS = 440
SHARD_K1_SHAPES = ((9, 440, 1, 9), (9, 220, 1, 9), (9, 110, 1, 9),
                   (9, 440, 4, 9))
DRYRUN_K1_SHAPES = ((3, 1, 1, 3), (3, 4, 2, 3))
SHARD_K2_SHAPES = ((2, 9, 65536), (2, 9, 1024), (4, 9, 1024),
                   (4, 30, 1024), (2, 3, 65536))
# Phase 10, the calibration trials: on their 2^17- and 2^18-sample blocks
# (2 or 5 kernel segments, under the 8 the kernel route needs) the
# segmented correlator runs, and kernel 2 probes its K = 4 banks of the 3
# stacked blocks' pairs (3, 4 or 5 stations) in FFTs of 16384 or 32768
# (K = 2 at 65536 for wild-clocks' max_lag 20000: SHARD_K2_SHAPES);
# kernel 3 demodulates the audio-match trial's 3 stations and template.
CAL_K2_SHAPES = ((4, 9, 16384), (4, 9, 32768), (4, 18, 16384),
                 (4, 30, 16384))
CAL_K3_SHAPES = ((4, 1 << 17, 8),)
# Phase 6: receiver LO errors (ppm; pairwise up to 0.3 ppm, 49 Hz at the
# REF carrier), the mover's ENU velocity (130 m/s) and the static
# co-channel interferer's position.
LO_PPM = (0.2, -0.1, 0.05)
MOVER_ENU = (120.0, -50.0, 0.0)
INTERFERER_LLA = (41.05, -95.99, 340.0)
REF_FREQ, TGT_FREQ = 162_400_000.0, 101_900_000.0
# Published H100 SXM peaks (NVIDIA data sheet) for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _device_ms(fn, kernel: str, iters: int, per_call: int = 1,
               tries: int = 3):
    """The device time per wrapper call of the CUDA kernels whose names
    contain ``kernel`` (each call launches ``per_call`` of them; the
    wrapper's other ops are left out), from a ``torch.profiler`` trace
    of ``iters`` calls after a warm-up: the mean launch's time, times
    ``per_call``. Divided by the launches the trace holds: the profiler
    can drop events of a cycle, and now and then a whole trace's. A
    trace that holds none is taken again, up to ``tries`` traces; after
    that the time is None ("not measured", printed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if kernel in e.key and e.device_time_total > 0]
        if seen:
            return (sum(e.device_time_total for e in seen)
                    / sum(e.count for e in seen) / 1e3 * per_call)
    print(f"device time of {kernel}: not measured (the profiler saw none "
          f"of its launches in {tries} traces)")
    return None


def _dev_str(ms, digits: int) -> str:
    """A device time for the log: ``ms`` to ``digits`` places, or "not
    measured" where the profiler saw none."""
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def _same(a, b) -> bool:
    """Bitwise equality of two outputs (tensors or tuples of them)."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None:
        return b is None
    return all(_same(u, v) for u, v in zip(a, b))


def phase_device():
    import torch

    print("== phase 1: device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible")
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"compute capability {cap}, need 9.0 (sm_90a)")
    from tdoa_tpu_torch.ops.kernels import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    print(f"device {torch.cuda.get_device_name(dev)} cc {cap[0]}.{cap[1]}  "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {_smi()}")
    print("tf32: matmul off, cudnn off")
    return dev


def phase_build():
    from tdoa_tpu_torch.ops.kernels import _build

    print("== phase 2: build")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    print(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in (lib.parent / "ptxas.txt").read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def _k1_bound(n_st: int, m: int, n_seg: int, n_banks: int,
              elem_bytes: int = 2, sums: bool = True) -> dict:
    """Kernel 1's bound: planar input (bf16: 2 bytes an element, f32: 4)
    read once; cross, psd and (with DC sums) sum banks written once.
    Operations: a 5·F·log2(F) complex FFT per station and segment, 8 per
    bin per pair (cross MAC), 4 (PSD) and 2 (sums) per bin per station."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN as F
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN

    return _bound(
        2 * n_st * n_seg * SEG_LEN * elem_bytes
        + n_banks * F * (8 * m + 4 * n_st + (8 * n_st if sums else 0)),
        n_seg * F * (n_st * 5 * 16 + 8 * m + (6 if sums else 4) * n_st))


def _k2_bound(K: int, m: int, n_st: int, F: int) -> dict:
    """Kernel 2's bound: the cross and PSD banks read once, the windows
    written once. Operations per (probe row, bin): 8 per lag of the
    33-lag zoom DFT, ~40 for the LOO weighting and the deramp."""
    from tdoa_tpu_torch.ops.kernels.zoom_probe import W

    return _bound(K * F * (8 * m + 4 * n_st) + K * m * W * 8,
                  K * m * F * (8 * W + 40))


def _pair_list(n_rows: int, block: int = 0) -> list:
    """All pairs of ``n_rows`` rows; with ``block``, the pairs within each
    consecutive block of that many rows (the overlapped ingest's
    stacked layout: 3 stations × 3 blocks, 9 rows, carry 9 pairs)."""
    block = block or n_rows
    return [(b + i, b + j) for b in range(0, n_rows, block)
            for i in range(block) for j in range(i + 1, block)]


def _errs(got, want) -> tuple:
    """(max |got − want|, max |got − want| / the row's peak |want|)."""
    diff = (got - want).abs()
    peak = want.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    return float(diff.max()), float((diff / peak).max())


def phase_kernels(dev):
    import torch

    from tdoa_tpu_torch.ops.kernels import corr_accum, zoom_probe
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.ops.peaks import parabolic_peak

    print("== phase 3: kernels vs plain torch versions")
    pairs = ((0, 1), (0, 2), (1, 2))
    K = 4
    g = torch.Generator(device=dev).manual_seed(SEED)

    def block(n_seg, n_st=3):
        x = torch.randn(2, n_st, n_seg * SEG_LEN, device=dev, generator=g)
        x[:, 1] += 0.5 * torch.roll(x[:, 0], 37, dims=-1)
        x[:, 2] += 0.5 * torch.roll(x[:, 0], -12, dims=-1)
        for s in range(3, n_st):
            x[:, s] += 0.5 * torch.roll(x[:, 0], 11 * s - 70, dims=-1)
        return (0.3 * x + 0.01).to(torch.bfloat16).contiguous()

    # Kernel 1 at the stated check shape (16 segments), at the main
    # path's (a 10 s block is 443 segments in the banks 111/111/111/110),
    # and at 12 stations (66 pairs, 172 KB of accumulators an item); each
    # CTA holds one item while the bank's segments stream past. Each is
    # launched twice: the outputs must be bitwise equal.
    # The streaming shapes come last: one bank (K = 1) over the stacked
    # 9 rows × 9 pairs of a default chunk and of a capture's short last
    # chunk, and the same two chunks over a tail session's 3 rows.
    k1_abs, k1_rel, k1_cfg = 0.0, 0.0, {}
    stream_x, stream_err = {}, {}
    # Shapes that no path launches (a check shape: 12 stations × 5
    # segments): their time, bound and plain time ride in the main
    # entry, which the launch count needs no path for.
    also_checked, check_shape = [], (12, 5, 2, 66)
    for shape in ((3, 16, K, 3), BATCH_SHAPE, check_shape, *STREAM_SHAPES):
        n_st, n_seg, kb, _ = shape
        x = block(n_seg, n_st)
        pn = _pair_list(n_st, 3 if kb == 1 else 0)
        cfg = corr_accum.kernel_config(n_st, pn, True)
        got = corr_accum.accumulate_banks(x, pn, kb, True)
        again = corr_accum.accumulate_banks(x, pn, kb, True)
        want = corr_accum.accumulate_banks_plain(x, pn, kb, True)
        torch.cuda.synchronize()
        errs = [_errs(a, b) for a, b in zip(got, want)]
        a_err, r_err = max(e[0] for e in errs), max(e[1] for e in errs)
        same = _same(got, again)
        if kb == 1:
            stream_x[shape] = x
            stream_err[shape] = (a_err, r_err)
        else:
            k1_abs, k1_rel = max(k1_abs, a_err), max(k1_rel, r_err)
        k1_cfg[f"{n_st} st, {n_seg} seg, K={kb}"] = cfg
        print(f"corr_accum [{n_st} st, {n_seg} seg, K={kb}, bf16, sums]: "
              f"launch {cfg}; max |kernel - plain| = {a_err:.3e}, / row "
              f"peak = {r_err:.3e} (tol {K1_TOL:g}); two launches "
              f"bitwise equal: {same}")
        if not r_err < K1_TOL:
            raise RuntimeError(f"corr_accum disagrees with its plain version "
                               f"at {n_st} stations, {n_seg} segments")
        if not same:
            raise RuntimeError(f"corr_accum is not deterministic at {n_st} "
                               f"stations, {n_seg} segments")
        if shape == BATCH_SHAPE:
            x443, got443 = x, got
        elif shape == check_shape:
            also_checked.append(_entry(
                f"corr_accum[{n_st}x{n_seg},K={kb},m={len(pn)}]",
                *K1_SRC, shape, a_err,
                lambda: corr_accum.accumulate_banks(x, pn, kb, True),  # noqa: B023
                lambda: corr_accum.accumulate_banks_plain(  # noqa: B023
                    x, pn, kb, True),  # noqa: B023
                "corr_accum_kernel", _k1_bound(n_st, len(pn), n_seg, kb), 5,
                launches_per_call=2))
        del want, again
    del x, got

    # Kernel 2 on the 443-segment banks (K = 4, m = 3, F = 65536) with
    # the main path's leave-one-out segment counts.
    cross_g, psd_g, _ = got443
    coarse = torch.tensor([37.0, -12.0, -49.0], device=dev)
    seg_g = torch.tensor(corr_accum.bank_bounds(443, K), device=dev).diff()
    nseg = (443 - seg_g).to(torch.float32).repeat_interleave(len(pairs))
    d_k = zoom_probe.loo_zoom_delays(cross_g, psd_g, pairs, coarse, nseg)
    w_k = zoom_probe.loo_zoom_windows(cross_g, psd_g, pairs, coarse, nseg)
    w_p = zoom_probe.loo_zoom_windows_plain(cross_g, psd_g, pairs, coarse, nseg)
    d_p = (coarse.repeat(K) - zoom_probe.HALF_WIDTH
           + parabolic_peak(w_p.abs())[0]).reshape(K, len(pairs))
    torch.cuda.synchronize()
    k2_abs, k2_rel = _errs(w_k, w_p)
    k2_delay = float((d_k - d_p).abs().max())
    k2_same = _same(w_k, zoom_probe.loo_zoom_windows(cross_g, psd_g, pairs,
                                                     coarse, nseg))
    print(f"zoom_probe [K={K}, m=3, F=65536]: max |delay kernel - plain| = "
          f"{k2_delay:.3e} samples (tol {K2_TOL:g}); window max |kernel - "
          f"plain| = {k2_abs:.3e}, / row peak {k2_rel:.3e}; delays "
          f"{d_k.cpu().numpy().round(3).tolist()}; two launches bitwise "
          f"equal: {k2_same}")
    if not k2_delay < K2_TOL:
        raise RuntimeError("zoom_probe disagrees with its plain version")
    if not k2_same:
        raise RuntimeError("zoom_probe is not deterministic")

    # Kernel 2 at the other shapes a path gives it, from the segmented
    # correlator's own accumulation (8 segments a bank pair): K = 4 banks
    # of the 9 pairs of 3 stacked blocks × 3 stations, F = 65536 (the
    # segmented and overlapped paths), and of 3 pairs in FFTs of 32768
    # (a deramp re-correlation over a 2^18-sample window).
    from tdoa_tpu_torch.ops.corr import _accumulate_cross_spectra

    checked2 = {tuple(cross_g.shape)}
    for n_ch, F2, what in ((9, 65536, "9 pairs of 9 channels"),
                           (3, 32768, "3 pairs, the short deramp window")):
        seg2 = F2 - 20000 if F2 == 65536 else F2 - 512
        x2 = torch.randn(2, n_ch, 8 * seg2, device=dev, generator=g)
        for b in range(n_ch // 3):
            x2[:, 3 * b + 1] += 0.5 * torch.roll(x2[:, 3 * b], 37, dims=-1)
            x2[:, 3 * b + 2] += 0.5 * torch.roll(x2[:, 3 * b], -12, dims=-1)
        pairs2 = [(3 * b + i, 3 * b + j) for b in range(n_ch // 3)
                  for i, j in pairs]
        banks = [_accumulate_cross_spectra(
            x2[..., 2 * k * seg2:2 * (k + 1) * seg2], pairs2, seg2, F2)
            for k in range(K)]
        cross2 = torch.stack([a[0] for a in banks])
        psd2 = torch.stack([a[1] for a in banks])
        coarse2 = coarse.repeat(n_ch // 3)
        nseg2 = torch.full((K * len(pairs2),), 6.0, device=dev)
        w2_k = zoom_probe.loo_zoom_windows(cross2, psd2, pairs2, coarse2,
                                           nseg2)
        w2_p = zoom_probe.loo_zoom_windows_plain(cross2, psd2, pairs2,
                                                 coarse2, nseg2)
        torch.cuda.synchronize()
        d2 = float((parabolic_peak(w2_k.abs())[0]
                    - parabolic_peak(w2_p.abs())[0]).abs().max())
        a2, r2 = _errs(w2_k, w2_p)
        print(f"zoom_probe [K={K}, m={len(pairs2)}, n_st={n_ch}, F={F2}; "
              f"{what}]: max |delay kernel - plain| = {d2:.3e} samples "
              f"(tol {K2_TOL:g}); window max |kernel - plain| = {a2:.3e}, "
              f"/ row peak {r2:.3e}")
        if not d2 < K2_TOL:
            raise RuntimeError(f"zoom_probe disagrees with its plain version "
                               f"at {tuple(cross2.shape)}")
        k2_abs, k2_rel = max(k2_abs, a2), max(k2_rel, r2)
        k2_delay = max(k2_delay, d2)
        checked2.add(tuple(cross2.shape))
        del x2, banks, cross2, psd2
    if checked2 != set(K2_SHAPES):
        raise RuntimeError(f"phase 3 checked kernel 2 at {checked2}, not at "
                           f"{K2_SHAPES}")

    # Times at the main path's shapes.
    k1_call = lambda: corr_accum.accumulate_banks(x443, pairs, K, True)  # noqa: E731
    k2_call = lambda: zoom_probe.loo_zoom_windows(  # noqa: E731
        cross_g, psd_g, pairs, coarse, nseg)
    k1_ms = _time_ms(k1_call, 5)
    k1_dev = _device_ms(k1_call, "corr_accum_kernel", 5, 2)
    k1_plain = _time_ms(lambda: corr_accum.accumulate_banks_plain(
        x443, pairs, K, True), 2)
    k2_ms = _time_ms(k2_call, 20)
    k2_dev = _device_ms(k2_call, "zoom_probe_kernel", 20)
    k2_plain = _time_ms(lambda: zoom_probe.loo_zoom_windows_plain(
        cross_g, psd_g, pairs, coarse, nseg), 20)
    F, n_st, m = corr_accum.FFT_LEN, 3, len(pairs)
    b1 = _k1_bound(3, len(pairs), 443, K)
    b2 = _k2_bound(K, m, n_st, F)
    print(f"time corr_accum [3 st, 443 seg, K={K}]: kernel {k1_ms:.3f} ms "
          f"(device time {_dev_str(k1_dev, 3)}), plain {k1_plain:.3f} ms, "
          f"bound {b1['bound_ms']:.4f} ms "
          f"({b1['bound_by']}: {b1['bytes'] / 1e6:.1f} MB, "
          f"{b1['ops'] / 1e9:.2f} GFLOP)")
    print(f"time zoom_probe [K={K}, m=3, F=65536]: kernel {k2_ms:.4f} ms "
          f"(device time {_dev_str(k2_dev, 4)}), plain {k2_plain:.3f} ms, "
          f"bound {b2['bound_ms']:.4f} ms "
          f"({b2['bound_by']}: {b2['bytes'] / 1e6:.2f} MB, "
          f"{b2['ops'] / 1e9:.3f} GFLOP)")
    del x443, got443
    streaming = []
    for shape in STREAM_SHAPES:
        n_s, n_seg_s, kb, _ = shape
        xs = stream_x.pop(shape)
        pn = _pair_list(n_s, 3)
        call = lambda: corr_accum.accumulate_banks(xs, pn, kb, True)  # noqa: E731
        ms = _time_ms(call, 10)
        dev_ms = _device_ms(call, "corr_accum_kernel", 10, 2)
        plain = _time_ms(lambda: corr_accum.accumulate_banks_plain(
            xs, pn, kb, True), 2)
        bs = _k1_bound(n_s, len(pn), n_seg_s, kb)
        name = f"corr_accum[{n_s}x{n_seg_s},K={kb}]"
        print(f"time {name}: kernel {ms:.3f} ms (device time "
              f"{_dev_str(dev_ms, 3)}), plain {plain:.3f} ms, bound {bs['bound_ms']:.4f} ms "
              f"({bs['bound_by']}: {bs['bytes'] / 1e6:.1f} MB, "
              f"{bs['ops'] / 1e9:.2f} GFLOP)")
        streaming.append(
            {"name": name, "route": "cuda",
             "source": "tdoa_tpu_torch/csrc/corr_accum.cu",
             "replaces": "tdoa_tpu/ops/pallas/corr_accum.py:634",
             "shape": list(shape),
             "max_abs_err": stream_err[shape][0],
             "max_rel_err_row_peak": stream_err[shape][1],
             "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
             "bound_ms": bs["bound_ms"], "bound_by": bs["bound_by"],
             "library_ms": None, "bitwise_deterministic": True,
             "launch": k1_cfg[f"{n_s} st, {n_seg_s} seg, K={kb}"]})
        del xs
    k3 = _kernel3(dev, g)
    k4 = _kernel4(dev)
    return [
        {"name": "corr_accum", "route": "cuda",
         "source": "tdoa_tpu_torch/csrc/corr_accum.cu",
         "replaces": "tdoa_tpu/ops/pallas/corr_accum.py:634",
         "shape": list(BATCH_SHAPE),
         "max_abs_err": k1_abs, "max_rel_err_row_peak": k1_rel,
         "ms": k1_ms, "device_ms": k1_dev, "plain_ms": k1_plain,
         "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
         "library_ms": None, "redesigned": True,
         "bitwise_deterministic": True,
         "launch": k1_cfg, "also_checked": also_checked},
        {"name": "zoom_probe", "route": "cuda",
         "source": "tdoa_tpu_torch/csrc/zoom_probe.cu",
         "replaces": "tdoa_tpu/ops/pallas/zoom_probe.py:244",
         "max_abs_err": k2_abs, "max_rel_err_row_peak": k2_rel,
         "max_delay_err_samples": k2_delay, "ms": k2_ms,
         "device_ms": k2_dev, "plain_ms": k2_plain,
         "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"],
         "library_ms": None, "redesigned": True,
         "bitwise_deterministic": True},
        *k3,
        *k4,
        *streaming,
        *_later_shapes(dev, g),
    ]


# Kernel 3's shapes (channels, samples, decimation): the FM path's 3
# blocks × 3 stations, the audio match's 3 stations + the template,
# both over a 10 s block at D = 8; rows off the 16-byte grid and D = 16
# on 2,000,003 samples.
K3_SHAPES = ((9, BLOCK, FM_DECIM), (4, BLOCK, FM_DECIM),
             (3, 2_000_003, FM_DECIM), (3, 2_000_003, 16))


def _k3_bound(C: int, n: int, decim: int) -> dict:
    """Kernel 3's bound: IQ read once (8 bytes a sample), audio written
    once; operations: the conjugate product and scale (7) and atan2
    (~20) per sample, a multiply-add per tap per output."""
    from tdoa_tpu_torch.ops.kernels import fm_demod

    n_out = n // decim
    return _bound(C * n * 8 + C * n_out * 4,
                  C * n * 27 + C * n_out * 2 * fm_demod.NUM_TAPS)


def _kernel3(dev, g):
    """Kernel 3 against its plain version at the FM path's shape (the 3
    blocks × 3 stations of a 30 s capture, 9 channels × 20 M samples of
    FM-like IQ with noise, D = 8), at the audio match's (4 channels of
    a 10 s block: 3 stations and the template), on rows off the 16-byte
    grid and at D = 16; each launched twice (bitwise-equal outputs), the
    two full-width shapes timed. Returns one ``kernels`` entry a
    full-width shape."""
    import torch

    from tdoa_tpu_torch.ops.kernels import fm_demod

    C, n = 9, BLOCK
    x = torch.empty(2, C, n, device=dev)
    for c in range(C):
        step = torch.randn(n, device=dev, generator=g, dtype=torch.float64)
        phase = torch.cumsum(0.3 * step, 0)
        x[0, c] = 0.3 * torch.cos(phase)
        x[1, c] = 0.3 * torch.sin(phase)
        del step, phase
    x += 0.1 * torch.randn(2, C, n, device=dev, generator=g)
    # The audio match stacks its 4 channels into a fresh [2, 4, n].
    inputs = {(9, n, FM_DECIM): x, (4, n, FM_DECIM): x[:, :4].contiguous(),
              (3, 2_000_003, FM_DECIM): x[:, 3:6, 1:2_000_004],
              (3, 2_000_003, 16): x[:, 6:9, :2_000_003]}
    if set(inputs) != set(K3_SHAPES):
        raise RuntimeError(f"kernel 3 inputs {set(inputs)} != {K3_SHAPES}")
    errs = {}
    for (c, m, decim), xi in inputs.items():
        what = ("unaligned rows" if not fm_demod.rows_aligned(xi)
                else "aligned rows")
        if (what == "unaligned rows") != (decim == FM_DECIM and m != n):
            raise RuntimeError(f"fm_demod [{c} ch x {m}]: not the rows meant")
        got = fm_demod.fm_demod_decimate(xi, FS, decim=decim)
        again = fm_demod.fm_demod_decimate(xi, FS, decim=decim)
        want = fm_demod.fm_demod_decimate_plain(xi, FS, decim=decim)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        same = _same(got, again)
        errs[(c, m, decim)] = err
        print(f"fm_demod [{c} ch x {m} samples, {what}, D={decim}]: max "
              f"|kernel - plain| = {err:.3e} (tol {K3_TOL:g}); audio peak "
              f"{float(want.abs().max()):.3f}; two launches bitwise equal: "
              f"{same}")
        if not err < K3_TOL:
            raise RuntimeError(f"fm_demod disagrees with its plain version "
                               f"at {c} ch x {m}, D={decim}")
        if not same:
            raise RuntimeError(f"fm_demod is not deterministic at {c} ch x "
                               f"{m}, D={decim}")
        del got, want, again
    entries = []
    for c in (9, 4):
        xi = inputs[(c, n, FM_DECIM)]
        call = lambda: fm_demod.fm_demod_decimate(xi, FS, decim=FM_DECIM)  # noqa: E731
        ms = _time_ms(call, 20)
        dev_ms = _device_ms(call, "fm_demod_kernel", 20)
        plain = _time_ms(lambda: fm_demod.fm_demod_decimate_plain(
            xi, FS, decim=FM_DECIM), 2)
        b3 = _k3_bound(c, n, FM_DECIM)
        name = "fm_demod" if c == 9 else f"fm_demod[{c}x{n},D={FM_DECIM}]"
        print(f"time {name} [{c} ch x {n}, D={FM_DECIM}]: kernel {ms:.3f} "
              f"ms (device time {_dev_str(dev_ms, 3)}), plain {plain:.3f} ms, "
              f"bound {b3['bound_ms']:.4f} ms "
              f"({b3['bound_by']}: {b3['bytes'] / 1e6:.1f} MB, "
              f"{b3['ops'] / 1e9:.2f} GFLOP)")
        entries.append(
            {"name": name, "route": "cuda",
             "source": "tdoa_tpu_torch/csrc/fm_demod.cu",
             "replaces": "tdoa_tpu/ops/pallas/fm_demod.py:189",
             "shape": [c, n, FM_DECIM],
             "max_abs_err": (max(errs.values()) if c == 9
                             else errs[(c, n, FM_DECIM)]),
             "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
             "bitwise_deterministic": True,
             "bound_ms": b3["bound_ms"], "bound_by": b3["bound_by"],
             "library_ms": None, "redesigned": True})
    del x, inputs
    return entries


# Kernel 4's shapes (starts, pairs, dimensions): every shape the paths
# launch. The multistart's 9 starts in 2D at the pairs of 3 to 6
# stations (the slice, the Monte Carlo networks, 5 with one left out),
# of 12, 14, 16 and 24 stations and of each with one left out; one
# start at 3 pairs (the stream service's tracker, ``parallel.dryrun``);
# the 3D instantiation (``solve_z``) at 3 and 276 pairs. The cells'
# shapes, K4_TIMED, are timed in entries of their own; the others ride
# in the first entry's ``also_checked``.
K4_TIMED = ((9, 3, 2), (9, 276, 2))
K4_SHAPES = K4_TIMED + tuple(
    (9, n * (n - 1) // 2, 2) for n in (4, 5, 6, 11, 12, 13, 14, 15, 16, 23)
) + ((1, 3, 2), (9, 3, 3), (9, 276, 3))
K4_POS_TOL = 0.5  # m, tests/test_torch_solve.py's fix tolerance
K4_RMS_TOL = 0.05  # m, its candidates' rms tolerance
K4_STRAY_RMS = 50.0  # m: above it a start is an unconverged stray


def _k4_bound(S: int, m: int, iters: int = 40) -> dict:
    """Kernel 4's bytes and operations (its bound is neither: the chain
    of ``iters`` dependent iterations): the packed input read once, the
    output written once; ~60 operations a pair a pass, ``iters`` + 1
    passes a start."""
    return _bound(4 * (8 * m + 4 * S) + 16 * S, 60 * m * S * (iters + 1))


def _host_ms(fn, iters: int) -> float:
    """Median host-clock time of ``fn()`` over ``iters`` calls, in ms,
    after a warm-up (for work that runs on the CPU alone)."""
    import statistics

    fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(ts)


def _kernel4(dev):
    """Kernel 4 against its plain version (``solve_tdoa_enu``'s loop on
    CPU tensors) at K4_SHAPES: the multistart's S starts, unsorted, over
    the TDOAs of KEVO (2 ns of noise, weights in [0.5, 1]) at the first
    n stations of NET24_STATIONS (the 3 of ``lat-lon-table.csv`` first),
    m = n(n - 1)/2. Every start that both versions converge within
    K4_POS_TOL and K4_RMS_TOL, ``solve_fix``'s candidates as many and
    its fix within K4_POS_TOL, two launches bitwise equal; as in
    ``tests/test_torch_lm_solve.py``, in 3D the positions are held
    horizontally (the up-coordinate of a flat network lies in a valley
    a few metres long) and at 3 stations not at all (it is unobservable
    there: a start's point drifts along the valley), the rms is. Then, at
    K4_TIMED: the wrapper (one copy in, the launch, one copy out, waited
    for) with CUDA events, the kernel's device time, and the whole
    ``solve_fix`` on the card, beside the plain ``solve_tdoa_enu`` and
    ``solve_fix`` on the CPU (host clock)."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.cli.simulator import DEFAULT_TGT_TX
    from tdoa_tpu_torch.geo import lla_to_ecef, lla_to_enu, network_origin
    from tdoa_tpu_torch.ops.kernels.lm_solve import lm_solve
    from tdoa_tpu_torch.solve import multilateration as ml
    from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

    rng = np.random.default_rng(SEED)
    entries, also_checked = [], []
    for S, m, n_dim in K4_SHAPES:
        n = int(round((1 + (1 + 8 * m) ** 0.5) / 2))
        lla = np.array([s[1:] for s in NET24_STATIONS[:n]])
        pairs = ml.station_pairs(n)
        d = np.linalg.norm(lla_to_ecef(lla) - lla_to_ecef(
            np.array(DEFAULT_TGT_TX)), axis=-1)
        tdoa = ((d[pairs[:, 1]] - d[pairs[:, 0]]) / SPEED_OF_LIGHT
                + 2e-9 * rng.standard_normal(m))
        w = rng.uniform(0.5, 1.0, m)
        enu = torch.from_numpy(
            lla_to_enu(lla, network_origin(lla)).astype(np.float32))
        pt = torch.from_numpy(pairs.astype(np.int64))
        rd = torch.from_numpy((tdoa * SPEED_OF_LIGHT).astype(np.float32))
        wt = torch.from_numpy(w.astype(np.float32))
        starts = ml.multistart_starts(enu, S)
        kw = dict(weights=wt, x0=starts, solve_z=n_dim == 3)
        x_p, r_p = ml.solve_tdoa_enu(enu, pt, rd, **kw)
        x_k, r_k = ml.solve_tdoa_enu(enu, pt, rd, device=dev, **kw)
        again = ml.solve_tdoa_enu(enu, pt, rd, device=dev, **kw)
        same = _same((x_k, r_k), again)
        conv = (r_p < K4_STRAY_RMS) & (r_k < K4_STRAY_RMS)
        held = 3 if n_dim == 2 else 0 if m == 3 else 2  # coordinates
        pos_err = float((x_k[conv, :held] - x_p[conv, :held]).norm(
            dim=-1).max())
        rms_err = float((r_k[conv] - r_p[conv]).abs().max())
        fkw = dict(weights=w, solve_z=n_dim == 3, n_starts=S)
        fix_p = ml.solve_fix(lla, tdoa, **fkw)
        fix_k = ml.solve_fix(lla, tdoa, device=dev, **fkw)
        fix_err = float(np.linalg.norm(fix_k.enu[:held] - fix_p.enu[:held]))
        n_cand = (len(fix_k.candidates_rms), len(fix_p.candidates_rms))
        name = f"lm_solve[{S}x{m},{n_dim}d]"
        print(f"{name}: {int(conv.sum())} of {S} starts converged in both; "
              f"max |kernel - plain| {pos_err:.3e} m over {held} "
              f"coordinates (tol {K4_POS_TOL:g}), "
              f"rms {rms_err:.3e} m (tol {K4_RMS_TOL:g}); solve_fix "
              f"candidates {n_cand[0]} / {n_cand[1]}, fix {fix_err:.3e} m "
              f"apart; two launches bitwise equal: {same}")
        if not (bool(conv[0]) and pos_err < K4_POS_TOL
                and rms_err < K4_RMS_TOL and fix_err < K4_POS_TOL
                and n_cand[0] == n_cand[1] and same):
            raise RuntimeError(f"{name} disagrees with its plain version")
        checked = {"name": name, "shape": [S, m, n_dim],
                   "max_abs_err": pos_err, "max_rms_err": rms_err,
                   "fix_err_m": fix_err}
        if (S, m, n_dim) not in K4_TIMED:
            also_checked.append(checked)
            continue
        si, sj = enu[pt[:, 0]], enu[pt[:, 1]]
        call = lambda: lm_solve(si, sj, rd, wt, starts, 40, n_dim, dev)  # noqa: E731,B023
        ms = _time_ms(call, 50)
        dev_ms = _device_ms(call, "lm_solve_kernel", 50)
        fix_ms = _time_ms(lambda: ml.solve_fix(  # noqa: B023
            lla, tdoa, weights=w, device=dev), 20)  # noqa: B023
        plain = _host_ms(lambda: ml.solve_tdoa_enu(  # noqa: B023
            enu, pt, rd, weights=wt, x0=starts), 10)  # noqa: B023
        plain_fix = _host_ms(lambda: ml.solve_fix(  # noqa: B023
            lla, tdoa, weights=w), 10)  # noqa: B023
        b = _k4_bound(S, m)
        print(f"time {name}: wrapper {ms:.4f} ms (device time "
              f"{_dev_str(dev_ms, 4)}), solve_fix {fix_ms:.4f} ms; plain "
              f"solve_tdoa_enu {plain:.3f} ms, solve_fix {plain_fix:.3f} ms "
              f"(CPU); bytes and operations {b['bound_ms']:.6f} ms "
              f"({b['bytes']} B, {b['ops'] / 1e6:.2f} MFLOP): bound by the "
              f"40 dependent iterations")
        entries.append({
            **checked, "route": "cuda",
            "source": "tdoa_tpu_torch/csrc/lm_solve.cu",
            "replaces": "none: the jitted LM loop of "
                        "tdoa_tpu/solve/multilateration.py:39",
            "ms": ms, "device_ms": dev_ms, "solve_fix_ms": fix_ms,
            "plain_ms": plain, "plain_solve_fix_ms": plain_fix,
            "bound_ms": b["bound_ms"], "bound_by": "latency",
            "library_ms": None, "bitwise_deterministic": True})
    entries[0]["also_checked"] = also_checked
    return entries


def _k1_block(dev, g, n_seg: int, n_st: int, dtype):
    """Planar [2, n_st, n_seg·SEG_LEN] noise, every row but the first
    carrying a delayed copy of the first, with DC, as ``dtype``."""
    import torch

    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN

    x = torch.randn(2, n_st, n_seg * SEG_LEN, device=dev, generator=g)
    for s in range(1, n_st):
        x[:, s] += 0.5 * torch.roll(x[:, 0], 11 * s - 70, dims=-1)
    return (0.3 * x + 0.01).to(dtype).contiguous()


def _entry(name, source, replaces, shape, err, call, plain_call, kernel,
           bound, iters, launches_per_call=1):
    """A ``kernels`` entry for one kernel at one shape: its check's error,
    its time (event loop and profiler device time per call: the sum of
    its ``launches_per_call`` device launches) beside the plain
    version's and the bound. Prints one line."""
    ms = _time_ms(call, iters)
    dev_ms = _device_ms(call, kernel, iters, launches_per_call)
    plain = _time_ms(plain_call, 2)
    print(f"time {name}: kernel "
          f"{ms:.4f} ms (device time {_dev_str(dev_ms, 4)}), "
          f"plain {plain:.3f} ms, bound {bound['bound_ms']:.5f} ms "
          f"({bound['bound_by']}: {bound['bytes'] / 1e6:.2f} MB, "
          f"{bound['ops'] / 1e9:.3f} GFLOP)")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape), "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "bitwise_deterministic": True}


K1_SRC = ("tdoa_tpu_torch/csrc/corr_accum.cu",
          "tdoa_tpu/ops/pallas/corr_accum.py:634")


def _later_shapes(dev, g):
    """Phase 3 for the shapes phases 9 and 10 give the kernels: each
    against its plain version (2 launches, bitwise equal), then timed.
    Kernel 1 at the sharded step's f32 single-bank chunks, its
    comparator's and the dry run's shapes; kernel 2 at every (K, m, F)
    of those paths and of the calibration trials not in K2_SHAPES;
    kernel 3 at the audio-match trial's."""
    import torch

    from tdoa_tpu_torch.ops.corr import _accumulate_cross_spectra
    from tdoa_tpu_torch.ops.kernels import corr_accum, fm_demod, zoom_probe
    from tdoa_tpu_torch.ops.peaks import parabolic_peak

    k1_src = K1_SRC
    k2_src = ("tdoa_tpu_torch/csrc/zoom_probe.cu",
              "tdoa_tpu/ops/pallas/zoom_probe.py:244")
    k3_src = ("tdoa_tpu_torch/csrc/fm_demod.cu",
              "tdoa_tpu/ops/pallas/fm_demod.py:189")
    entries = []
    # Kernel 1 as the sharded paths run it (f32, one bank or the
    # comparator's banks, no DC sums), then at the network phase's
    # shapes (bf16, DC sums, pair-tiled where a launch does not hold the
    # pairs): each call's launch keys are its tiles'.
    k1_calls = [(n_st, n_seg, kb, 3 if n_st == 9 else n_st, torch.float32,
                 False) for n_st, n_seg, kb, _ in
                SHARD_K1_SHAPES + DRYRUN_K1_SHAPES]
    k1_calls += [(3 * n_st if stacked else n_st, n_seg, kb, n_st,
                  torch.bfloat16, True) for n_st, n_seg, kb, stacked in NET_K1]
    k1_calls += [(rows, n_seg, kb, block, torch.float32, False)
                 for rows, n_seg, kb, block in NET_SHARD_K1]
    k1_calls += [(rows, n_seg, kb, block, torch.bfloat16, True)
                 for rows, n_seg, kb, block in WINDOW_K1]
    k1_calls += [(rows, n_seg, kb, block, torch.float32, False)
                 for rows, n_seg, kb, block in WINDOW_SHARD_K1]
    for rows, n_seg, kb, block, dtype, sums in k1_calls:
        f32 = dtype == torch.float32
        x = _k1_block(dev, g, n_seg, rows, dtype)
        pn = _pair_list(rows, block)
        keys = _k1_launch_keys(rows, n_seg, kb, pn, sums, dev)
        # Stage 1 runs once a row block (its tiles share it), stage 2
        # once a tile.
        blocks = {(r0, r1) for r0, r1, _, _ in corr_accum.plan_tiles(
            pn, rows, sums, corr_accum.smem_optin(dev))}
        got = corr_accum.accumulate_banks(x, pn, kb, sums)
        again = corr_accum.accumulate_banks(x, pn, kb, sums)
        want = corr_accum.accumulate_banks_plain(x, pn, kb, sums)
        torch.cuda.synchronize()
        errs = [_errs(a, b) for a, b in zip(got, want) if b is not None]
        a_err, r_err = max(e[0] for e in errs), max(e[1] for e in errs)
        same = _same(got, again)
        del want, again
        name = (f"corr_accum[{rows}x{n_seg},K={kb},"
                f"{'f32' if f32 else f'm={len(pn)}'}]")
        cfg = corr_accum.kernel_config(rows, pn, sums, not f32)
        print(f"corr_accum [{rows} rows, {len(pn)} pairs, {n_seg} seg, "
              f"K={kb}, {'f32' if f32 else 'bf16, sums'}]: launches {keys}"
              f"; largest launch {cfg}"
              f"; max |kernel - plain| = {a_err:.3e}, / row peak = "
              f"{r_err:.3e} (tol {K1_TOL:g}); two calls bitwise equal: "
              f"{same}")
        if not (r_err < K1_TOL and same):
            raise RuntimeError(f"{name}: error {r_err:.3e}, deterministic "
                               f"{same}")
        extra = {}
        if (rows, n_seg, kb) == NET_FORCED[:3]:
            forced = corr_accum.accumulate_banks(x, pn, kb, sums,
                                                 max_pairs=NET_FORCED[3])
            torch.cuda.synchronize()
            equal = _same(forced, got)
            print(f"  forced into tiles of {NET_FORCED[3]} pairs: bitwise "
                  f"the untiled launch: {equal}")
            if not equal:
                raise RuntimeError(f"{name}: 2 tiles differ from one launch")
            extra["forced_2_tiles_bitwise_equal"] = True
            del forced
        del got
        entry = _entry(
            name, *k1_src, (rows, n_seg, kb, len(pn)), a_err,
            lambda: corr_accum.accumulate_banks(x, pn, kb, sums),  # noqa: B023
            lambda: corr_accum.accumulate_banks_plain(  # noqa: B023
                x, pn, kb, sums),  # noqa: B023
            "corr_accum_kernel",
            _k1_bound(rows, len(pn), n_seg, kb, 4 if f32 else 2, sums),
            10 if f32 and rows <= 9 else 3,
            launches_per_call=len(keys) + len(blocks))
        entry.update(launch_keys=[list(k) for k in keys], tiles=len(keys),
                     max_rel_err_row_peak=r_err, **extra)
        entries.append(entry)
        del x
        torch.cuda.empty_cache()
    # Kernel 2 on banks that the segmented correlator accumulates from
    # rows with planted integer delays (2 segments a bank), the coarse
    # delays the planted ones.
    for K, m, F in (SHARD_K2_SHAPES + CAL_K2_SHAPES + NET_K2_SHAPES
                    + NET_SHARD_K2_SHAPES):
        # m pairs: of 3, 12, 14, 16 or 24 stations, or of 3 stacked
        # blocks of 3, 4, 5, 12, 14, 16 or 24.
        n_st, grp = {3: (3, 3), 9: (9, 3), 18: (12, 4), 30: (15, 5),
                     66: (12, 12), 91: (14, 14), 120: (16, 16),
                     276: (24, 24), 198: (36, 12), 273: (42, 14),
                     360: (48, 16), 828: (72, 24)}[m]
        pn = [(grp * b + i, grp * b + j) for b in range(n_st // grp)
              for i, j in _pair_list(grp)]
        seg = (3 * F) // 4
        d = [(11 * (s % grp) - 7 * (s % grp > 0)) for s in range(n_st)]
        x = torch.randn(2, n_st, 2 * K * seg, device=dev, generator=g)
        for s in range(n_st):
            if s % grp:
                x[:, s] += 0.5 * torch.roll(x[:, s - s % grp], d[s], dims=-1)
        banks = [_accumulate_cross_spectra(
            x[..., 2 * k * seg:2 * (k + 1) * seg], pn, seg, F)
            for k in range(K)]
        cross = torch.stack([a[0] for a in banks]).contiguous()
        psd = torch.stack([a[1] for a in banks]).contiguous()
        coarse = torch.tensor([float(d[j] - d[i]) for i, j in pn],
                              device=dev)
        nseg = torch.full((K * m,), 2.0 * (K - 1), device=dev)
        w_k = zoom_probe.loo_zoom_windows(cross, psd, pn, coarse, nseg)
        w_again = zoom_probe.loo_zoom_windows(cross, psd, pn, coarse, nseg)
        w_p = zoom_probe.loo_zoom_windows_plain(cross, psd, pn, coarse, nseg)
        torch.cuda.synchronize()
        dd = float((parabolic_peak(w_k.abs())[0]
                    - parabolic_peak(w_p.abs())[0]).abs().max())
        a2, r2 = _errs(w_k, w_p)
        same = _same(w_k, w_again)
        print(f"zoom_probe [K={K}, m={m}, n_st={n_st}, F={F}]: max |delay "
              f"kernel - plain| = {dd:.3e} samples (tol {K2_TOL:g}); window "
              f"max |kernel - plain| = {a2:.3e}, / row peak {r2:.3e}; two "
              f"launches bitwise equal: {same}")
        if not (dd < K2_TOL and same):
            raise RuntimeError(f"zoom_probe at {(K, m, F)}: delay error "
                               f"{dd:.3e}, deterministic {same}")
        entry = _entry(
            f"zoom_probe[{K}x{m}x{F}]", *k2_src, (K, m, F), a2,
            lambda: zoom_probe.loo_zoom_windows(  # noqa: B023
                cross, psd, pn, coarse, nseg),  # noqa: B023
            lambda: zoom_probe.loo_zoom_windows_plain(  # noqa: B023
                cross, psd, pn, coarse, nseg),  # noqa: B023
            "zoom_probe_kernel", _k2_bound(K, m, n_st, F), 20)
        entry["max_delay_err_samples"] = dd
        entries.append(entry)
        del x, banks, cross, psd
    torch.cuda.empty_cache()
    for C, n, decim in CAL_K3_SHAPES + WINDOW_K3_SHAPES:
        step = torch.randn(C, n, device=dev, generator=g, dtype=torch.float64)
        phase = torch.cumsum(0.3 * step, -1)
        x = torch.stack([0.3 * torch.cos(phase), 0.3 * torch.sin(phase)])
        x = (x + 0.1 * torch.randn(x.shape, device=dev, generator=g,
                                   dtype=torch.float64)).float().contiguous()
        got = fm_demod.fm_demod_decimate(x, FS, decim=decim)
        again = fm_demod.fm_demod_decimate(x, FS, decim=decim)
        want = fm_demod.fm_demod_decimate_plain(x, FS, decim=decim)
        torch.cuda.synchronize()
        err, same = float((got - want).abs().max()), _same(got, again)
        aligned = fm_demod.rows_aligned(x)
        print(f"fm_demod [{C} ch x {n} samples, D={decim}, "
              f"{'aligned' if aligned else 'unaligned'} rows]: max |kernel "
              f"- plain| = {err:.3e} (tol {K3_TOL:g}); two launches bitwise "
              f"equal: {same}")
        if not (err < K3_TOL and same):
            raise RuntimeError(f"fm_demod at {(C, n, decim)}: error "
                               f"{err:.3e}, deterministic {same}")
        entries.append(_entry(
            f"fm_demod[{C}x{n},D={decim}]", *k3_src, (C, n, decim), err,
            lambda: fm_demod.fm_demod_decimate(x, FS, decim=decim),  # noqa: B023
            lambda: fm_demod.fm_demod_decimate_plain(  # noqa: B023
                x, FS, decim=decim),  # noqa: B023
            "fm_demod_kernel", _k3_bound(C, n, decim), 20))
        entries[-1]["rows_aligned"] = aligned
        del x, got, again, want
    return entries


# The network phase's kernel shapes, checked in phase 3 by
# ``_later_shapes``: kernel 1 over a 10 s block (443 segments, K = 4) of
# 12 stations (66 pairs in one launch at full length), 16 and 24 stations (pair-tiled), and over the overlapped
# ingest's stacked rows (3 blocks of n_st rows, each block's pairs in
# one launch or in tiles) of 12, 16 and 24 stations at a default chunk
# and at a block's short last chunk (K = 1); kernel 2 on the split-σ
# banks of those pair counts: 66, 120, 276 (batch) and 198, 360, 828
# (overlapped). A 12-station tail session launches kernel 1 per block at
# the stacked rows' tile shape (12 rows × 66 pairs, 96 and 59 segments,
# one bank). 14 stations take 2 tiles a block (46 and 45 pairs); kernel
# 2 probes their 91 pairs (kernel route, each block) and 273 (segmented
# route, the 3 blocks stacked).
NET_K1 = ((12, 443, 4, False), (16, 443, 4, False), (24, 443, 4, False),
          (14, 443, 4, False),
          *((n_st, n_seg, 1, True) for n_st in (12, 16, 24)
            for n_seg in (96, 59)))
NET_K2_SHAPES = tuple((4, m, 65536)
                      for m in (66, 120, 276, 198, 360, 828, 91, 273))
# The 12-station sharded step on phase 11's files cut to SHARD_SEGS kernel
# segments: kernel 1 (f32, no DC sums) on the 36 stacked rows, a launch
# per 12-row block — one bank over a rank's 220 segments in the 2-rank
# world, K = 4 banks over 440 for the unsharded comparator (rows,
# segments, banks, rows a block); kernel 2 on the 2 rank groups' banks.
NET_SHARD_WORLD = 2
NET_SHARD_K1 = ((36, SHARD_SEGS // NET_SHARD_WORLD, 1, 12),
                (36, SHARD_SEGS, 4, 12))
NET_SHARD_K2_SHAPES = ((2, 198, 65536),)
# The 12-station block's launch (rows, segments, banks) forced into tiles
# of 33 pairs (2 tiles): bitwise the untiled launch.
NET_FORCED = (12, 443, 4, 33)
# Phase 12, the collector's longest window (``cli/collector.py``'s
# MAX_DURATION_S, 100 s): three blocks of 66,666,666 samples, 1479 whole
# kernel segments each (28,842 samples of ragged tail dropped). Kernel 1
# there (rows, segments, banks, rows a block): the batch banks of 3
# stations and of 12 (66 pairs), and a block's short last chunk (1479 = 15·96 + 39) on the overlapped
# ingest's 9 stacked rows, a tail session's 3 and 12 stations' 36 stacked
# rows (the 96-segment chunks are the 30 s window's shapes); kernel 3 on
# the FM path's 9 channels of a 100 s block. Scene A: 24 stations' batch
# banks (6 tiles of 46 pairs) and the last chunk on their 72 stacked
# rows (18 launches of 24 × 46, a tail session's too; its 96-segment
# chunks are NET_K1's). Scene D, the sharded step on whole 100 s blocks
# (f32, no DC sums; rows, segments, banks, rows a block): a rank's chunk
# of the 9 stacked rows in worlds of 1, 2 and 4 (1479, 739 and 369
# segments, one bank) and the unsharded comparators on the segments
# those worlds keep (1479, 1478, 1476; K = 4). Scene C: kernel 3 on the
# audio match's 3 stations and template over a 100 s block.
WINDOW_S = 100
WINDOW_BLOCK = WINDOW_S * int(FS) // 3
WINDOW_K1 = ((3, 1479, 4, 3), (12, 1479, 4, 12), (9, 39, 1, 3),
             (3, 39, 1, 3), (36, 39, 1, 12), (24, 1479, 4, 24),
             (72, 39, 1, 24))
WINDOW_SHARD_K1 = ((9, 1479, 1, 3), (9, 739, 1, 3), (9, 369, 1, 3),
                   (9, 1479, 4, 3), (9, 1478, 4, 3), (9, 1476, 4, 3))
WINDOW_K3_SHAPES = ((9, WINDOW_BLOCK, FM_DECIM), (4, WINDOW_BLOCK, FM_DECIM))


def _k1_launch_keys(rows: int, n_seg: int, kb: int, pairs, sums: bool,
                    dev) -> list:
    """Kernel 1's launch keys (rows, segments, banks, pairs) of one
    ``accumulate_banks`` call, by its tile plan on ``dev``."""
    from tdoa_tpu_torch.ops.kernels import corr_accum

    return [(r1 - r0, n_seg, kb, hi - lo) for r0, r1, lo, hi in
            corr_accum.plan_tiles(pairs, rows, sums,
                                  corr_accum.smem_optin(dev))]


def _synthesize(dev, out_dir: Path, lo_ppm=None, mover_enu=None,
                interferer_lla=None, prefix: str = "sim",
                csv: Path = ROOT / "lat-lon-table.csv",
                clock_offsets_s=CLOCK_OFFSETS_S, tgt_shift=None,
                block: int = BLOCK, write: bool = True):
    """Write one u8 [REF | TGT | REF] .dat per receiver of ``csv`` (every
    row but the KEVO target and the REF transmitter) with its clock
    offset, each block ``block`` samples; return (paths, truth). With
    ``write=False`` nothing is written: the first item is then
    {name: the file's bytes as a u8 array}. ``tgt_shift`` ({name: samples})
    delays a station's TGT block further, its REF blocks untouched (a
    multipath lock: tests/test_multistation.py's ``_roll_tgt``). ``truth``: per-station TGT delays (samples) at the TGT
    block's midpoint geometry (``tau_tgt``), the transmitter's lat/lon/
    elev there (``tgt_lla``), its per-station delay rates from motion
    alone (``rate``), and the interferer's delays and position.

    The channel is the JAX package's simulator's (``sim/scene.py``,
    ``sim/delay.py``): a delay rate α_s — the station's clock drift
    ``lo_ppm``·1e-6 on every block (a crystal off by ε ppm offsets its
    LO by ε·f_c as well), plus range rate / c on TGT for a mover — turns
    the carrier by exp(−j2π f_block α_s (t − t_mid)); the envelope is
    delayed by the block midpoint's value (geometry, clock offset and
    drift at the midpoint); a mover starts at the KEVO row and is
    evaluated at the TGT block's midpoint. The static interferer adds
    its own source at equal power on TGT. The constant carrier phases
    are left out, as phase 4 leaves them out."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.geo import ecef_to_lla, enu_to_ecef, lla_to_ecef
    from tdoa_tpu_torch.io.stations import load_station_table
    from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

    table = load_station_table(str(csv), reference_freq=REF_FREQ)
    # The table's KEVO row is the target transmitter; the other
    # callsign rows are the receivers.
    tgt0 = table["KEVO"].lla()
    names = [n for n in table.names if n != "KEVO"]
    shift = np.array([(tgt_shift or {}).get(n, 0.0) for n in names])
    st = lla_to_ecef(table.lla_array(names))
    t_mid_tgt = 1.5 * block / FS
    v_ecef = np.zeros(3)
    if mover_enu is not None:
        v_ecef = (enu_to_ecef(np.asarray(mover_enu, np.float64), tgt0)
                  - enu_to_ecef(np.zeros(3), tgt0))
    p_tgt = lla_to_ecef(tgt0) + v_ecef * t_mid_tgt
    u = st - p_tgt
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    rate_motion = -(u @ v_ecef) / SPEED_OF_LIGHT  # d|station - p|/dt / c
    drift = 1e-6 * (np.zeros(len(names)) if lo_ppm is None
                    else np.asarray(lo_ppm, np.float64))

    def delays(tx_ecef):
        return np.linalg.norm(st - tx_ecef, axis=-1) / SPEED_OF_LIGHT * FS

    tau = {"ref": delays(lla_to_ecef(table.reference_tx.lla())),
           "tgt": delays(p_tgt)}
    tau_int = (None if interferer_lla is None
               else delays(lla_to_ecef(np.asarray(interferer_lla))))
    pad = 4096
    n_fft = 1 << (block + 2 * pad).bit_length()  # > block + pad + delays
    g = torch.Generator(device=dev).manual_seed(SEED)
    f = torch.fft.fftfreq(n_fft, device=dev, dtype=torch.float64)
    t_rel = (torch.arange(block, device=dev, dtype=torch.float64)
             - (block - 1) / 2.0) / FS

    def source():
        # FM-like source: a 15 kHz low-passed message at 25 kHz rms
        # deviation, exp(i·phase).
        msg = torch.fft.fft(torch.randn(n_fft, device=dev, generator=g,
                                        dtype=torch.float64))
        msg[f.abs() > 15e3 / FS] = 0
        msg = torch.fft.ifft(msg).real
        msg = msg / msg.std()
        phase = torch.cumsum(2 * np.pi * 25e3 / FS * msg, 0)
        return torch.fft.fft(torch.polar(torch.ones_like(phase), phase))

    def delayed(spec, d):
        return torch.fft.ifft(spec * torch.polar(
            torch.ones_like(f), -2 * np.pi * f * d))[pad:pad + block]

    raw = {n: [] for n in names}
    for b, kind in enumerate(("ref", "tgt", "ref")):
        carrier = TGT_FREQ if kind == "tgt" else REF_FREQ
        # Each station's clock at this block's midpoint, in samples.
        clock = (np.asarray(clock_offsets_s)
                 + drift * (b + 0.5) * block / FS) * FS
        rate = drift + (rate_motion if kind == "tgt" else 0.0)
        spec = source()
        spec_int = (source() if kind == "tgt" and tau_int is not None
                    else None)
        for s, name in enumerate(names):
            z = delayed(spec, tau[kind][s] + clock[s]
                        + (shift[s] if kind == "tgt" else 0.0))
            if rate[s] != 0.0:
                z *= torch.polar(torch.ones_like(t_rel),
                                 -2 * np.pi * carrier * rate[s] * t_rel)
            if spec_int is not None:
                z += delayed(spec_int, tau_int[s] + clock[s])
            noise = torch.randn(2, block, device=dev, generator=g,
                                dtype=torch.float64)
            iq = torch.stack([0.3 * z.real + 0.1 * noise[0],
                              0.3 * z.imag + 0.1 * noise[1]], dim=-1)
            u8 = torch.clamp(torch.floor(iq * 127.5 + 128.0), 0, 255)
            raw[name].append(u8.to(torch.uint8).reshape(-1).cpu().numpy())
            del z, noise, iq, u8
        del spec, spec_int
    truth = {"tau_tgt": dict(zip(names, tau["tgt"])),
             "tgt_lla": ecef_to_lla(p_tgt),
             "rate": dict(zip(names, rate_motion)), "v_ecef": v_ecef,
             "tau_int": None if tau_int is None else dict(zip(names, tau_int)),
             "int_lla": (None if interferer_lla is None
                         else np.asarray(interferer_lla, np.float64))}
    if not write:
        return {n: np.concatenate(raw.pop(n)) for n in names}, truth
    paths = []
    for name in names:
        p = out_dir / f"{prefix}-{name}-1700000000.dat"
        with open(p, "wb") as fh:
            for part in raw[name]:
                fh.write(part.tobytes())
        paths.append(str(p))
    return paths, truth


# The paths phase 4 drives on the same files: (name, processor settings,
# TDOA bound in samples, fix bound in m, kernels that must launch,
# kernels that must not).
PATHS = (
    ("fused IQ", {}, 0.5, 200.0, ("corr_accum", "zoom_probe", "lm_solve"),
     ()),
    ("segmented IQ (accumulator=xla)", {"accumulator": "xla"}, 0.5, 200.0,
     ("zoom_probe", "lm_solve"), ("corr_accum", "fm_demod")),
    ("FM (mode=fm)", {"mode": "fm", "fm_decim": FM_DECIM}, 16.0, 4000.0,
     ("fm_demod", "lm_solve"), ("corr_accum",)),
)


def _counters():
    from tdoa_tpu_torch.ops.kernels import corr_accum, fm_demod, zoom_probe
    from tdoa_tpu_torch.ops.kernels.lm_solve import lm_solve

    return {"corr_accum": corr_accum.accumulate_banks,
            "zoom_probe": zoom_probe.loo_zoom_windows,
            "fm_demod": fm_demod.fm_demod_decimate,
            "lm_solve": lm_solve}


def _reset_counts(counters):
    """Every launch count and shape count to 0 (then a path runs)."""
    for fn in counters.values():
        fn.launches = 0
        fn.launch_shapes.clear()


# Each kernel's launches by shape: kernel 1 by (rows, segments, banks,
# pairs) of each launch (a tile's, where the pair list is tiled), kernel
# 2 by (banks, pairs, FFT length), kernel 3 by (channels, samples,
# decimation), kernel 4 by (starts, pairs, dimensions).
SHAPE_KEYS = {"corr_accum": "k1_shapes", "zoom_probe": "k2_shapes",
              "fm_demod": "k3_shapes", "lm_solve": "k4_shapes"}


def _read_counts(counters):
    """(launches by kernel, {"k1_shapes": ..., "k2_shapes": ...,
    "k3_shapes": ..., "k4_shapes": ...}: each kernel's launches by
    shape) since the reset."""
    return ({k: fn.launches for k, fn in counters.items()},
            {SHAPE_KEYS[k]: {str(sh): v for sh, v in fn.launch_shapes.items()}
             for k, fn in counters.items()})


def _run_path(dev, paths, tau_tgt, tgt_tx, name, cfg, tdoa_tol, fix_tol,
              must, must_not):
    """One path on the files: a warm-up run, then a timed run with every
    launch count set to 0 just before it and read just after; checks
    the result against the truth and the launches against the path."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.geo import lla_to_enu
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    print(f"-- {name}")
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ,
                                  str(ROOT / "lat-lon-table.csv"),
                                  device=dev, **cfg)
    t0 = time.perf_counter()
    proc.process_files(paths)  # warm-up: cuFFT plans, allocator
    print(f"first run {time.perf_counter() - t0:.3f} s")
    counters = _counters()
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = proc.process_files(paths)  # results are host arrays: synced
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    print(f"timed run: process_files {wall:.3f} s  [{_smi()}]")
    print(f"kernel launches in the timed run: {launches}")
    names = res.station_names
    want = np.array([tau_tgt[names[j]] - tau_tgt[names[i]]
                     for i, j in res.pair_idx])
    err = res.corrected_tdoa_samples - want
    for k, (i, j) in enumerate(res.pair_idx):
        print(f"  {names[i]}-{names[j]}: TDOA {res.corrected_tdoa_samples[k]:+.4f}"
              f" samples (truth {want[k]:+.4f}, err {err[k]:+.4f}), "
              f"1σ {res.tdoa_std_s[k] * FS:.4f}, raw {res.tgt_delay_samples[k]:+.3f}")
    fix_err = float(np.linalg.norm(lla_to_enu(
        np.array([res.fix.lat, res.fix.lon, tgt_tx[2]]), tgt_tx)[:2]))
    print(f"  fix {res.fix.lat:.6f}, {res.fix.lon:.6f}: {fix_err:.1f} m from "
          f"the planted transmitter; 1σ ellipse "
          f"{res.fix.ellipse[0]:.2f} x {res.fix.ellipse[1]:.2f} m")
    for w in res.warnings:
        print(f"  warning: {w}")
    if any(launches[k] < 1 for k in must):
        raise RuntimeError(f"{name}: a kernel of the path did not launch: "
                           f"{launches}")
    if any(launches[k] for k in must_not):
        raise RuntimeError(f"{name}: a kernel off the path launched: "
                           f"{launches}")
    if not np.all(np.abs(err) < tdoa_tol):
        raise RuntimeError(f"{name}: corrected TDOAs off the truth by {err}")
    if not fix_err < fix_tol:
        raise RuntimeError(f"{name}: fix {fix_err:.1f} m from the "
                           f"transmitter")
    return {"wall_s": wall, "launches": launches, **shapes,
            "tdoa_err_samples": err.tolist(), "fix_err_m": fix_err,
            "tdoa_by_pair": _by_pair(res)}


def _by_pair(res) -> dict:
    """Corrected TDOAs keyed by (earlier name, later name) of the sorted
    pair, signed for that order: comparable between station orders."""
    out = {}
    for (i, j), t in zip(res.pair_idx, res.corrected_tdoa_samples):
        a, b = res.station_names[i], res.station_names[j]
        out[(a, b) if a < b else (b, a)] = float(t if a < b else -t)
    return out


def _check_overlap_result(what, res, tau_tgt, tgt_tx, fused_by_pair):
    """An overlapped or tail result against the truth (0.5 sample, 200 m)
    and against phase 4's fused batch result (0.05 sample: per-chunk
    against per-block DC removal and the interleaved slots differ)."""
    import numpy as np

    from tdoa_tpu_torch.geo import lla_to_enu

    got = _by_pair(res)
    err_truth = {k: v - (tau_tgt[k[1]] - tau_tgt[k[0]])
                 for k, v in got.items()}
    err_batch = {k: v - fused_by_pair[k] for k, v in got.items()}
    fix_err = float(np.linalg.norm(lla_to_enu(
        np.array([res.fix.lat, res.fix.lon, tgt_tx[2]]), tgt_tx)[:2]))
    for k in got:
        print(f"  {k[0]}-{k[1]}: TDOA {got[k]:+.4f} samples (truth err "
              f"{err_truth[k]:+.4f}, against the fused batch path "
              f"{err_batch[k]:+.4f})")
    print(f"  fix {res.fix.lat:.6f}, {res.fix.lon:.6f}: {fix_err:.1f} m from "
          f"the planted transmitter; 1σ {(res.tdoa_std_s * FS).round(4)}")
    if not all(abs(v) < 0.5 for v in err_truth.values()):
        raise RuntimeError(f"{what}: corrected TDOAs off the truth")
    if not all(abs(v) < 0.05 for v in err_batch.values()):
        raise RuntimeError(f"{what}: corrected TDOAs off the batch path's")
    if not fix_err < 200.0:
        raise RuntimeError(f"{what}: fix {fix_err:.1f} m from the transmitter")
    if not np.all(res.tdoa_std_s > 0):
        raise RuntimeError(f"{what}: a σ is not positive")
    return {"tdoa_err_samples": list(err_truth.values()),
            "tdoa_vs_batch_samples": list(err_batch.values()),
            "fix_err_m": fix_err}


def _tail_run(proc, names, views, block: int):
    """A ``TailIngest`` session over growing files: each station's view
    cut to k/10 of its words (k = 1..9) fed in turn, then the whole
    files finished by ``process_captures(caps, tail=session)``, timed
    from the moment the last byte lands. Returns (the result, the
    session, chunks dispatched before the last tenth, last byte → fix
    s)."""
    import torch

    from tdoa_tpu_torch.pipeline.processor import HostCapture

    total = views[0].shape[0]
    sess = proc.tail_session(names, block)
    before = 0
    for k in range(1, 10):
        before += sess.feed([v[:total * k // 10] for v in views])
    caps = {n: HostCapture(u16=v, block_len=block)
            for n, v in zip(names, views)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()  # the last byte lands now
    r = proc.process_captures(caps, tail=sess)
    return r, sess, before, time.perf_counter() - t0


def _tail_ready(spans, block: int, total: int) -> int:
    """The chunks of a capture of three ``block``-sample blocks (chunk
    ``spans`` a block) whose samples all lie within the first nine
    tenths of its ``total`` samples."""
    return sum(1 for b in range(3) for start, n in spans
               if b * block + start + n <= total * 9 // 10)


def phase_overlap(dev, paths, tau_tgt, tgt_tx, fused_by_pair):
    """Phase 5 on phase 4's files: overlapped ingest, the streaming loop
    without a host wait, a checkpoint round trip, a tail session."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.pipeline import TDOAProcessor, ingest, streaming
    from tdoa_tpu_torch.solve.multilateration import station_pairs

    print("== phase 5: overlapped ingest, checkpoint, tail session")
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ,
                                  str(ROOT / "lat-lon-table.csv"), device=dev)
    counters = _counters()
    _, spans = ingest.plan_chunks(BLOCK, SEG_LEN)
    n_chunks = len(spans)
    if {(rows, n // SEG_LEN, 1, rows) for rows in (9, 3)
            for _, n in spans} != set(STREAM_SHAPES):
        raise RuntimeError(f"phase 3 checked kernel 1 at {STREAM_SHAPES}, "
                           f"the plan has chunks {spans}")

    def timed(fn):
        _reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(paths)  # results are host arrays: synced
        return res, time.perf_counter() - t0, _read_counts(counters)

    t0 = time.perf_counter()
    proc.process_files_overlapped(paths)  # warm-up: pinned buffers, plans
    print(f"-- process_files_overlapped: first run "
          f"{time.perf_counter() - t0:.3f} s")
    res, wall, (launches, shapes) = timed(proc.process_files_overlapped)
    diag = dict(proc.ingest_diag)
    _, wall_batch, _ = timed(proc.process_files)
    print(f"timed run: process_files_overlapped {wall:.3f} s, process_files "
          f"{wall_batch:.3f} s right after it  [{_smi()}]")
    print(f"chunks {diag['n_chunks']} of {diag['chunk_segs']} segments; "
          f"gather {diag['gather_s'] * 1e3:.1f} ms on the host, copy stream "
          f"{diag['transfer_stream_s'] * 1e3:.1f} ms; kernel launches "
          f"{launches}, kernel 1 by (rows, segments, banks, pairs) "
          f"{shapes['k1_shapes']}")
    out = {"overlapped": _check_overlap_result(
        "overlapped", res, tau_tgt, tgt_tx, fused_by_pair)}
    out["overlapped"].update(wall_s=wall, batch_wall_s=wall_batch,
                             launches=launches, diag=diag, **shapes)
    if launches["corr_accum"] != n_chunks or diag["n_chunks"] != n_chunks:
        raise RuntimeError(f"overlapped: {launches['corr_accum']} launches of "
                           f"kernel 1 for a plan of {n_chunks} chunks")
    if launches["zoom_probe"] != 1 or launches["fm_demod"]:
        raise RuntimeError(f"overlapped: unexpected launches {launches}")

    # The streaming loop alone, every device synchronisation an error:
    # gather, copy stream, decode and kernel 1 for every chunk.
    names = res.station_names
    views = []
    for n in names:
        path = next(p for p in paths if f"-{n}-" in p)
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        views.append(iq_bytes_as_u16(raw[: (raw.size // 2) * 2]))
    pairs = station_pairs(len(names))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, all_pairs, fft_len = ingest.accumulate_overlapped(
            views, pairs, block_len=BLOCK, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"-- streaming loop under set_sync_debug_mode('error'): "
          f"{state.n_chunks} chunks, {state.n_seg} segments, no host wait")
    if (state.n_chunks, state.n_seg) != (n_chunks, BLOCK // SEG_LEN):
        raise RuntimeError("the streaming loop dropped a chunk")

    # Checkpoint round trip at full width: save from the card, load back,
    # finalize both.
    ck = str(Path(paths[0]).parent / "acc_state.npz")
    streaming.acc_save(ck, state)
    back = streaming.acc_load(ck, device=dev)
    fin_a = streaming.acc_finalize(state, all_pairs, 20000, fft_len=fft_len)
    fin_b = streaming.acc_finalize(back, all_pairs, 20000, fft_len=fft_len)
    torch.cuda.synchronize()
    same = _same(tuple(fin_a), tuple(fin_b))
    print(f"-- acc_save → acc_load ({Path(ck).stat().st_size / 1e6:.1f} MB): "
          f"finalize bitwise equal: {same}")
    if not same:
        raise RuntimeError("a checkpointed state finalizes differently")

    # A tail session over the growing files: views cut to k/10.
    t_names = sorted(names)
    t_views = [views[names.index(n)] for n in t_names]
    total = t_views[0].shape[0]

    _tail_run(proc, t_names, t_views, BLOCK)  # warm-up at the 3-row shapes
    _reset_counts(counters)
    res_t, sess, before, after_s = _tail_run(proc, t_names, t_views, BLOCK)
    launches_t, shapes_t = _read_counts(counters)
    print(f"-- tail session: {before}/{sess.total_chunks} chunks dispatched "
          f"before the last tenth of the files; last byte → fix "
          f"{after_s:.3f} s; launches {launches_t}, kernel 1 by shape "
          f"{shapes_t['k1_shapes']}; copy stream "
          f"{sess.link_diag['transfer_stream_s'] * 1e3:.1f} ms")
    # Every chunk whose samples lay within the first nine tenths of the
    # files went out before the last tenth arrived (with four or fewer
    # chunks a block that is all but two of them).
    ready = _tail_ready(spans, BLOCK, total)
    if before != ready or ready < sess.total_chunks - len(spans) // 2:
        raise RuntimeError(f"the tail session dispatched {before} chunks "
                           f"before the last tenth, {ready} were ready")
    if launches_t["corr_accum"] != sess.total_chunks \
            or launches_t["zoom_probe"] != 3:
        raise RuntimeError(f"tail: unexpected launches {launches_t}")
    out["tail"] = _check_overlap_result("tail", res_t, tau_tgt, tgt_tx,
                                        fused_by_pair)
    out["tail"].update(wall_s=after_s, launches=launches_t, **shapes_t,
                       chunks_before_close=before,
                       total_chunks=sess.total_chunks)
    print(json.dumps({"overlap": {
        "overlapped_s": wall, "batch_s": wall_batch,
        "copy_stream_s": diag["transfer_stream_s"],
        "gather_s": diag["gather_s"], "chunk_segs": diag["chunk_segs"],
        "n_chunks": diag["n_chunks"], "tail_last_byte_to_fix_s": after_s,
        "tail_chunks_before_close": before}}))
    return out


def _fix_err_m(fix, lla) -> float:
    import numpy as np

    from tdoa_tpu_torch.geo import lla_to_enu

    return float(np.linalg.norm(lla_to_enu(
        np.array([fix.lat, fix.lon, lla[2]]), lla)[:2]))


def _truth_velocity_enu(truth, origin_lla):
    """The mover's velocity in the ENU frame of the fix's origin."""
    from tdoa_tpu_torch.geo import ecef_to_enu, lla_to_ecef

    return ecef_to_enu(lla_to_ecef(origin_lla) + truth["v_ecef"], origin_lla)


def _planted_fdoa_hz(res, truth):
    """Per-pair Doppler of the mover's motion alone (Hz, station j
    up-shifted positive): what LO compensation leaves in the TGT block."""
    import numpy as np

    r = [truth["rate"][n] for n in res.station_names]
    return np.array([-TGT_FREQ * (r[j] - r[i]) for i, j in res.pair_idx])


def _report(name, res, truth):
    """Print a phase-6 result: TDOAs against the midpoint geometry, the
    fix, velocity and FDOA against the planted ones, emitters, warnings.
    Returns the numbers the checks read."""
    import numpy as np

    names = res.station_names
    tau = truth["tau_tgt"]
    want = np.array([tau[names[j]] - tau[names[i]] for i, j in res.pair_idx])
    err = res.corrected_tdoa_samples - want
    out = {"tdoa_err_samples": err.tolist(),
           "fix_err_m": _fix_err_m(res.fix, truth["tgt_lla"])}
    print(f"  {name}: TDOA err {np.round(err, 4).tolist()} samples, 1σ "
          f"{np.round(res.tdoa_std_s * FS, 4).tolist()}; fix "
          f"{out['fix_err_m']:.1f} m from the mover's midpoint position")
    if res.velocity_enu is not None:
        v_true = _truth_velocity_enu(truth, res.fix.origin_lla)
        fdoa_err = res.fdoa_hz - _planted_fdoa_hz(res, truth)
        out.update(vel_err_mps=(res.velocity_enu - v_true).tolist(),
                   vel_sigma_mps=res.velocity_sigma_enu.tolist(),
                   fdoa_err_hz=fdoa_err.tolist())
        print(f"    velocity {np.round(res.velocity_enu, 2).tolist()} m/s "
              f"(planted {np.round(v_true, 2).tolist()}, 1σ "
              f"{np.round(res.velocity_sigma_enu, 2).tolist()}); FDOA "
              f"{np.round(res.fdoa_hz, 3).tolist()} Hz, err "
              f"{np.round(fdoa_err, 3).tolist()}")
    for k, e in enumerate(res.emitters or []):
        # Against the transmitter whose TDOAs the set is nearer to.
        errs = {"mover": e.tdoa_samples - want}
        if truth["tau_int"] is not None:
            ti = truth["tau_int"]
            errs["interferer"] = e.tdoa_samples - np.array(
                [ti[names[j]] - ti[names[i]] for i, j in res.pair_idx])
        tx = min(errs, key=lambda t: np.abs(errs[t]).max())
        d_fix = _fix_err_m(e.fix, truth["tgt_lla" if tx == "mover"
                                         else "int_lla"])
        vel = (None if e.velocity_enu is None
               else np.round(e.velocity_enu, 2).tolist())
        sig = (None if e.velocity_sigma_enu is None
               else np.round(e.velocity_sigma_enu, 2).tolist())
        print(f"    emitter {k + 1} (the {tx}): fix {d_fix:.1f} m off, TDOA "
              f"err {np.round(errs[tx], 3).tolist()} samples, velocity "
              f"{vel} m/s (1σ {sig})")
    for w in res.warnings:
        print(f"    warning: {w}")
    return out


def _check_lo_velocity(res, truth, launches):
    """(a): LO compensation and the velocity solve on a mover."""
    import numpy as np

    fails = []
    names = res.station_names
    tau = truth["tau_tgt"]
    err = res.corrected_tdoa_samples - np.array(
        [tau[names[j]] - tau[names[i]] for i, j in res.pair_idx])
    if not np.all(np.abs(err) < 0.5):
        fails.append(f"corrected TDOAs off the truth by {err}")
    if not _fix_err_m(res.fix, truth["tgt_lla"]) < 200.0:
        fails.append("fix more than 200 m from the mover")
    if not any("LO offsets" in w for w in res.warnings):
        fails.append("no LO offsets compensated")
    if not any("deramp-and-correlate" in w for w in res.warnings):
        fails.append("the deramp re-solve was not taken")
    if res.velocity_enu is None:
        fails.append("no velocity")
    else:
        v_err = res.velocity_enu - _truth_velocity_enu(truth,
                                                       res.fix.origin_lla)
        if not np.linalg.norm(v_err) < 5.0:
            fails.append(f"velocity off by {v_err} m/s")
        if not np.all(np.abs(v_err[:2])
                      < 5.0 * res.velocity_sigma_enu[:2] + 1.0):
            fails.append(f"velocity error {v_err} outside 5σ + 1 m/s "
                         f"(σ {res.velocity_sigma_enu})")
        f_err = res.fdoa_hz - _planted_fdoa_hz(res, truth)
        if not np.all(np.abs(f_err) < 1.0):
            fails.append(f"FDOA off the planted Doppler by {f_err} Hz")
    if launches["corr_accum"] < 1 or launches["zoom_probe"] < 1:
        fails.append(f"kernels 1 and 2 not both launched: {launches}")
    return fails


def _check_joint(res, truth, launches, static_fix: bool = True):
    """(b): a mover and a static interferer separated jointly in lag and
    Doppler, each with its own velocity. With ``static_fix`` False the
    static emitter's 1000 m bound is printed, not checked: the
    reference's estimator misses it in half of this scene's
    realizations (ROADMAP Queue 3, "Not faults")."""
    import numpy as np

    em = res.emitters or []
    if len(em) != 2:
        return [f"{len(em)} emitters, want 2"]
    fails = []
    mover = min(em, key=lambda e: _fix_err_m(e.fix, truth["tgt_lla"]))
    static = min(em, key=lambda e: _fix_err_m(e.fix, truth["int_lla"]))
    if mover is static:
        fails.append("one emitter is nearest to both transmitters")
    if not _fix_err_m(mover.fix, truth["tgt_lla"]) < 1000.0:
        fails.append("the mover's fix is more than 1000 m off")
    static_err = _fix_err_m(static.fix, truth["int_lla"])
    if static_fix and not static_err < 1000.0:
        fails.append("the static emitter's fix is more than 1000 m off")
    elif not static_err < 1000.0:
        print(f"   the static emitter's fix {static_err:.1f} m off (phase 6's "
              f"1000 m bound printed, not checked: the reference's own "
              f"estimator misses it here, ROADMAP Queue 3)")
    if mover.velocity_enu is None or static.velocity_enu is None:
        return fails + ["an emitter has no velocity"]
    v_err = mover.velocity_enu - _truth_velocity_enu(truth,
                                                     mover.fix.origin_lla)
    if not np.linalg.norm(v_err) < 10.0:
        fails.append(f"the mover's velocity is off by {v_err} m/s")
    sig = np.maximum(static.velocity_sigma_enu, 1.0)
    if not np.all(np.abs(static.velocity_enu[:2]) < 3.0 * sig[:2] + 2.0):
        fails.append(f"the static emitter moves at {static.velocity_enu} "
                     f"m/s (1σ {static.velocity_sigma_enu})")
    if launches["corr_accum"] < 1 or launches["zoom_probe"] < 1:
        fails.append(f"kernels 1 and 2 not both launched: {launches}")
    return fails


def _device_busy_ms(fn, iters: int) -> float:
    """Device time per call of everything ``fn`` runs on the card
    (kernels and copies), from a ``torch.profiler`` trace of ``iters``
    calls after a warm-up: the device-side rows only (the host op that
    launched a kernel carries the same time as its own)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / iters / 1e3


def _top_device_ops(fn, k: int = 8) -> list:
    """The ``k`` device-side rows of one ``fn`` call's ``torch.profiler``
    trace (after a warm-up) with the most self device time: (name, ms,
    count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)[:k]
    return [(e.key[:70], e.self_device_time_total / 1e3, e.count)
            for e in rows]


def _time_motion_ops(dev):
    """The new stages' device work at the processor's shapes, on a
    10 s bf16 block of 3 stations: ``caf_pairs`` over the default 2^21
    samples and over 2^18 (seg 6144 in FFTs of 8192, 64 Doppler bins),
    ``_derotate`` of the whole block, ``_deramp_correlate`` over 2^21
    samples at max_lag 20000 (kernel 2 at F = 65536) and over 2^18 at
    512 (F = 32768). Event-loop time of a loop of calls (``ms``) beside
    the profiler's device time per call (``device_ms``)."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.ops.caf import caf_pairs
    from tdoa_tpu_torch.pipeline.processor import (
        _deramp_correlate,
        _derotate,
    )

    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(2, 3, BLOCK, device=dev, generator=g)
    x[:, 1] += 0.5 * torch.roll(x[:, 0], 37, dims=-1)
    x[:, 2] += 0.5 * torch.roll(x[:, 0], -12, dims=-1)
    x = x.to(torch.bfloat16)
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    shifts = np.array([12.5, -30.0, 4.0])
    calls = {
        "caf_pairs 2^21": lambda: caf_pairs(
            x[:, :, :1 << 21].to(torch.float32), pairs, FS, max_lag=2048,
            seg_len=1 << 13, n_doppler=64),
        "caf_pairs 2^18": lambda: caf_pairs(
            x[:, :, :1 << 18].to(torch.float32), pairs, FS, max_lag=512,
            seg_len=1 << 13, n_doppler=64),
        "_derotate 10 s block": lambda: _derotate(x, shifts, FS),
        "_deramp_correlate 2^21, max_lag 20000": lambda: _deramp_correlate(
            x, shifts, pairs, 1 << 21, 20000, 1 << 16, "ht", FS),
        "_deramp_correlate 2^18, max_lag 512": lambda: _deramp_correlate(
            x, shifts, pairs, 1 << 18, 512, 1 << 16, "ht", FS),
    }
    out = {}
    for name, fn in calls.items():
        ms = _time_ms(fn, 5)
        dev_ms = _device_busy_ms(fn, 5)
        out[name] = {"ms": ms, "device_ms": dev_ms}
        print(f"time {name}: {ms:.3f} ms a call (device time {dev_ms:.3f} "
              f"ms)")
    del x
    torch.cuda.empty_cache()
    return out


# Phase 6: (scene, its channel, the settings run on it: name, processor
# settings, the check or None for a run that is only printed). The
# checked runs take the settings of the JAX package's own tests of these
# paths (tests/test_fdoa.py): max_lag 512, and a CAF over 2^18 samples.
# At the defaults (max_lag 20000, caf_max_samples 2^21) two estimators
# of the reference are out of their range at full width, and those runs
# are printed beside: the LO probe's coarse pre-alignment correlates
# 2^20 REF samples, across which a pairwise LO offset of a few Hz turns
# the cross-spectrum phase by whole cycles, so its lags are noise and
# the probe is skipped; and the CAF's Doppler grid (64 bins over
# ±1/(2·T_seg), 5.2 Hz) samples the Doppler main lobe (≈ 1/T, 1 Hz over
# 2^21 samples) too coarsely for its parabolic peak.
CHECKED = {"max_lag": 512, "caf_max_samples": 1 << 18}
LO_VEL = {"lo_compensation": "auto", "solve_velocity": True}
VEL_ME = {"solve_velocity": True, "multi_emitter": 2}
MOTION = (
    ("a: LO offsets + mover", dict(lo_ppm=LO_PPM, mover_enu=MOVER_ENU), (
        ("LO + velocity", {**LO_VEL, **CHECKED}, _check_lo_velocity),
        ("velocity, LO off", {"solve_velocity": True, **CHECKED}, None),
        ("LO compensation alone", {"lo_compensation": "auto", **CHECKED},
         None),
        ("LO + velocity at the defaults", LO_VEL, None),
    )),
    ("b: mover + static interferer",
     dict(mover_enu=MOVER_ENU, interferer_lla=INTERFERER_LLA), (
         ("velocity + multi-emitter 2", {**VEL_ME, **CHECKED}, _check_joint),
         ("multi-emitter 2 alone (lag-only)", {"multi_emitter": 2, **CHECKED},
          None),
         ("velocity + multi-emitter 2 at the defaults", VEL_ME, None),
     )),
)
MOTION_ROUNDS = 3


def phase_motion(dev):
    """Phase 6: each scene's settings and the plain fused path on the
    same files, a warm-up each, then ``MOTION_ROUNDS`` rounds in turns
    with every launch count set to 0 before each run and read after it;
    checks on the first round's results, median times over the rounds."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.utils.profiling import StageTimer

    print("== phase 6: LO compensation, CAF/velocity, multi-emitter")
    (ROOT / "build").mkdir(exist_ok=True)
    counters = _counters()
    paths_out, timing, fails = {}, {}, []
    for scene, channel, settings in MOTION:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
        try:
            t0 = time.perf_counter()
            files, truth = _synthesize(dev, tmp, prefix="motion", **channel)
            torch.cuda.synchronize()
            print(f"-- scene {scene}: synthesized in "
                  f"{time.perf_counter() - t0:.1f} s")
            runs = (("fused IQ, no option", {"max_lag": 512}, None),
                    *settings)
            procs = []
            for name, cfg, _ in runs:
                proc = TDOAProcessor.from_csv(
                    REF_FREQ, TGT_FREQ, str(ROOT / "lat-lon-table.csv"),
                    device=dev, **cfg)
                t0 = time.perf_counter()
                proc.process_files(files)  # warm-up: plans, allocator
                print(f"   {name}: first run {time.perf_counter() - t0:.3f} s")
                procs.append(proc)
            walls = {name: [] for name, _, _ in runs}
            stages = {name: [] for name, _, _ in runs}
            first = {}
            for _ in range(MOTION_ROUNDS):
                for (name, cfg, check), proc in zip(runs, procs):
                    proc.timer = StageTimer()
                    _reset_counts(counters)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = proc.process_files(files)
                    walls[name].append(time.perf_counter() - t0)
                    stages[name].append(dict(proc.timer.times))
                    if name not in first:
                        first[name] = (res, _read_counts(counters))
            print(f"   timed in turns, {MOTION_ROUNDS} rounds  [{_smi()}]")
            base = float(np.median(walls[runs[0][0]]))
            timing[scene] = {}
            for name, cfg, check in runs:
                res, (launches, shapes) = first[name]
                med = float(np.median(walls[name]))
                st_med = {k: float(np.median([s.get(k, 0.0)
                                              for s in stages[name]]))
                          for k in stages[name][0]}
                print(f"-- {scene} | {name}: process_files median {med:.3f} s "
                      f"(runs {[round(w, 3) for w in walls[name]]}; "
                      f"{med - base:+.3f} s against the plain fused path); "
                      f"stages {({k: round(v, 4) for k, v in st_med.items()})}; "
                      f"launches {launches}, kernel 1 {shapes['k1_shapes']}, "
                      f"kernel 2 {shapes['k2_shapes']}")
                nums = _report(name, res, truth)
                timing[scene][name] = {"wall_s": walls[name],
                                       "median_s": med, "stages_s": st_med}
                if launches["fm_demod"]:
                    fails.append(f"{scene} | {name}: kernel 3 launched")
                # Every run of a scene with a check is held to it; only
                # the checked run's failures fail the phase.
                judge = check or next((c for _, _, c in settings if c), None)
                if judge is not None and cfg.get("solve_velocity"):
                    bad = judge(res, truth, launches)
                    print(f"   checks{'' if check else ' (printed only)'}: "
                          f"{'pass' if not bad else bad}")
                    if check is not None:
                        fails += [f"{scene} | {name}: {b}" for b in bad]
                if len(cfg) > 1:
                    paths_out[f"{scene} | {name}"] = {
                        "wall_s": med, "launches": launches, **shapes,
                        **nums}
            del procs
            torch.cuda.empty_cache()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    ops = _time_motion_ops(dev)
    print(json.dumps({"motion": timing, "motion_ops": ops}))
    if fails:
        raise RuntimeError("phase 6: " + "; ".join(fails))
    return paths_out


# Phase 7: audio-pattern matching on scenes the port's own simulator
# makes on the card: tests/test_audio_match.py's known-audio scene at
# full width (the TGT emitter broadcasts a 10 s, 44.1 kHz recording of
# 10 kHz band-limited noise, peak 0.8, FM at 50 kHz deviation), checked
# at the reference tests' max_lag 1024 with their bounds.
AUDIO_FS = 44100.0
AUDIO_DEV = 50e3
AM_MAX_LAG = 1024
# The checked runs' LO search span. The rf domain's CAF sums a whole
# 10 s block coherently, so its Doppler main lobe is 1/T = 0.1 Hz wide;
# the reference's 64 bins over the default ±200 Hz sit 6.3 Hz apart and
# miss it (a partial or collapsed rf match; on 2^17-sample blocks, the
# reference tests' length, the lobe is 15 Hz and the grid resolves it).
# ±1.5 Hz puts the bins 0.048 Hz apart; the scenes plant no LO offsets.
# The runs at the default span are printed beside, not checked.
AM_LO_SPAN = 1.5
AM_TDOA_TOL = 4.0  # samples, corrected TDOA against the truth
AM_FIX_TOL = 4000.0  # m, the audio-domain fix
AM_MODES = ("audio", "rf", "auto")
AM_ROUNDS = 3
CLI_TIMEOUT_S = 300


def _audio_scene(dev, audio44, block: int = BLOCK, **kw):
    """The known-audio scene over ``lat-lon-table.csv`` (KEVO the target,
    the other callsign rows the receivers), three blocks of ``block``
    samples (30 s by default), the smoke's clock offsets, the recording
    resampled to the capture rate on the card."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.dsp.filters import resample_fft
    from tdoa_tpu_torch.io.stations import load_station_table
    from tdoa_tpu_torch.sim import SimScene

    table = load_station_table(str(ROOT / "lat-lon-table.csv"),
                               reference_freq=REF_FREQ)
    names = tuple(n for n in table.names if n != "KEVO")
    n_res = int(round(len(audio44) * FS / AUDIO_FS))
    audio_fs = resample_fft(torch.from_numpy(audio44).to(dev),
                            n_res).cpu().numpy()
    return SimScene(
        station_names=names, station_lla=table.lla_array(names),
        ref_tx_lla=table.reference_tx.lla(), tgt_tx_lla=table["KEVO"].lla(),
        ref_freq=REF_FREQ, tgt_freq=TGT_FREQ, sample_rate=FS,
        block_len=block, clock_offsets_s=np.array(CLOCK_OFFSETS_S),
        tgt_audio=audio_fs, tgt_deviation_hz=AUDIO_DEV, seed=SEED, **kw)


def _truth_errors(res, names, truth):
    """Corrected TDOAs of ``res`` minus the scene's geometric TGT TDOAs
    (``names``: the scene's station order of ``truth``)."""
    import numpy as np

    tau = dict(zip(names, truth.station_delays_samples[:, 1]))
    return np.asarray(res.corrected_tdoa_samples) - np.array(
        [tau[res.station_names[j]] - tau[res.station_names[i]]
         for i, j in res.pair_idx])


def _check_audio_match(mode, res, err, fix_err, launches, shapes,
                       block: int = BLOCK, k1_shape=BATCH_SHAPE):
    """tests/test_audio_match.py's bounds, and the kernels each domain
    runs: kernel 1 three times at ``k1_shape`` (the pairwise pass),
    kernel 3 once at (4, block, 8) when the audio domain runs, never in
    the rf domain."""
    import numpy as np

    fails = []
    if not np.all(np.abs(err) < AM_TDOA_TOL):
        fails.append(f"corrected TDOAs off the truth by {err}")
    if mode == "audio" and not fix_err < AM_FIX_TOL:
        fails.append(f"fix {fix_err:.1f} m from the transmitter")
    agree = res.corrected_tdoa_samples - res.pairwise.corrected_tdoa_samples
    if not np.all(np.abs(agree) < AM_TDOA_TOL):
        fails.append(f"template and pairwise TDOAs {agree} apart")
    if not res.covered_fraction > 0.99:
        fails.append(f"covered fraction {res.covered_fraction}")
    if mode == "auto" and (res.mode_used != "audio" or any(
            "escalated" in w for w in res.warnings)):
        fails.append(f"auto escalated to {res.mode_used}")
    if launches["corr_accum"] != 3 or shapes["k1_shapes"] != {
            str(tuple(k1_shape)): 3}:
        fails.append(f"pairwise pass: kernel 1 {shapes['k1_shapes']}")
    k3 = {} if mode == "rf" else {str((4, block, FM_DECIM)): 1}
    if launches["fm_demod"] != len(k3) or shapes["k3_shapes"] != k3:
        fails.append(f"kernel 3 launched {shapes['k3_shapes']}, want {k3}")
    return fails


def _cli(*argv):
    """Run one of the port's CLIs in its own process from the checkout;
    its output, or an error with the end of it."""
    r = subprocess.run([sys.executable, "-m", *argv], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    if r.returncode != 0:
        raise RuntimeError(f"{argv[0]} exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return r.stdout


def _peak_line(text):
    """caf_search's (delay samples, Doppler Hz) from its "peak:" line."""
    import re

    m = re.search(r"peak: delay (\S+) samples .*Doppler (\S+) Hz", text)
    return float(m.group(1)), float(m.group(2))


def _template_phase_error(dev, audio, fs_w, block: int = BLOCK):
    """The largest phase error of the card's template of ``block``
    samples (f32 resampling and cumulative sum) against the same
    template in float64 on the card, radians."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.pipeline.audio_match import template_iq

    tpl, _ = template_iq(audio, fs_w, block, FS, AUDIO_DEV, device=dev)
    a = torch.from_numpy(np.asarray(audio, np.float64)).to(dev)
    n_in = int(a.shape[0])
    n_res = int(round(n_in * FS / fs_w))  # upsampled, then cut to block
    spec = torch.nn.functional.pad(torch.fft.rfft(a),
                                   (0, n_res // 2 + 1 - (n_in // 2 + 1)))
    if n_in % 2 == 0:  # an even input's Nyquist bin splits in two
        spec[n_in // 2] *= 0.5
    a = torch.fft.irfft(spec, n=n_res)[:block] * (n_res / n_in)
    phase = torch.cumsum(a, 0) * (2 * np.pi * AUDIO_DEV / FS)
    err = torch.atan2(tpl[1], tpl[0]).double() - phase
    err = torch.remainder(err + np.pi, 2 * np.pi) - np.pi
    return float(err.abs().max()), float(phase.abs().max())


def phase_audio_match(dev):
    """Phase 7: the known-audio scene through ``match_captures`` in every
    mode (in turns with the plain ``process_files``), the CLI beside it,
    the rf domain's memory and device time; the FM-threshold scene; the
    simulator, processor and caf_search CLIs."""
    import argparse as _argparse

    import numpy as np
    import torch

    from tdoa_tpu_torch.cli import simulator as sim_cli
    from tdoa_tpu_torch.io.wav import read_wav, write_wav
    from tdoa_tpu_torch.ops.caf import caf_pairs
    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.ops.kernels.fm_demod import fm_demod_decimate
    from tdoa_tpu_torch.pipeline.audio_match import (
        _median,
        _template_pairs,
        _with_template,
        match_captures,
        match_template_audio,
        match_template_rf,
        rf_segment,
        template_iq,
    )
    from tdoa_tpu_torch.sim import (
        IDEAL_PROFILE,
        NoiseProfile,
        simulate_scene,
        write_scene_captures,
    )
    from tdoa_tpu_torch.sim.scene import compute_truth
    from tdoa_tpu_torch.sim.source import bandlimited_noise
    from tdoa_tpu_torch.utils.profiling import StageTimer

    print("== phase 7: audio-pattern matching and the simulator")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    csv = str(ROOT / "lat-lon-table.csv")
    counters = _counters()
    paths_out, fails, report = {}, [], {}
    try:
        # (a) the known recording, its WAV, the scene's .dat files
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(SEED)
        a = bandlimited_noise(int(10 * AUDIO_FS), 10e3, AUDIO_FS, g)
        audio44 = (0.8 * a / a.abs().max()).cpu().numpy()
        wav = tmp / "recording.wav"
        write_wav(str(wav), AUDIO_FS, audio44)
        fs_w, audio = read_wav(str(wav))
        sc = _audio_scene(dev, audio44)
        files_map, truth = write_scene_captures(sc, str(tmp), prefix="am-",
                                                device=dev)
        files = sorted(files_map.values())
        torch.cuda.synchronize()
        print(f"-- (a) known-audio scene: recording {len(audio)} samples at "
              f"{fs_w:.0f} Hz; simulated on the card and written in "
              f"{time.perf_counter() - t0:.1f} s")
        proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, csv, device=dev,
                                      max_lag=AM_MAX_LAG)
        plain = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, csv, device=dev,
                                       max_lag=AM_MAX_LAG)

        def run(mode):
            if mode == "plain":
                return plain.process_files(files)
            caps = proc.load_files(files)
            return match_captures(proc, caps, audio, fs_w, mode=mode,
                                  deviation_hz=AUDIO_DEV,
                                  lo_span_hz=AM_LO_SPAN)

        runs = ("plain", *AM_MODES)
        for mode in runs:
            t0 = time.perf_counter()
            run(mode)  # warm-up: plans, allocator
            print(f"   {mode}: first run {time.perf_counter() - t0:.3f} s")
        walls = {m: [] for m in runs}
        stages = {m: [] for m in runs}
        first = {}
        for _ in range(AM_ROUNDS):
            for mode in runs:
                timer = StageTimer()
                plain.timer = proc.timer = timer
                _reset_counts(counters)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = run(mode)  # results are host arrays: synced
                walls[mode].append(time.perf_counter() - t0)
                stages[mode].append(dict(timer.times))
                if mode not in first:
                    first[mode] = (res, _read_counts(counters))
        print(f"   timed in turns, {AM_ROUNDS} rounds  [{_smi()}]")
        base = float(np.median(walls["plain"]))
        timing = {}
        for mode in runs:
            res, (launches, shapes) = first[mode]
            med = float(np.median(walls[mode]))
            st_med = {k: float(np.median([s_.get(k, 0.0)
                                          for s_ in stages[mode]]))
                      for k in stages[mode][0]}
            timing[mode] = {"wall_s": walls[mode], "median_s": med,
                            "stages_s": st_med}
            print(f"-- audio match | {mode}: capture→fix median {med:.3f} s "
                  f"(runs {[round(w, 3) for w in walls[mode]]}; "
                  f"{med - base:+.3f} s against process_files); stages "
                  f"{({k: round(v, 4) for k, v in st_med.items()})}; "
                  f"launches {launches}, kernel 1 {shapes['k1_shapes']}, "
                  f"kernel 3 {shapes['k3_shapes']}")
            if mode == "plain":
                continue
            err = _truth_errors(res, sc.station_names, truth)
            fix_err = _fix_err_m(res.fix, sc.tgt_tx_lla)
            lo = ("" if res.lo_offset_hz is None else
                  f"; LO offsets {np.round(res.lo_offset_hz, 3).tolist()} Hz")
            print(f"   mode_used {res.mode_used}; TDOA err "
                  f"{np.round(err, 4).tolist()} samples; fix {fix_err:.1f} m; "
                  f"template − pairwise "
                  f"{np.round(res.corrected_tdoa_samples - res.pairwise.corrected_tdoa_samples, 4).tolist()}; "
                  f"PSR {np.round(res.station_quality, 1).tolist()}; covered "
                  f"{res.covered_fraction:.4f}{lo}")
            for w in res.warnings:
                print(f"   warning: {w}")
            bad = _check_audio_match(mode, res, err, fix_err, launches, shapes)
            print(f"   checks: {'pass' if not bad else bad}")
            fails += [f"audio match | {mode}: {b}" for b in bad]
            paths_out[f"audio match | {mode}"] = {
                "wall_s": med, "launches": launches, **shapes,
                "tdoa_err_samples": err.tolist(), "fix_err_m": fix_err}
        report["timing"] = timing
        audio_res = first["audio"][0]
        for mode in ("rf", "auto"):
            res = match_captures(proc, proc.load_files(files), audio, fs_w,
                                 mode=mode, deviation_hz=AUDIO_DEV)
            err = _truth_errors(res, sc.station_names, truth)
            lo = (None if res.lo_offset_hz is None
                  else np.round(res.lo_offset_hz, 3).tolist())
            print(f"-- audio match | {mode} at the default LO span ±200 Hz "
                  f"(printed, not checked): mode_used {res.mode_used}; TDOA "
                  f"err {np.round(err, 4).tolist()} samples; PSR "
                  f"{np.round(res.station_quality, 1).tolist()}; LO offsets "
                  f"{lo} Hz")

        # The CLI on the same files and WAV, its own process.
        cli = ["tdoa_tpu_torch.cli.audio_match", str(REF_FREQ), str(TGT_FREQ),
               csv, str(wav), *files, "--deviation", str(AUDIO_DEV)]
        t0 = time.perf_counter()
        out = json.loads(_cli(*cli, "--json", "--max-lag", str(AM_MAX_LAG),
                              "--lo-span", str(AM_LO_SPAN))
                         .strip().splitlines()[-1])
        d_us = float(np.abs(np.array(out["tdoa_us"])
                            - audio_res.tdoa_seconds * 1e6).max())
        d_fix = _fix_err_m(audio_res.fix, np.array(
            [out["fix"]["lat"], out["fix"]["lon"], out["fix"]["elev"]]))
        print(f"-- audio_match CLI --json (max_lag {AM_MAX_LAG}, "
              f"{time.perf_counter() - t0:.1f} s): mode_used "
              f"{out['mode_used']}; tdoa_us {np.round(out['tdoa_us'], 4)}; "
              f"max |CLI − in-process audio mode| {d_us:.3e} µs; fixes "
              f"{d_fix:.3e} m apart")
        if out["stations"] != audio_res.station_names or not d_us < 1e-6 \
                or not d_fix < 0.01:
            fails.append(f"audio_match CLI: {d_us} µs, {d_fix} m from the "
                         f"in-process result")
        text = _cli(*cli)
        print("-- audio_match CLI at the defaults (max_lag 20000; printed, "
              "not checked):")
        for line in text.strip().splitlines():
            print(f"   {line}")

        # The rf domain alone: peak memory and the CAF's device time
        # over the whole 10 s block, at max_lag 1024 and at the default.
        caps = proc.load_files(files)
        tgt = torch.stack([caps[n][1].to(torch.float32)
                           for n in audio_res.station_names], dim=1)
        del caps
        tpl, _ = template_iq(audio, fs_w, BLOCK, FS, AUDIO_DEV, device=dev)
        rf = {}
        for lag, req in ((AM_MAX_LAG, AM_LO_SPAN), (AM_MAX_LAG, 200.0),
                         (20000, 200.0)):
            seg, span = rf_segment(lag, req, FS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            match_template_rf(tgt, tpl, FS, max_lag=lag, lo_span_hz=req)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - held
            x = _with_template(tgt, tpl)
            pairs = _template_pairs(3)
            caf = lambda: caf_pairs(x, pairs, FS, max_lag=lag,  # noqa: E731
                                    seg_len=seg, n_doppler=64,
                                    doppler_span_hz=span, weighting="none")
            key = f"max_lag {lag}, span {span:g} Hz"
            rf[key] = {"seg_len": seg, "span_hz": span,
                       "peak_bytes_above_inputs": peak,
                       "caf_ms": _time_ms(caf, 2),
                       "caf_device_ms": _device_busy_ms(caf, 2)}
            del x
            print(f"-- rf domain at {key}: segment {seg}; peak memory "
                  f"{peak / 1e9:.3f} GB above its inputs; CAF over {BLOCK} "
                  f"samples: {rf[key]['caf_ms']:.3f} ms a call (device time "
                  f"{rf[key]['caf_device_ms']:.3f} ms)  [{_smi()}]")
        report["rf_domain"] = rf
        # The audio domain alone, and its click limiter's medians (two
        # kthvalue selections a median) on the demodulated [4, L/8].
        ax = fm_demod_decimate(_with_template(tgt, tpl), FS, decim=FM_DECIM)
        calls = {
            "match_template_audio": lambda: match_template_audio(
                tgt, tpl, FS, decim=FM_DECIM, max_lag=AM_MAX_LAG,
                seg_len=proc.config.seg_len),
            "_median [4, L/8]": lambda: _median(ax),
        }
        report["audio_domain"] = {}
        for name, fn in calls.items():
            t = {"ms": _time_ms(fn, 3), "device_ms": _device_busy_ms(fn, 3),
                 "top_device_ops": _top_device_ops(fn)}
            report["audio_domain"][name] = t
            print(f"-- audio domain: {name}: {t['ms']:.3f} ms a call "
                  f"(device time {t['device_ms']:.3f} ms); most device "
                  f"time: " + "; ".join(f"{n} {ms:.3f} ms ×{c}" for n, ms, c
                                        in t["top_device_ops"]))
        del ax
        err_ph, span_ph = _template_phase_error(dev, audio, fs_w)
        report["template_phase_err_rad"] = err_ph
        print(f"-- template on the card: phase error against float64 "
              f"{err_ph:.3e} rad (phase reaches {span_ph:.1f} rad)")
        del tgt, tpl
        torch.cuda.empty_cache()

        # (b) FM-threshold channel noise on TGT, in memory.
        sc_b = _audio_scene(dev, audio44, tgt_profile=NoiseProfile(
            signal_amplitude=1.0, noise_amplitude=0.6))
        caps_b, truth_b = simulate_scene(sc_b, device=dev)
        caps_b = {n: caps_b[n] for n in sc_b.station_names}
        for mode, span in (("auto", AM_LO_SPAN), ("audio", AM_LO_SPAN),
                           ("auto", 200.0)):
            _reset_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = match_captures(proc, caps_b, audio, fs_w, mode=mode,
                                 deviation_hz=AUDIO_DEV, lo_span_hz=span)
            wall = time.perf_counter() - t0
            launches, shapes = _read_counts(counters)
            err = _truth_errors(res, sc_b.station_names, truth_b)
            checked = mode == "auto" and span == AM_LO_SPAN
            if span != AM_LO_SPAN:
                mode = f"{mode} at the default LO span (printed)"
            print(f"-- (b) FM-threshold scene | {mode}: {wall:.3f} s; "
                  f"mode_used {res.mode_used}; TDOA err "
                  f"{np.round(err, 3).tolist()} samples; PSR "
                  f"{np.round(res.station_quality, 1).tolist()}; launches "
                  f"{launches}")
            for w in res.warnings:
                print(f"   warning: {w}")
            paths_out[f"audio match, FM threshold | {mode}"] = {
                "wall_s": wall, "launches": launches, **shapes,
                "tdoa_err_samples": err.tolist()}
            if checked and not np.all(np.abs(err) < AM_TDOA_TOL):
                fails.append(f"FM threshold | auto: corrected TDOAs off the "
                             f"truth by {err}")
        del caps_b
        torch.cuda.empty_cache()

        # (c) The simulator CLI's files through the processor and
        # caf_search CLIs, each in its own process.
        sim_dir = tmp / "sim"
        sim_dir.mkdir()
        sim_args = ["--duration-s", "30", "--clock-offsets-us", "12", "-31",
                    "48"]
        t0 = time.perf_counter()
        _cli("tdoa_tpu_torch.cli.simulator", *sim_args, "--out", str(sim_dir))
        sim_files = sorted(str(p_) for p_ in sim_dir.glob("sim-*.dat"))
        print(f"-- simulator CLI: {len(sim_files)} files of "
              f"{Path(sim_files[0]).stat().st_size / 1e6:.0f} MB in "
              f"{time.perf_counter() - t0:.1f} s")
        ap = _argparse.ArgumentParser()
        sim_cli._add_common_args(ap)
        sc_c = sim_cli.build_scene(ap.parse_args(sim_args), IDEAL_PROFILE,
                                   IDEAL_PROFILE)
        truth_c = compute_truth(sc_c)
        out = json.loads(_cli("tdoa_tpu_torch.cli.processor", str(REF_FREQ),
                              str(TGT_FREQ), csv, *sim_files, "--json")
                         .strip().splitlines()[-1])
        tau = dict(zip(sc_c.station_names,
                       truth_c.station_delays_samples[:, 1]))
        err_c = np.array([t * 1e-6 * FS - (tau[b] - tau[a]) for (a, b), t in
                          zip(out["pairs"], out["tdoa_us"])])
        fix_c = _fix_err_m(SimpleNamespace(**out["fix"]), sc_c.tgt_tx_lla)
        print(f"-- processor CLI on them: TDOA err {np.round(err_c, 4)} "
              f"samples, fix {fix_c:.1f} m")
        if not (np.all(np.abs(err_c) < 0.5) and fix_c < 200.0):
            fails.append(f"processor CLI on the simulator's files: {err_c}, "
                         f"{fix_c:.1f} m")
        by_name = {n: f for n in sc_c.station_names for f in sim_files
                   if f"-{n}-" in f}
        a_, b_ = sc_c.station_names[0], sc_c.station_names[2]
        delay, dop = _peak_line(_cli("tdoa_tpu_torch.cli.caf_search",
                                     by_name[a_], by_name[b_]))
        k = [tuple(q) for q in truth_c.pair_idx.tolist()].index((0, 2))
        want = float(truth_c.measured_tgt_delay[k])
        print(f"-- caf_search CLI {a_}-{b_}: delay {delay:+.3f} samples "
              f"(truth {want:+.3f}), Doppler {dop:+.3f} Hz (truth 0)")
        if not (abs(delay - want) < 0.5 and abs(dop) < 1.0):
            fails.append(f"caf_search: delay {delay} (truth {want}), "
                         f"Doppler {dop}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"audio_match": report}))
    if fails:
        raise RuntimeError("phase 7: " + "; ".join(fails))
    return paths_out


# Phase 8: the capture-quality and station tools on phase 4's files and
# on impaired copies of the first one.
TOOL_ROUNDS = 5  # warm runs each tool is timed over (median)
COLLECT_S = 30  # the collector's window, its default


def _impaired(src: str, out_dir: Path) -> dict:
    """Impaired copies of ``src`` made with numpy on the host: {name:
    path}. TGT clipped (scaled ×8 about the centre, clamped to 0/255);
    a dead station (every byte 127/128); +12 bytes of DC on I; the second
    REF block at a quarter of the power (amplitude halved); the file
    truncated by one byte."""
    import numpy as np

    raw = np.fromfile(src, dtype=np.uint8)
    n = 2 * BLOCK  # bytes per block

    def scaled(b, k):
        return np.clip(np.floor((b.astype(np.float32) - 127.5) * k + 128.0),
                       0, 255).astype(np.uint8)

    cases = {}
    x = raw.copy()
    x[n:2 * n] = scaled(x[n:2 * n], 8.0)
    cases["TGT clipped"] = x
    x = np.full_like(raw, 127)
    x[1::2] = 128
    cases["station dead"] = x
    x = raw.copy()
    x[0::2] = np.minimum(x[0::2].astype(np.int16) + 12, 255).astype(np.uint8)
    cases["DC +12 bytes on I"] = x
    x = raw.copy()
    x[2 * n:] = scaled(x[2 * n:], 0.5)
    cases["REF2 at 1/4 power"] = x
    cases["truncated by a byte"] = raw[:-1]
    out = {}
    for k, (name, data) in enumerate(cases.items()):
        out[name] = str(out_dir / f"impaired{k}.dat")
        data.tofile(out[name])
    return out


def _planted_fails(name, a, rep) -> list:
    """What must report each planted impairment: the analysis ``a``
    (default budget) and the structural report ``rep``, both from the
    card."""
    from tdoa_tpu_torch.quality import assess_tdoa_suitability

    _, problems = assess_tdoa_suitability(a)
    has = lambda text, lines: any(text in p_ for p_ in lines)  # noqa: E731
    want = {
        "TGT clipped": (a.tgt.is_clipping and not a.ref.is_clipping
                        and has("TGT: ADC clipping", problems)),
        "station dead": (a.ref.is_dead and a.tgt.is_dead and all(
            has(f"block {b}: dead receiver", rep.problems) for b in (1, 2, 3))),
        "DC +12 bytes on I": (a.ref.dc_offset_i > 10 and all(
            has(f"block {b}: heavy DC bias", rep.problems) for b in (1, 2, 3))),
        "REF2 at 1/4 power": (not rep.ref_power_consistent
                              and has("power-inconsistent", rep.problems)),
        "truncated by a byte": (not rep.three_block_pattern_ok and has(
            "does not form 3 equal whole-sample blocks", rep.problems)),
    }.get(name, rep.ok)  # phase 4's files: no problem
    return [] if want else [f"{name}: not reported ({rep.problems}, "
                            f"{problems})"]


def _stats_diffs(what, card, cpu) -> list:
    """One block's metrics, card against CPU: equal byte fractions,
    min/max bytes and flags; DC within 1e-3 bytes; power within 1e-5
    relative; SNR within 1e-2 dB. A dead block is a constant whose
    "noise" bins hold only each FFT's rounding: where the CPU reads its
    SNR above 120 dB, the card must too."""
    bad = [f for f in ("clip_fraction", "overload_fraction", "dead_fraction",
                       "min_byte", "max_byte", "is_clipping", "is_overloaded",
                       "is_dead", "is_noisy")
           if getattr(card, f) != getattr(cpu, f)]
    if max(abs(card.dc_offset_i - cpu.dc_offset_i),
           abs(card.dc_offset_q - cpu.dc_offset_q)) >= 1e-3:
        bad.append("dc")
    if abs(card.power - cpu.power) > 1e-5 * cpu.power:
        bad.append("power")
    if cpu.is_dead and cpu.snr_db > 120.0:
        if not card.snr_db > 120.0:
            bad.append("snr_db")
    elif not abs(card.snr_db - cpu.snr_db) < 1e-2:
        bad.append("snr_db")
    return [f"{what}: card and CPU differ in {bad}"] if bad else []


def _tool(main, argv):
    """One CLI's ``main`` in this process: (exit code, stdout, stderr)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _median_wall(fn):
    """(median, all) host seconds of ``TOOL_ROUNDS`` warm calls, the card
    synchronised before and after each."""
    import numpy as np
    import torch

    walls = []
    for _ in range(TOOL_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), walls


def phase_tools(dev, files, truth, tmp: Path):
    """Phase 8: the quality pass (card against CPU, planted impairments),
    the tools' CLIs, gain calibration, a 30 s collector window, the
    correlation checks, coverage, and the processor's ``--profile`` and
    ``--trace``."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.calib import SimCaptureBackend, calibrate
    from tdoa_tpu_torch.cli import (analyzer, collector, correlation_sanity,
                                    coverage, fast_analyzer, gain_calibrator,
                                    processor, reader, simple_corr,
                                    snr_analysis)
    from tdoa_tpu_torch.quality import analyze_capture, validate_dat_structure
    from tdoa_tpu_torch.quality.analyzer import fast_csv_line

    print("== phase 8: capture quality and station tools")
    csv = str(ROOT / "lat-lon-table.csv")
    fails, report = [], {}
    t0 = time.perf_counter()
    impaired = _impaired(files[0], tmp)
    print(f"-- {len(impaired)} impaired copies of {Path(files[0]).name} "
          f"written in {time.perf_counter() - t0:.1f} s")

    # (a) The quality pass on every file, card against CPU.
    targets = {**{f"phase 4 {Path(f).name}": f for f in files}, **impaired}
    card_runs = {}
    worst = {"snr_db": 0.0, "dc_bytes": 0.0, "power_rel": 0.0}
    for name, path in targets.items():
        runs = {}
        for d in (dev, "cpu"):
            runs[str(d)] = (
                analyze_capture(path, device=d),
                analyze_capture(path, max_samples_per_block=BLOCK, device=d),
                validate_dat_structure(path, device=d))
        (a, whole, rep), (a_c, whole_c, rep_c) = runs[str(dev)], runs["cpu"]
        card_runs[name] = (a, rep)
        diffs = []
        for what, x, y in (("default REF", a.ref, a_c.ref),
                           ("default TGT", a.tgt, a_c.tgt),
                           ("whole-block REF", whole.ref, whole_c.ref),
                           ("whole-block TGT", whole.tgt, whole_c.tgt),
                           *((f"validate block {b + 1}", x, y) for b, (x, y)
                             in enumerate(zip(rep.block_stats,
                                              rep_c.block_stats)))):
            diffs += _stats_diffs(f"{name} | {what}", x, y)
            if not y.is_dead:
                worst["snr_db"] = max(worst["snr_db"], abs(x.snr_db - y.snr_db))
            worst["dc_bytes"] = max(worst["dc_bytes"],
                                    abs(x.dc_offset_i - y.dc_offset_i),
                                    abs(x.dc_offset_q - y.dc_offset_q))
            worst["power_rel"] = max(worst["power_rel"],
                                     abs(x.power - y.power) / y.power)
        if rep.problems != rep_c.problems:
            diffs.append(f"{name}: problems differ: {rep.problems} / "
                         f"{rep_c.problems}")
        diffs += _planted_fails(name, a, rep)
        fails += diffs
        print(f"-- {name}: REF SNR {a.ref.snr_db:.2f} dB (whole block "
              f"{whole.ref.snr_db:.2f}), TGT {a.tgt.snr_db:.2f} "
              f"({whole.tgt.snr_db:.2f}); DC I {a.ref.dc_offset_i:+.3f}; clip "
              f"TGT {a.tgt.clip_fraction:.6f}; dead REF "
              f"{a.ref.dead_fraction:.4f}; problems {rep.problems}; card = "
              f"CPU: {'yes' if not diffs else diffs}")

    report["card_vs_cpu_worst"] = worst
    print(f"-- card against CPU over {len(targets)} files, every block: "
          f"fractions, min/max bytes and flags equal; largest |ΔSNR| "
          f"{worst['snr_db']:.3e} dB (dead blocks aside), |ΔDC| "
          f"{worst['dc_bytes']:.3e} bytes, |Δpower| "
          f"{worst['power_rel']:.3e} relative")

    # Times of the quality pass on one file: host wall and device time
    # (the profiler's device rows: kernels and memsets, not the copy);
    # the pageable host→card copy of its bytes alone beside it (CUDA
    # events).
    f0 = files[0]
    passes = {  # name: (the pass, the shape of the byte rows it copies)
        "analyze_capture (2^21 samples a block)": (
            lambda: analyze_capture(f0, device=dev), (2, 2 << 21)),
        "analyze_capture (whole 10 s block)": (
            lambda: analyze_capture(f0, max_samples_per_block=BLOCK,
                                    device=dev), (2, 2 * BLOCK)),
        "validate_dat_structure (2^20)": (
            lambda: validate_dat_structure(f0, device=dev), (3, 2 << 20)),
    }
    report["quality_pass"] = {}
    for name, (fn, shape) in passes.items():
        fn()  # warm-up: cuFFT plans
        med, walls = _median_wall(fn)
        rows = np.zeros(shape, np.uint8)
        ops = _top_device_ops(fn, 1000)  # every device row of one call
        t = {"wall_s": walls, "median_s": med,
             "device_ms": _device_busy_ms(fn, 3),
             "device_ops": sum(c for _, _, c in ops),
             "top_device_ops": ops[:12],
             "copy_ms": _time_ms(lambda: torch.from_numpy(rows).to(dev), 3)}
        report["quality_pass"][name] = t
        print(f"-- {name}: median {med * 1e3:.3f} ms of {TOOL_ROUNDS} (runs "
              f"{[round(w * 1e3, 2) for w in walls]}); device time "
              f"{t['device_ms']:.3f} ms in {t['device_ops']} device ops; the "
              f"pageable host→card copy of its "
              f"{rows.nbytes / 1e6:.1f} MB alone {t['copy_ms']:.3f} ms; most "
              f"device time: " + "; ".join(
                  f"{n} {ms:.3f} ms ×{c}" for n, ms, c in t["top_device_ops"])
              + f"  [{_smi()}]")

    # (b) The CLIs as a user runs them (own processes, in parallel): exit
    # codes against what the card's in-process results say.
    a0, rep0 = card_runs[f"phase 4 {Path(f0).name}"]
    jobs = {
        "analyzer": (["tdoa_tpu_torch.cli.analyzer", f0],
                     0 if a0.suitable else 1),
        "analyzer, TGT clipped": (
            ["tdoa_tpu_torch.cli.analyzer", impaired["TGT clipped"]], 1),
        "fast_analyzer": (["tdoa_tpu_torch.cli.fast_analyzer", f0], 0),
        "reader": (["tdoa_tpu_torch.cli.reader", f0, str(3 * BLOCK / FS)],
                   0 if rep0.ok else 1),
        "reader, truncated": (["tdoa_tpu_torch.cli.reader",
                               impaired["truncated by a byte"]], 1),
    }
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen([sys.executable, "-m", *argv], cwd=str(ROOT),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (argv, _) in jobs.items()}
    outs = {}
    try:
        for k, p_ in procs.items():
            outs[k] = (*p_.communicate(timeout=CLI_TIMEOUT_S), p_.returncode)
    finally:
        for p_ in procs.values():
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    print(f"-- the CLIs in their own processes, in parallel: "
          f"{time.perf_counter() - t0:.1f} s")
    for k, (out, err, rc) in outs.items():
        want = jobs[k][1]
        print(f"   {k}: exit {rc} (want {want}); last line "
              f"{out.strip().splitlines()[-1] if out.strip() else err[-300:]!r}")
        if rc != want:
            fails.append(f"{k} CLI exited {rc}, want {want}: {err[-500:]}")
    csv_line = fast_csv_line(analyze_capture(
        f0, nfft=8192, max_samples_per_block=32768, device=dev))
    if outs["fast_analyzer"][0].strip() != csv_line:
        fails.append(f"fast_analyzer CLI printed {outs['fast_analyzer'][0]!r},"
                     f" in-process {csv_line!r}")

    # (c) Gain calibration, card against CPU.
    cal = {str(d): calibrate(SimCaptureBackend(), REF_FREQ, TGT_FREQ,
                             device=d) for d in (dev, "cpu")}
    for r_card, r_cpu in zip(cal[str(dev)], cal["cpu"]):
        same = ([g for g, _ in r_card.history] == [g for g, _ in r_cpu.history]
                and all(abs(s1 - s2) < 1e-2 for (_, s1), (_, s2)
                        in zip(r_card.history, r_cpu.history)))
        print(f"-- gain calibration {r_card.freq_hz / 1e6:.1f} MHz on the "
              f"card: gain {r_card.gain_db:.2f} dB, SNR {r_card.snr_db:.3f} "
              f"dB, converged {r_card.converged} in {r_card.iterations}; "
              f"history {[(g, round(s_, 3)) for g, s_ in r_card.history]}; "
              f"same as the CPU's: {same}")
        if not (same and r_card.converged and r_cpu.converged):
            fails.append(f"gain calibration {r_card.freq_hz}: card "
                         f"{r_card.history}, CPU {r_cpu.history}")

    # (d) Each tool in this process, warm, on the card: exit code, what it
    # must print, median wall time of TOOL_ROUNDS runs.
    coll_dir = tmp / "collector"
    coll_dir.mkdir()

    def collect():
        for old in coll_dir.glob("*.dat"):
            old.unlink()
        return _tool(collector.main, [
            str(REF_FREQ), str(TGT_FREQ), "0", "kx0u", "--backend", "sim",
            "--duration", str(COLLECT_S), "--out", str(coll_dir)])

    tools = {
        "analyzer": (lambda: _tool(analyzer.main, [f0]),
                     0 if a0.suitable else 1, "TDOA suitability"),
        "fast_analyzer": (lambda: _tool(fast_analyzer.main, [f0]), 0, "TGT,"),
        "reader": (lambda: _tool(reader.main, [f0, str(3 * BLOCK / FS)]),
                   0 if rep0.ok else 1, "RESULT:"),
        "gain_calibrator --backend sim": (
            lambda: _tool(gain_calibrator.main, [str(REF_FREQ), str(TGT_FREQ),
                                                 "--backend", "sim"]),
            0, "tdoa_tpu_torch.cli.collector --gain1"),
        f"collector --backend sim --duration {COLLECT_S}": (collect, 0,
                                                            "Validated:"),
        "simple_corr": (lambda: _tool(simple_corr.main, []), 0, "ALL PASS"),
        "correlation_sanity (30 s file)": (
            lambda: _tool(correlation_sanity.main, [f0]), 0, "\nPASS"),
        "coverage": (lambda: _tool(coverage.main, [csv]), 0,
                     "Coverage map:"),
        "snr_analysis": (lambda: _tool(snr_analysis.main, []), 0,
                         "Coherent integration gain"),
    }
    report["tools"] = {}
    for name, (fn, want_rc, must_print) in tools.items():
        rc, out, err = fn()  # warm-up, and the run that is checked
        ok = rc == want_rc and must_print in out
        if name.startswith("collector"):
            made = list(coll_dir.glob("kx0u-*.dat"))
            ok = ok and len(made) == 1 and made[0].stat().st_size == \
                2 * 3 * (COLLECT_S * int(FS) // 3)
        if name.startswith("gain"):
            ok = ok and out.count("(converged,") == 2
        med, walls = _median_wall(fn)
        report["tools"][name] = {"rc": rc, "median_s": med, "wall_s": walls}
        last = out.strip().splitlines()[-1] if out.strip() else err[-300:]
        print(f"-- {name}: exit {rc}; median {med:.3f} s of {TOOL_ROUNDS} "
              f"warm runs (runs {[round(w, 3) for w in walls]}); last line "
              f"{last!r}  [{_smi()}]")
        if not ok:
            fails.append(f"{name}: exit {rc}, output {out[-800:]!r} "
                         f"{err[-500:]!r}")

    # (e) The processor CLI's --profile and --trace on phase 4's files.
    counters = _counters()
    args = [str(REF_FREQ), str(TGT_FREQ), csv, *files, "--json"]
    _tool(processor.main, args)  # warm-up
    paths_out = {}
    trace_dir = tmp / "trace"
    for label, extra in (("processor --profile", ["--profile"]),
                         ("processor --trace", ["--trace", str(trace_dir)])):
        _reset_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc, out, err = _tool(processor.main, [*args, *extra])
        wall = time.perf_counter() - t0
        launches, shapes = _read_counts(counters)
        res = json.loads(out.strip().splitlines()[-1])
        fix_err = _fix_err_m(SimpleNamespace(**res["fix"]), truth["tgt_lla"])
        print(f"-- {label}: exit {rc}, {wall:.3f} s, fix {fix_err:.1f} m "
              f"from the planted transmitter; launches {launches}, kernel 1 "
              f"{shapes['k1_shapes']}, kernel 2 {shapes['k2_shapes']}")
        paths_out[label] = {"wall_s": wall, "launches": launches, **shapes,
                            "fix_err_m": fix_err}
        if rc != 0 or not fix_err < 200.0:
            fails.append(f"{label}: exit {rc}, fix {fix_err:.1f} m: "
                         f"{err[-500:]}")
        if (launches["corr_accum"], launches["zoom_probe"],
                launches["fm_demod"]) != (3, 3, 0):
            fails.append(f"{label}: launches {launches}")
        if label.endswith("--profile"):
            report_text = err.split("stage timings:\n", 1)[-1]
            for line in report_text.strip().splitlines():
                print(f"   {line}")
            stages = [line.split()[0] for line in
                      report_text.strip().splitlines()[1:]]
            if not {"load+decode", "correlate+clock", "solve"} <= set(stages):
                fails.append(f"--profile reported stages {stages}")
    traces = list(trace_dir.glob("trace-*.json"))
    device_names = []  # the names of the trace's device kernel events
    if len(traces) == 1:
        events = json.loads(traces[0].read_text())["traceEvents"]
        device_names = [e["name"] for e in events
                        if e.get("cat") == "kernel"]
    seen = {k: sum(k in n for n in device_names)
            for k in ("corr_accum_kernel", "zoom_probe_kernel")}
    print(f"-- --trace wrote {len(traces)} trace(s), "
          f"{len(device_names)} device kernel events; kernels 1 and 2 "
          f"among them: {seen} "
          f"({sorted({n for n in device_names if 'probe' in n or 'accum' in n})})")
    if not (seen["corr_accum_kernel"] and seen["zoom_probe_kernel"]):
        fails.append(f"--trace: {len(traces)} traces, device kernels "
                     f"{sorted(set(device_names))[:20]}")
    report["trace_kernel_events"] = seen

    # The cost of --profile's stage syncs: capture→fix of the CLI in
    # turns with the plain run.
    walls = {"plain": [], "--profile": []}
    for _ in range(TOOL_ROUNDS):
        for mode, extra in (("plain", []), ("--profile", ["--profile"])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _tool(processor.main, [*args, *extra])
            walls[mode].append(time.perf_counter() - t0)
    med = {m: float(np.median(w)) for m, w in walls.items()}
    report["profile_cost"] = {"walls_s": walls, "median_s": med}
    print(f"-- processor CLI capture→fix in turns, {TOOL_ROUNDS} rounds: "
          f"plain median {med['plain']:.3f} s (runs "
          f"{[round(w, 3) for w in walls['plain']]}), --profile "
          f"{med['--profile']:.3f} s (runs "
          f"{[round(w, 3) for w in walls['--profile']]}): "
          f"{med['--profile'] - med['plain']:+.3f} s  [{_smi()}]")
    print(json.dumps({"tools": report}))
    if fails:
        raise RuntimeError("phase 8: " + "; ".join(fails))
    return paths_out


# Phase 9: worlds of 1 rank (NCCL) and of 2 and 4 ranks sharing the card
# (gloo on CUDA tensors), both routes in each.
SHARD_WORLDS = (1, 2, 4)
SHARD_ROUTES = ("pallas", "xla")
# The segmented route's segment: the kernel's own (45056 + max_lag 20000
# fits its 65536-point FFT), so the 440-segment capture splits into
# whole segments over every world.
SHARD_SEG_LEN = 45056
SHARD_TOL = 1e-3  # samples, sharded against unsharded


def _host_blocks(paths, n_use: int, block: int = BLOCK):
    """The files' three ``block``-sample blocks (phase 4's by default) as
    planar f32 [2, n_st, n_use] host tensors (REF₁, TGT, REF₂), each cut
    to its first ``n_use`` samples."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.io.datfile import bytes_to_iq_planar

    raws = [np.fromfile(p, dtype=np.uint8) for p in paths]
    return [torch.stack([bytes_to_iq_planar(torch.from_numpy(
        raw[2 * b * block:2 * b * block + 2 * n_use])) for raw in raws],
        dim=1) for b in range(3)]


def _unsharded(blocks, pairs, geo_d, route: str, max_lag: int):
    """The sharded step's comparator on one card: the kernel route (the
    3·n_st stacked rows of ``blocks``, demeaned, through the fused
    correlator, then clock correction) or the segmented route
    (``process_blocks``); ``process_blocks``' tuple."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.ops.corr import (
        clock_correct_blocks,
        correlate_pairs_fused,
    )
    from tdoa_tpu_torch.pipeline.processor import process_blocks

    if route == "xla":
        return process_blocks(*blocks, pairs, geo_d, max_lag=max_lag,
                              seg_len=SHARD_SEG_LEN, weighting="ht",
                              accumulator="xla")
    n_st, m = int(blocks[0].shape[1]), len(pairs)
    x = torch.cat(blocks, dim=1)
    x -= x.mean(-1, keepdim=True)
    all_pairs = (pairs[None] + np.arange(3)[:, None, None] * n_st
                 ).reshape(-1, 2)
    r = correlate_pairs_fused(x, all_pairs, max_lag=max_lag, weighting="ht")
    return clock_correct_blocks(
        r.delay.reshape(3, m), r.delay_std.reshape(3, m),
        r.quality.reshape(3, m), r.peak_value.reshape(3, m),
        r.corr.reshape(3, m, -1), r.corr_c.reshape(3, m, -1), geo_d)


def _shard_rank(paths, n_use, pairs, geo, max_lag, dryrun,
                routes=SHARD_ROUTES, block: int = BLOCK):
    """One rank of the sharded step on the files' ``block``-sample blocks
    cut to ``n_use`` samples: each of ``routes`` (a warm-up, then a
    timed run with the launch counts set to 0 just before it and read
    just after), the rank's peak device memory; with ``dryrun``, then
    ``parallel.dryrun`` on the world, its launches counted apart."""
    import torch
    import torch.distributed as dist

    from tdoa_tpu_torch.parallel import make_mesh, process_blocks_sharded
    from tdoa_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh = make_mesh()
    blocks = _host_blocks(paths, n_use, block)
    counters = _counters()
    out = {"rank": mesh.rank, "backend": dist.get_backend(mesh.group)}
    for route in routes:
        kw = dict(max_lag=max_lag, seg_len=SHARD_SEG_LEN, accumulator=route)
        process_blocks_sharded(*blocks, pairs, geo, mesh, **kw)
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts(counters)
        t0 = time.perf_counter()
        res = process_blocks_sharded(*blocks, pairs, geo, mesh, **kw)
        corrected = res[0].cpu().numpy()  # waits for the card
        wall = time.perf_counter() - t0
        launches, shapes = _read_counts(counters)
        out[route] = {"corrected": corrected, "std": res[6].cpu().numpy(),
                      "wall_s": wall,
                      "peak_bytes": torch.cuda.max_memory_allocated(),
                      "launches": launches, **shapes}
    if dryrun:
        _reset_counts(counters)
        t0 = time.perf_counter()
        report = dryrun_multichip(mesh.size, "cuda")
        launches, shapes = _read_counts(counters)
        out["dryrun"] = {"report": report, "launches": launches,
                         "wall_s": time.perf_counter() - t0, **shapes}
    return out


def _sum_counts(runs) -> dict:
    """Launch counts of several ranks' runs, summed (kernel and shape)."""
    out = {"launches": {}, **{k: {} for k in SHAPE_KEYS.values()}}
    for r in runs:
        for k, v in r["launches"].items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        for key in SHAPE_KEYS.values():
            for sh, v in r[key].items():
                out[key][sh] = out[key].get(sh, 0) + v
    return out


def phase_sharded(dev, files, truth):
    """Phase 9: ``tdoa_tpu_torch/parallel`` on phase 4's files (their first
    440 kernel segments a block, f32): worlds of 1, 2 and 4 ranks, the
    kernel route and the segmented route in each, against the planted
    truth (0.5 sample) and the unsharded path on the same capture
    (1e-3 sample); each rank's wall time and peak memory; kernel
    launches gathered from the ranks; then ``parallel.dryrun`` on the
    4-rank world."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.parallel.launch import spawn
    from tdoa_tpu_torch.pipeline.processor import TDOAProcessor
    from tdoa_tpu_torch.solve.multilateration import station_pairs
    from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG

    print("== phase 9: the sequence-parallel step (tdoa_tpu_torch/parallel)")
    names = list(truth["tau_tgt"])  # the files' order
    pairs = station_pairs(len(names))
    geo = TDOAProcessor.from_csv(
        REF_FREQ, TGT_FREQ, str(ROOT / "lat-lon-table.csv"), device="cpu",
    )._ref_geo_tdoa_samples(names, pairs).astype(np.float32)
    tau = truth["tau_tgt"]
    want = np.array([tau[names[j]] - tau[names[i]] for i, j in pairs])
    n_use = SHARD_SEGS * SEG_LEN
    max_lag = DEFAULT_MAX_LAG
    paths_out, fails = {}, []

    # The unsharded path on the same capture, on this card: the kernel
    # route (the 9 stacked rows, demeaned, through the fused correlator)
    # and the segmented route (process_blocks).
    blocks = [b.to(dev) for b in _host_blocks(files, n_use)]
    geo_d = torch.as_tensor(geo, device=dev)

    counters = _counters()
    single = {}
    for route in SHARD_ROUTES:
        _unsharded(blocks, pairs, geo_d, route, max_lag)  # warm-up
        torch.cuda.synchronize()
        _reset_counts(counters)
        t0 = time.perf_counter()
        out = _unsharded(blocks, pairs, geo_d, route, max_lag)
        single[route] = out[0].cpu().numpy()
        wall = time.perf_counter() - t0
        launches, shapes = _read_counts(counters)
        err = single[route] - want
        print(f"-- unsharded {route}: {wall:.3f} s, corrected TDOAs "
              f"{single[route].round(4).tolist()} (truth err "
              f"{err.round(4).tolist()}), 1σ "
              f"{out[6].cpu().numpy().round(4).tolist()}; launches "
              f"{launches}, kernel 1 {shapes['k1_shapes']}, kernel 2 "
              f"{shapes['k2_shapes']}")
        paths_out[f"unsharded {route} (phase 9)"] = {
            "wall_s": wall, "launches": launches, **shapes}
        if not np.all(np.abs(err) < 0.5):
            fails.append(f"unsharded {route}: truth err {err}")
    del blocks, out
    torch.cuda.empty_cache()

    for world in SHARD_WORLDS:
        t0 = time.perf_counter()
        ranks = spawn(_shard_rank, world, "cuda", files, n_use, pairs, geo,
                      max_lag, world == max(SHARD_WORLDS))
        print(f"-- {world} rank(s), backend {ranks[0]['backend']}: world "
              f"started, ran and joined in {time.perf_counter() - t0:.1f} s  "
              f"[{_smi()}]")
        for route in SHARD_ROUTES:
            runs = [r[route] for r in ranks]
            dev_single = max(float(np.abs(r["corrected"] - single[route]
                                          ).max()) for r in runs)
            err = runs[0]["corrected"] - want
            wall = max(r["wall_s"] for r in runs)
            counts = _sum_counts(runs)
            print(f"   {route}: corrected TDOAs "
                  f"{runs[0]['corrected'].round(4).tolist()} (truth err "
                  f"{err.round(4).tolist()}, max |Δ| vs unsharded "
                  f"{dev_single:.2e}), 1σ "
                  f"{runs[0]['std'].round(4).tolist()}; wall per rank "
                  f"{[round(r['wall_s'], 4) for r in runs]} s, peak memory "
                  f"per rank {[round(r['peak_bytes'] / 2**20, 1) for r in runs]}"
                  f" MiB; launches {counts['launches']}, kernel 1 "
                  f"{counts['k1_shapes']}, kernel 2 {counts['k2_shapes']}")
            paths_out[f"sharded {route}, {world} rank(s)"] = {
                "wall_s": wall, "backend": ranks[0]["backend"],
                "wall_by_rank_s": [r["wall_s"] for r in runs],
                "peak_bytes_by_rank": [r["peak_bytes"] for r in runs],
                "max_dev_vs_unsharded": dev_single,
                "tdoa_err_samples": err.tolist(), **counts}
            if not (dev_single < SHARD_TOL and np.all(np.abs(err) < 0.5)):
                fails.append(f"{route} at {world} ranks: {dev_single:.2e} "
                             f"from unsharded, truth err {err}")
            if route == "pallas" and counts["launches"]["corr_accum"] != world:
                fails.append(f"pallas at {world} ranks: kernel 1 launched "
                             f"{counts['launches']['corr_accum']} times")
            if world > 1 and counts["launches"]["zoom_probe"] != world:
                fails.append(f"{route} at {world} ranks: kernel 2 launched "
                             f"{counts['launches']['zoom_probe']} times")
        dry = [r["dryrun"] for r in ranks if "dryrun" in r]
        if dry:
            worst = max(max(d["report"].values()) for d in dry if
                        d["report"])
            counts = _sum_counts(dry)
            print(f"-- parallel.dryrun on {world} ranks: "
                  f"{dry[0]['report']}; largest |Δ| {worst:.2e}; launches "
                  f"{counts['launches']}, kernel 1 {counts['k1_shapes']}, "
                  f"kernel 2 {counts['k2_shapes']}")
            paths_out[f"parallel.dryrun, {world} ranks"] = {
                "wall_s": max(d["wall_s"] for d in dry), **counts}
            if not worst < SHARD_TOL:
                fails.append(f"dryrun: {dry[0]['report']}")
    print(json.dumps({"sharded": {k: {kk: vv for kk, vv in v.items()
                                      if kk not in SHAPE_KEYS.values()}
                                  for k, v in paths_out.items()}}))
    if fails:
        raise RuntimeError("phase 9: " + "; ".join(fails))
    return paths_out


# Phase 10: the calibration gates of scripts/monte_carlo_torch.py and
# scripts/ellipse_calibration_torch.py, reduced: the first trials of
# every Monte Carlo regime and of every gated ellipse regime, at the
# scripts' own seeds, gated as the scripts gate.
CAL_MC_TRIALS = 2
CAL_ELLIPSE_TRIALS = 4
# The calibration scripts, reduced: the ghost harness's gather at 1
# trial a regime from a base whose trial 0 of clean, noisy and moving is
# a ghost-ambiguous geometry, and the multipath capture at 2 trials; the
# multipath fit over the repository's bases (calib_data/README.md).
CAL_GHOST_SEED = 42500
CAL_MP_SEED, CAL_MP_TRIALS = 150000, 2
CAL_MP_FIT = (tuple(f"mp_base_{s}.npz"
                    for s in (9000, 67000, 70000, 71000, 73000)),
              "mp_base_78000.npz")


def _calibration_scripts(counters, tmp: Path) -> tuple:
    """Phase 10's reduced pass of the ghost and multipath calibration
    scripts: (its record, the failures)."""
    import numpy as np

    import ghost_calibration_torch as gc
    import multipath_tailcal_torch as mt

    fails = []
    _reset_counts(counters)
    t0 = time.perf_counter()
    art = tmp / "ghostcal.json"
    gc.main(["gather", "--seed", str(CAL_GHOST_SEED), "--trials", "1",
             "--out", str(art)])
    with open(art) as fh:
        gathered = json.load(fh)
    code = gc.main(["validate", str(art)])
    print(f"   (validate at 1 trial a regime: exit code {code}, printed, not "
          f"gated at this size)")
    base = tmp / "mp_base.npz"
    mt.main(["capture", "--seed", str(CAL_MP_SEED), "--trials",
             str(CAL_MP_TRIALS), "--out", str(base)])
    rows, ind = mt._load_base(str(base))
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    print(f"-- ghost gather ({len(gc.REGIMES)} trials) and multipath capture "
          f"({CAL_MP_TRIALS} trials): {wall:.1f} s, {gathered['n_ghosts']} "
          f"ghost records, {len(rows)} correlated + {len(ind)} "
          f"independent-model multipath rows; launches {launches}, kernel 2 "
          f"{shapes['k2_shapes']}  [{_smi()}]")
    if (gathered["n_trials"] != len(gc.REGIMES)
            or len(rows) + len(ind) > CAL_MP_TRIALS):
        fails.append(f"gather {gathered['n_trials']} trials, capture "
                     f"{len(rows)} + {len(ind)} rows")
    t0 = time.perf_counter()
    cal = ROOT / "calib_data"
    got = mt.fit(SimpleNamespace(bases=[str(cal / b) for b in CAL_MP_FIT[0]],
                                 holdout=str(cal / CAL_MP_FIT[1]), json=None))
    with open(ROOT / "MULTIPATH_CAL_r05.json") as fh:
        want = json.load(fh)
    same = (all(abs(got[k] - want[k]) < 1e-3 for k in ("gamma", "nu"))
            and all(np.allclose(got[k], want[k], atol=1e-3)
                    for k in ("thresholds", "contour_scales"))
            and all(got[k] == want[k] for k in (
                "bases", "pooled_coverage_pct", "pooled_n",
                "pooled_engaged_p50_maha")))
    print(f"-- multipath fit over the repository's bases: "
          f"{time.perf_counter() - t0:.1f} s; reproduces "
          f"MULTIPATH_CAL_r05.json: {same}")
    if not same:
        fails.append("the multipath fit does not reproduce "
                     "MULTIPATH_CAL_r05.json")
    return {"wall_s": wall, "launches": launches, **shapes,
            "ghost_records": gathered["n_ghosts"], "validate_exit": code,
            "mp_rows": len(rows) + len(ind), "fit_reproduced": same}, fails


def phase_calibration(dev, tmp: Path):
    """Phase 10: the calibration sweeps at reduced size on the card, with
    their gates (every Monte Carlo regime at its floor and no silent
    failure; the pooled 3σ coverage of the gated ellipse regimes ≥
    90 %), then the ghost and multipath calibration scripts reduced, and
    the kernels' launches by shape."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import ellipse_calibration_torch as ec
    import monte_carlo_torch as mc

    print("== phase 10: calibration gates, reduced")
    counters = _counters()
    out = {}
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    failed = silent = 0
    for regime, floor in mc.REGIMES.items():
        results = [mc.run_trial(regime, mc.trial_seed(regime, 1000, t), dev)
                   for t in range(CAL_MC_TRIALS)]
        f, s, _, _ = mc.summarize(regime, results, floor)
        failed += f
        silent += s
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    print(f"-- Monte Carlo, {CAL_MC_TRIALS} trials a regime: {wall:.1f} s, "
          f"failed regimes {failed}, silent failures {silent}; launches "
          f"{launches}, kernel 1 {shapes['k1_shapes']}, kernel 2 "
          f"{shapes['k2_shapes']}, kernel 3 {shapes['k3_shapes']}  "
          f"[{_smi()}]")
    out["calibration: Monte Carlo"] = {"wall_s": wall, "launches": launches,
                                       **shapes}
    _reset_counts(counters)
    t0 = time.perf_counter()
    pooled, n_ghost = {}, 0
    for regime in ec.GATED:
        pooled[regime], ghosts = ec.regime_mahas(regime, CAL_ELLIPSE_TRIALS,
                                                 5000, dev)
        n_ghost += ghosts
        print(ec.coverage_line(regime, pooled[regime]), flush=True)
    covered = ec.pooled_gate(pooled, n_ghost)
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    print(f"-- ellipse calibration, {CAL_ELLIPSE_TRIALS} trials a gated "
          f"regime: {wall:.1f} s; launches {launches}, kernel 1 "
          f"{shapes['k1_shapes']}, kernel 2 {shapes['k2_shapes']}")
    out["calibration: ellipse"] = {"wall_s": wall, "launches": launches,
                                   **shapes}
    out["calibration: ghost and multipath scripts"], fails = \
        _calibration_scripts(counters, tmp)
    if failed or silent or not covered or fails:
        raise RuntimeError(f"phase 10: {failed} regime(s) below the floor, "
                           f"{silent} silent failure(s), pooled 3σ gate "
                           f"met: {covered}; {'; '.join(fails)}")
    return out


# Phase 11: a 12-station network — the 5 stations of
# tests/test_multistation.py and 7 more within ~25 km of them — under
# the shipped table's REF and KEVO transmitters, each station with its
# own clock offset, and st4's TGT block delayed 160 samples (the
# reference test's planted outlier, ~24 km of range).
NET_STATIONS = (
    ("kx0u", 41.18660274289527, -95.96064116595667, 355.69),
    ("n3pay", 41.24669616513154, -96.08366304481238, 329.0),
    ("kf0mtl", 41.32916620016985, -96.03513381562004, 373.18),
    ("st4", 41.26, -95.90, 340.0), ("st5", 41.36, -96.12, 360.0),
    ("st6", 41.20, -96.16, 345.0), ("st7", 41.15, -96.05, 340.0),
    ("st8", 41.38, -95.95, 350.0), ("st9", 41.30, -96.20, 330.0),
    ("st10", 41.22, -95.85, 345.0), ("st11", 41.40, -96.05, 365.0),
    ("st12", 41.12, -95.92, 330.0))
NET_CLOCK_OFFSETS_S = tuple(1e-6 * v for v in (12, -31, 48, 5, -9, 14, -2,
                                               7, -4, 22, -17, 9))
NET_OUTLIER, NET_SHIFT = "st4", 160
# Phase 12's scene A: the network extended to the sweep's top count, 24
# stations (12 more within ~30 km), each with its own clock offset.
NET24_STATIONS = NET_STATIONS + (
    ("st13", 41.45, -95.98, 350.0), ("st14", 41.08, -96.00, 335.0),
    ("st15", 41.28, -96.25, 340.0), ("st16", 41.33, -95.82, 345.0),
    ("st17", 41.17, -96.22, 330.0), ("st18", 41.43, -96.15, 355.0),
    ("st19", 41.10, -95.84, 340.0), ("st20", 41.47, -96.05, 360.0),
    ("st21", 41.24, -95.78, 345.0), ("st22", 41.05, -96.10, 330.0),
    ("st23", 41.40, -95.88, 350.0), ("st24", 41.31, -96.30, 335.0))
NET24_CLOCK_OFFSETS_S = NET_CLOCK_OFFSETS_S + tuple(
    1e-6 * v for v in (-11, 16, -6, 3, 19, -14, 8, -21, 11, -3, 25, -8))
# The sweep's station counts that phase 11 runs once each.
NET_SWEEP = (16, 24)


def _network_overlapped(dev, blocks, n_st: int, counters, out) -> list:
    """The sweep's blocks at ``n_st`` stations as u8 I/Q (about 27 byte
    steps a standard deviation) through ``ingest_overlapped`` on
    the kernel route — the overlapped ingest's stacked 3·n_st rows,
    each block's pairs in its own tiles — against ``process_blocks`` on
    the same bytes decoded. Returns the failures."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import station_sweep_torch as sweep
    from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16
    from tdoa_tpu_torch.pipeline.ingest import ingest_overlapped
    from tdoa_tpu_torch.utils.constants import IQ_CENTER, IQ_SCALE

    L = int(blocks[0].shape[-1])
    pairs = blocks[3]
    q = [torch.clamp(torch.round(b.float() * 24.0 + IQ_CENTER), 0,
                     255).to(torch.uint8) for b in blocks[:3]]
    decoded = [((v.float() - IQ_CENTER) / IQ_SCALE).to(torch.bfloat16)
               for v in q]
    host = [iq_bytes_as_u16(torch.cat([v[:, s].T for v in q]).contiguous()
                            .cpu().numpy().reshape(-1))
            for s in range(n_st)]  # each station's 3 blocks, [3·L] words
    del q
    batch = sweep.run((*decoded, pairs))[0]
    geo = np.zeros(len(pairs))

    def run(accumulator):
        return ingest_overlapped(host, pairs, geo, block_len=L,
                                 max_lag=sweep.MAX_LAG, weighting="ht",
                                 accumulator=accumulator, device=dev)[0]

    def timed(accumulator):
        run(accumulator)  # warm-up
        _reset_counts(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = run(accumulator)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    # The segmented route, timed beside: where the ingest went at 8 to
    # 24 stations before kernel 1 was pair-tiled.
    _, wall_seg = timed("xla")
    got, wall = timed("pallas")
    launches, shapes = _read_counts(counters)
    dev_batch = float((got - batch).abs().max())
    e = sweep.tdoa_error((got,), blocks[4])
    print(f"-- ingest_overlapped, {n_st} stations ({3 * n_st} stacked rows, "
          f"{3 * len(pairs)} pairs): {wall:.3f} s (segmented route "
          f"{wall_seg:.3f} s); largest |overlapped - batch| "
          f"{dev_batch:.2e} samples, |TDOA - planted| {e:.4f}; launches "
          f"{launches}, kernel 1 {shapes['k1_shapes']}, kernel 2 "
          f"{shapes['k2_shapes']}  [{_smi()}]")
    out[f"network: ingest_overlapped, {n_st} stations"] = {
        "wall_s": wall, "segmented_wall_s": wall_seg, "launches": launches,
        **shapes, "vs_batch_samples": dev_batch, "tdoa_err_max_samples": e}
    del decoded, host
    if not (dev_batch < 0.05 and e < 0.5 and launches["corr_accum"] > 0):
        return [f"overlapped at {n_st} stations: {dev_batch:.4f} samples "
                f"from the batch path, TDOA error {e:.3f}, launches "
                f"{launches}"]
    return []


def _network_tail(proc, paths, names, batch, counters, out) -> list:
    """Phase 11's files through a ``TailIngest`` session fed in ten growth
    steps (views cut to k/10) and finished by ``process_captures(caps,
    tail=session)``: a warm-up, then a run timed from the last byte.
    Held to st4 alone excluded, every pair within 0.05 sample of
    ``process_files`` (``batch``, by pair), every chunk within the first
    nine tenths dispatched before the last tenth lands, one kernel-1
    launch a chunk and kernel 2 once a block. Returns the failures."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.pipeline import ingest

    t_names = sorted(names)
    views = []
    for n in t_names:
        raw = np.memmap(next(p for p in paths if f"-{n}-" in p),
                        dtype=np.uint8, mode="r")
        views.append(iq_bytes_as_u16(raw[: (raw.size // 2) * 2]))
    total = views[0].shape[0]
    _, spans = ingest.plan_chunks(BLOCK, SEG_LEN)

    _tail_run(proc, t_names, views, BLOCK)  # warm-up
    _reset_counts(counters)
    res, sess, before, after_s = _tail_run(proc, t_names, views, BLOCK)
    launches, shapes = _read_counts(counters)
    ready = _tail_ready(spans, BLOCK, total)
    dev_batch = max(abs(v - batch[k]) for k, v in _by_pair(res).items())
    print(f"-- tail session, 12 stations: {before}/{sess.total_chunks} "
          f"chunks dispatched before the last tenth of the files ({ready} "
          f"ready); last byte → fix {after_s:.3f} s; excluded "
          f"{res.excluded_stations}; largest |tail - batch| {dev_batch:.2e} "
          f"samples; copy stream "
          f"{sess.link_diag['transfer_stream_s'] * 1e3:.1f} ms; launches "
          f"{launches}, kernel 1 {shapes['k1_shapes']}, kernel 2 "
          f"{shapes['k2_shapes']}  [{_smi()}]")
    out["network: tail session, 12 stations"] = {
        "wall_s": after_s, "launches": launches, **shapes,
        "excluded": res.excluded_stations, "vs_batch_samples": dev_batch,
        "chunks_before_close": before, "total_chunks": sess.total_chunks}
    fails = []
    if before != ready or ready < sess.total_chunks - len(spans) // 2:
        fails.append(f"tail: {before} chunks dispatched before the last "
                     f"tenth, {ready} were ready")
    if res.excluded_stations != [NET_OUTLIER] or not dev_batch < 0.05:
        fails.append(f"tail: excluded {res.excluded_stations}, "
                     f"{dev_batch:.4f} samples from the batch path")
    if launches["corr_accum"] != sess.total_chunks \
            or launches["zoom_probe"] != 3:
        fails.append(f"tail: launches {launches} for {sess.total_chunks} "
                     f"chunks")
    return fails


def _network_sharded(dev, paths, names, geo, tau, counters, out) -> list:
    """The sharded step on phase 11's files cut to their first SHARD_SEGS
    kernel segments (f32), kernel route, in a world of NET_SHARD_WORLD
    gloo ranks on this card, against the unsharded path on the same
    blocks (1e-3 sample, phase 9's bound) and the clean pairs against
    the truth (0.5 sample). Returns the failures."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.parallel.launch import spawn
    from tdoa_tpu_torch.solve.multilateration import station_pairs
    from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG

    pairs = station_pairs(len(names))
    n_use, max_lag = SHARD_SEGS * SEG_LEN, DEFAULT_MAX_LAG
    clean = np.array([NET_OUTLIER not in (names[i], names[j])
                      for i, j in pairs])
    want = np.array([tau[names[j]] - tau[names[i]] for i, j in pairs])
    blocks = [b.to(dev) for b in _host_blocks(paths, n_use)]
    geo_d = torch.as_tensor(geo, device=dev)
    _unsharded(blocks, pairs, geo_d, "pallas", max_lag)  # warm-up
    torch.cuda.synchronize()
    _reset_counts(counters)
    t0 = time.perf_counter()
    single = _unsharded(blocks, pairs, geo_d, "pallas",
                        max_lag)[0].cpu().numpy()
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    out["network: unsharded kernel route (the sharded step's comparator), "
        "12 stations"] = {"wall_s": wall, "launches": launches, **shapes}
    print(f"-- unsharded kernel route, 12 stations x {SHARD_SEGS} segments: "
          f"{wall:.3f} s; launches {launches}, kernel 1 "
          f"{shapes['k1_shapes']}, kernel 2 {shapes['k2_shapes']}")
    del blocks, geo_d
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(_shard_rank, NET_SHARD_WORLD, "cuda", paths, n_use, pairs,
                  geo, max_lag, False, ("pallas",))
    started = time.perf_counter() - t0
    runs = [r["pallas"] for r in ranks]
    counts = _sum_counts(runs)
    dev_single = max(float(np.abs(r["corrected"] - single).max())
                     for r in runs)
    err = float(np.abs(runs[0]["corrected"] - want)[clean].max())
    wall = max(r["wall_s"] for r in runs)
    print(f"-- sharded kernel route, 12 stations, {NET_SHARD_WORLD} ranks "
          f"(backend {ranks[0]['backend']}; world started, ran and joined "
          f"in {started:.1f} s): wall per rank "
          f"{[round(r['wall_s'], 4) for r in runs]} s, peak memory per rank "
          f"{[round(r['peak_bytes'] / 2**20, 1) for r in runs]} MiB; max "
          f"|Δ| vs unsharded {dev_single:.2e} samples, clean pairs' "
          f"|TDOA - truth| {err:.4f}; launches {counts['launches']}, kernel "
          f"1 {counts['k1_shapes']}, kernel 2 {counts['k2_shapes']}  "
          f"[{_smi()}]")
    out[f"network: sharded kernel route, {NET_SHARD_WORLD} ranks, 12 "
        f"stations"] = {
        "wall_s": wall, "wall_by_rank_s": [r["wall_s"] for r in runs],
        "peak_bytes_by_rank": [r["peak_bytes"] for r in runs],
        "max_dev_vs_unsharded": dev_single, "clean_tdoa_err_samples": err,
        **counts}
    fails = []
    if not (dev_single < SHARD_TOL and err < 0.5):
        fails.append(f"sharded at 12 stations: {dev_single:.2e} from "
                     f"unsharded, clean-pair error {err:.3f}")
    if counts["launches"]["corr_accum"] < NET_SHARD_WORLD:
        fails.append(f"sharded at 12 stations: launches {counts['launches']}")
    return fails


def _sweep_blocks(dev, blocks, n_st: int, routes, counters, out) -> list:
    """The sweep's blocks at ``n_st`` stations through ``process_blocks``
    once on each of ``routes`` (first run, timed): within 0.5 sample of
    the planted delays, kernel 1 once a tile a block on the kernel route
    and never on the segmented one. Returns the failures."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import station_sweep_torch as sweep
    from tdoa_tpu_torch.ops.kernels import corr_accum

    tiles = corr_accum.plan_tiles(blocks[3], n_st, True,
                                  corr_accum.smem_optin(dev))
    fails = []
    for route in routes:
        _reset_counts(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = sweep.run(blocks, route)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, shapes = _read_counts(counters)
        e = sweep.tdoa_error(r, blocks[4])
        name = ("kernel 1" if route == "pallas" else "segmented route")
        print(f"-- station sweep, {n_st} stations ({len(blocks[3])} pairs): "
              f"process_blocks {wall:.3f} s (first run), {name}, "
              f"{len(tiles)} tiles a block {[hi - lo for *_, lo, hi in tiles]}"
              f"; largest |TDOA - planted| {e:.4f} samples; launches "
              f"{launches}, kernel 1 {shapes['k1_shapes']}, kernel 2 "
              f"{shapes['k2_shapes']}")
        key = f"network: sweep process_blocks, {n_st} stations"
        out[key if route == "pallas" else f"{key}, segmented route"] = {
            "wall_s": wall, "launches": launches, **shapes,
            "tiles": len(tiles), "tdoa_err_max_samples": e}
        k1 = 3 * len(tiles) if route == "pallas" else 0
        if launches["corr_accum"] != k1 or not e < 0.5:
            fails.append(f"sweep at {n_st} stations, {route}: launches "
                         f"{launches}, TDOA error {e:.3f}")
        del r
    return fails


def _network_csv(out: Path, stations=NET_STATIONS) -> Path:
    """The network's station CSV (lat-lon-table.csv's format, its KEVO
    and REF transmitter rows)."""
    rows = ["Name,Latitude,Longitude,Elevation"]
    for line in (ROOT / "lat-lon-table.csv").read_text().splitlines()[1:]:
        if line.split(",")[0] in ("KEVO", f"{REF_FREQ:.0f}"):
            rows.append(line)
    rows += [",".join(map(str, r)) for r in stations]
    out.write_text("\n".join(rows) + "\n")
    return out


def phase_network(dev, tmp: Path):
    """Phase 11: the 12-station scene through ``process_files`` (the
    planted outlier excluded, the clean pairs within 0.5 sample, the
    fix within 200 m; the leave-stations-out re-solves timed on the
    host) and ``process_files_overlapped`` (within 0.05 sample of the
    batch result, kernel 1 on the stacked rows), then the station
    sweep's 16- and 24-station ``process_blocks`` once each."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import station_sweep_torch as sweep
    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.solve.multilateration import station_pairs

    print("== phase 11: a 12-station network, and the station sweep")
    out, counters = {}, _counters()
    csv = _network_csv(tmp / "network.csv")
    t0 = time.perf_counter()
    paths, truth = _synthesize(dev, tmp, prefix="net", csv=csv,
                               clock_offsets_s=NET_CLOCK_OFFSETS_S,
                               tgt_shift={NET_OUTLIER: NET_SHIFT})
    torch.cuda.synchronize()
    print(f"synthesized {len(paths)} x {3 * BLOCK} samples in "
          f"{time.perf_counter() - t0:.1f} s")
    tau, tgt_tx = truth["tau_tgt"], truth["tgt_lla"]
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, str(csv), device=dev)
    resolves = []
    reject = proc._reject_outliers

    def timed_reject(*args, **kw):  # the host's leave-stations-out solves
        t = time.perf_counter()
        r = reject(*args, **kw)
        resolves.append(time.perf_counter() - t)
        return r

    proc._reject_outliers = timed_reject
    fails = []

    def timed(fn, name):
        fn(paths)  # warm-up
        resolves.clear()
        _reset_counts(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn(paths)  # results are host arrays: synced
        wall = time.perf_counter() - t
        launches, shapes = _read_counts(counters)
        print(f"-- {name}: {wall:.3f} s (leave-stations-out re-solves "
              f"{[round(v, 4) for v in resolves]} s on the host)  "
              f"[{_smi()}]; launches {launches}, kernel 1 "
              f"{shapes['k1_shapes']}, kernel 2 {shapes['k2_shapes']}")
        out[f"network: {name}"] = {"wall_s": wall, "launches": launches,
                                   **shapes, "resolve_s": list(resolves)}
        return res

    res = timed(proc.process_files, "process_files, 12 stations")
    names = res.station_names
    err = {}
    for k, (i, j) in enumerate(res.pair_idx):
        if NET_OUTLIER not in (names[i], names[j]):
            err[(names[i], names[j])] = (res.corrected_tdoa_samples[k]
                                         - (tau[names[j]] - tau[names[i]]))
    fix_err = _fix_err_m(res.fix, tgt_tx)
    worst = max(abs(v) for v in err.values())
    print(f"   excluded {res.excluded_stations}; {len(err)} clean pairs, "
          f"largest |TDOA - truth| {worst:.4f} samples; fix {fix_err:.1f} m "
          f"from the planted transmitter; 1σ ellipse "
          f"{res.fix.ellipse[0]:.2f} x {res.fix.ellipse[1]:.2f} m")
    for w in res.warnings:
        print(f"   warning: {w}")
    out["network: process_files, 12 stations"].update(
        excluded=res.excluded_stations, tdoa_err_max_samples=worst,
        fix_err_m=fix_err)
    if res.excluded_stations != [NET_OUTLIER]:
        fails.append(f"excluded {res.excluded_stations}, planted "
                     f"{NET_OUTLIER}")
    if not (worst < 0.5 and fix_err < 200.0):
        fails.append(f"batch: TDOA error {worst:.3f}, fix {fix_err:.1f} m")
    if out["network: process_files, 12 stations"]["launches"][
            "corr_accum"] < 1:
        fails.append("batch: kernel 1 did not launch")
    batch = _by_pair(res)

    res_o = timed(proc.process_files_overlapped,
                  "process_files_overlapped, 12 stations")
    dev_batch = max(abs(v - batch[k]) for k, v in _by_pair(res_o).items())
    print(f"   excluded {res_o.excluded_stations}; largest |overlapped - "
          f"batch| {dev_batch:.4f} samples; fix "
          f"{_fix_err_m(res_o.fix, tgt_tx):.1f} m")
    o = out["network: process_files_overlapped, 12 stations"]
    o.update(excluded=res_o.excluded_stations, vs_batch_samples=dev_batch)
    if not dev_batch < 0.05 or o["launches"]["corr_accum"] < 1:
        fails.append(f"overlapped: {dev_batch:.4f} samples from the batch "
                     f"path, kernel 1 launches {o['launches']}")
    # The segmented route, timed beside: where the overlapped ingest went
    # at 8 to 24 stations before kernel 1 was pair-tiled.
    proc_x = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, str(csv), device=dev,
                                    accumulator="xla")
    res_x = timed(proc_x.process_files_overlapped,
                  "process_files_overlapped, 12 stations, segmented route")
    print(f"   excluded {res_x.excluded_stations}; largest |segmented - "
          f"batch| {max(abs(v - batch[k]) for k, v in _by_pair(res_x).items()):.4f}"
          f" samples")
    del proc_x, res_x
    file_names = list(tau)  # the files' order
    fails += _network_tail(proc, paths, file_names, batch, counters, out)
    fails += _network_sharded(
        dev, paths, file_names,
        proc._ref_geo_tdoa_samples(file_names, station_pairs(
            len(file_names))).astype(np.float32),
        tau, counters, out)
    # 14 stations: 2 tiles a block, on both routes.
    blocks = sweep.make_blocks(14, 3 * BLOCK / FS, SEED + 14, dev)
    fails += _sweep_blocks(dev, blocks, 14, ("pallas", "xla"), counters, out)
    del blocks
    torch.cuda.empty_cache()

    for n_st in NET_SWEEP:
        blocks = sweep.make_blocks(n_st, 3 * BLOCK / FS, SEED + n_st, dev)
        fails += _sweep_blocks(dev, blocks, n_st, ("pallas",), counters, out)
        fails += _network_overlapped(dev, blocks, n_st, counters, out)
        del blocks
        torch.cuda.empty_cache()
    print(json.dumps({"network": {k: {kk: vv for kk, vv in v.items()
                                      if kk not in SHAPE_KEYS.values()}
                                  for k, v in out.items()}}))
    if fails:
        raise RuntimeError("phase 11: " + "; ".join(fails))
    return out


def _peak_gb(dev) -> float:
    """The card's peak allocated memory since the last reset, GB."""
    import torch

    return torch.cuda.max_memory_allocated(dev) / 1e9


def _timed_run(dev, counters, fn):
    """``fn()`` after a warm-up call, with every launch count set to 0
    and the peak-memory mark reset just before it: (result, wall s,
    launches, shapes, peak GB of the timed call)."""
    import torch

    fn()  # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()  # results are host arrays: synced
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    return res, wall, launches, shapes, _peak_gb(dev)


def _held_to_reckoning(key, peak_above, reckoned, out, fails):
    """A batch route's peak device memory above what was allocated before
    it ran, held to the route's reckoned need from before the decode
    (``TDOAProcessor.route_bytes``, the batch route verdict's count):
    printed, kept in ``out[key]``, a failure where the peak exceeds
    it."""
    print(f"   peak {peak_above / 1e9:.2f} GB above what was allocated "
          f"before the run; the route's reckoned need {reckoned / 1e9:.2f} "
          f"GB")
    out[key].update(peak_above_gb=peak_above / 1e9,
                    reckoned_gb=reckoned / 1e9)
    if peak_above > reckoned:
        fails.append(f"{key}: peak {peak_above / 1e9:.2f} GB above the "
                     f"reckoned need {reckoned / 1e9:.2f} GB")


def _window_running_sum(dev) -> list:
    """``dsp.fm.running_sum`` (the simulator's FM phase integral) over one
    100 s block: two calls bitwise equal and within float32 rounding of
    the sum's magnitude of a float64 running sum (the bound of
    ``tests/test_torch_dsp.py::test_running_sum_matches_float64``).
    Returns the failures."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.dsp.fm import running_sum

    g = torch.Generator(device=dev).manual_seed(SEED + WINDOW_S)
    a = torch.randn(WINDOW_BLOCK, device=dev, generator=g)
    got, again = running_sum(a), running_sum(a)
    want = torch.cumsum(a.double(), 0)
    err = float((got.double() - want).abs().max())
    tol = 64 * float(np.finfo(np.float32).eps) * max(
        float(want.abs().max()), 1.0)
    same = torch.equal(got, again)
    print(f"-- dsp.fm.running_sum over {WINDOW_BLOCK} samples: max |f32 - "
          f"float64| = {err:.3e} (bound {tol:.3e}); two calls bitwise "
          f"equal: {same}")
    del a, got, again, want
    return [] if err < tol and same else [
        f"running_sum: error {err:.3e} (bound {tol:.3e}), repeatable {same}"]


def _window_collector(dev, tmp: Path, counters, out) -> list:
    """The collector CLI at ``--duration 100`` (``--backend sim``, one
    call a station, one epoch: the same simulated scene), then the three
    files it wrote through ``process_files`` on the fused route against
    the simulator's truth (0.5 sample, 200 m), and the stream service
    over their directory as a ``--watch --overlap-ingest 100`` deployment
    runs it (the window's tail session, its fix within 200 m, one
    kernel-1 launch a chunk). Returns the failures."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.cli import collector, stream_processor
    from tdoa_tpu_torch.cli.simulator import (
        DEFAULT_REF_TX,
        DEFAULT_STATIONS,
        DEFAULT_TGT_TX,
    )
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.pipeline import ingest
    from tdoa_tpu_torch.sim import SimScene
    from tdoa_tpu_torch.sim.scene import compute_truth

    cdir = tmp / "window-collector"
    cdir.mkdir()
    epoch, fails = 1_700_000_100, []
    t0 = time.perf_counter()
    for name in DEFAULT_STATIONS:
        rc, text, err = _tool(collector.main, [
            str(REF_FREQ), str(TGT_FREQ), str(epoch), name, "--backend",
            "sim", "--duration", str(WINDOW_S), "--out", str(cdir)])
        if rc != 0:
            fails.append(f"collector {name}: exit {rc}: {text[-300:]}"
                         f"{err[-300:]}")
    wall = time.perf_counter() - t0
    files = sorted(str(p) for p in cdir.glob("*.dat"))
    sizes = {Path(f).name: Path(f).stat().st_size for f in files}
    print(f"-- collector --backend sim --duration {WINDOW_S}: {len(files)} "
          f"files {sizes} in {wall:.1f} s (3 calls)")
    if fails or len(files) != 3 or set(sizes.values()) != {6 * WINDOW_BLOCK}:
        return fails + [f"collector files {sizes}"]
    scene = SimScene(
        station_names=tuple(DEFAULT_STATIONS),
        station_lla=np.array(list(DEFAULT_STATIONS.values())),
        ref_tx_lla=np.array(DEFAULT_REF_TX),
        tgt_tx_lla=np.array(DEFAULT_TGT_TX), ref_freq=REF_FREQ,
        tgt_freq=TGT_FREQ, block_len=WINDOW_BLOCK, seed=epoch % (1 << 31))
    truth = compute_truth(scene)
    tau = dict(zip(scene.station_names, truth.station_delays_samples[:, 1]))
    name = f"{WINDOW_S} s: the collector's files, fused IQ"
    out[name] = _run_path(dev, files, tau, np.array(DEFAULT_TGT_TX), name,
                          {}, 0.5, 200.0, ("corr_accum", "zoom_probe"), ())
    out[name]["collector_s"] = wall

    jsonl = tmp / "window-fixes.jsonl"
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, text, err = _tool(stream_processor.main, [
        str(REF_FREQ), str(TGT_FREQ), str(ROOT / "lat-lon-table.csv"),
        str(cdir), "--watch", "0.2", "--settle", "0.5", "--overlap-ingest",
        str(WINDOW_S), "--idle-exit", "2", "--jsonl", str(jsonl)])
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    recs = ([json.loads(v) for v in jsonl.read_text().splitlines()]
            if jsonl.exists() else [])
    fix_err = (_fix_err_m(SimpleNamespace(**recs[0]["fix"]),
                          np.array(DEFAULT_TGT_TX)) if recs else float("inf"))
    name = f"{WINDOW_S} s: stream service, --watch --overlap-ingest"
    n_chunks = 3 * len(ingest.plan_chunks(WINDOW_BLOCK, SEG_LEN)[1])
    print(f"-- {name}: exit {rc}, {len(recs)} window(s), fix {fix_err:.1f} "
          f"m; {wall:.3f} s with the idle exit; launches {launches}, kernel "
          f"1 {shapes['k1_shapes']}")
    out[name] = {"wall_s": wall, "launches": launches, **shapes,
                 "fix_err_m": fix_err, "windows": len(recs)}
    if (rc != 0 or len(recs) != 1 or not fix_err < 200.0
            or "tail-ingest" not in err or "fell back" in err
            or launches["corr_accum"] != n_chunks):
        fails.append(f"stream service: exit {rc}, {len(recs)} windows, fix "
                     f"{fix_err:.1f} m, launches {launches}: {err[-300:]}")
    return fails


def _window_network(dev, tmp: Path, counters, out, stations=NET_STATIONS,
                    clocks=NET_CLOCK_OFFSETS_S, tail: bool = False) -> list:
    """Phase 11's network scene (st4's TGT 160 samples late) of
    ``stations`` over a 100 s window, its bytes made on the card and kept
    in host memory: the batch kernel route (the bytes decoded on the
    card as ``load_files`` decodes them, after the batch route's verdict,
    then ``process_captures`` with the outlier rejection, its host
    re-solves timed), the overlapped ingest (``HostCapture`` views of the
    same bytes) and, with ``tail``, a ``TailIngest`` session fed in ten
    growth steps; each a warm-up and a timed run. Held to st4 alone
    excluded, every clean pair within 0.5 sample of the truth, the fix
    within 200 m, the overlapped and tail results within 0.05 sample of
    the batch one, kernel 1 once a tile a block (batch) and once a tile
    a chunk (overlapped, tail). Returns the failures."""
    import torch

    from tdoa_tpu_torch.io.datfile import (
        bytes_to_iq_planar,
        iq_bytes_as_u16,
        split_blocks,
    )
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.pipeline import TDOAProcessor, ingest
    from tdoa_tpu_torch.pipeline.processor import HostCapture
    from tdoa_tpu_torch.solve.multilateration import station_pairs

    n_st = len(stations)
    csv = _network_csv(tmp / f"window-network-{n_st}.csv", stations)
    t0 = time.perf_counter()
    raws, truth = _synthesize(dev, tmp, prefix="win-net", csv=csv,
                              clock_offsets_s=clocks,
                              tgt_shift={NET_OUTLIER: NET_SHIFT},
                              block=WINDOW_BLOCK, write=False)
    torch.cuda.synchronize()
    print(f"synthesized {len(raws)} x {3 * WINDOW_BLOCK} samples in "
          f"{time.perf_counter() - t0:.1f} s (host memory, no files)")
    tau, tgt_tx = truth["tau_tgt"], truth["tgt_lla"]
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, str(csv), device=dev)
    resolves = []
    reject = proc._reject_outliers

    def timed_reject(*args, **kw):  # the host's leave-stations-out solves
        t = time.perf_counter()
        r = reject(*args, **kw)
        resolves.append(time.perf_counter() - t)
        return r

    proc._reject_outliers = timed_reject
    torch.cuda.empty_cache()
    kernel_need, segmented_need = proc.route_bytes(n_st, WINDOW_BLOCK)
    print(f"-- {n_st} stations x {WINDOW_BLOCK}: batch routes reckoned "
          f"before the decode: kernel route {kernel_need / 1e9:.2f} GB, "
          f"segmented route {segmented_need / 1e9:.2f} GB; free "
          f"{torch.cuda.mem_get_info(dev)[0] / 1e9:.2f} GB")
    # The kernel route's decode, as load_files decodes for it; the route
    # verdict is left to process_captures, which asks it first here,
    # holding the captures and its stacks, as an in-memory caller does.
    dtype = torch.bfloat16
    n_chunks = len(ingest.plan_chunks(WINDOW_BLOCK, SEG_LEN)[1])
    # Kernel 1's launches: a tile a block (batch), a tile of the stacked
    # rows a chunk (overlapped), a tile of a block's rows a chunk (tail).
    pairs = station_pairs(n_st)
    n_seg = WINDOW_BLOCK // SEG_LEN
    tiles = len(_k1_launch_keys(n_st, n_seg, 4, pairs, True, dev))
    tiles_stacked = len(_k1_launch_keys(3 * n_st, 96, 1,
                                        _pair_list(3 * n_st, n_st), True,
                                        dev))

    def batch():
        return proc.process_captures({
            n: split_blocks(bytes_to_iq_planar(
                torch.from_numpy(raw).to(dev), dtype))
            for n, raw in raws.items()})

    def overlapped():
        return proc.process_captures({
            n: HostCapture(u16=iq_bytes_as_u16(raw), block_len=WINDOW_BLOCK)
            for n, raw in raws.items()})

    fails = []
    held = torch.cuda.memory_allocated(dev)
    res, wall, launches, shapes, peak = _timed_run(dev, counters, batch)
    peak_above = torch.cuda.max_memory_allocated(dev) - held
    verdict = proc.batch_route(n_st, WINDOW_BLOCK)  # process_captures'
    resolve_s = list(resolves[len(resolves) // 2:])  # the timed run's
    names = res.station_names
    err = {(names[i], names[j]): res.corrected_tdoa_samples[k]
           - (tau[names[j]] - tau[names[i]])
           for k, (i, j) in enumerate(res.pair_idx)
           if NET_OUTLIER not in (names[i], names[j])}
    worst = max(abs(v) for v in err.values())
    fix_err = _fix_err_m(res.fix, tgt_tx)
    key = f"{WINDOW_S} s: {n_st} stations, batch ({dtype})"
    print(f"-- {key}: route verdict taken by process_captures "
          f"{verdict.route} (still to allocate: kernel route "
          f"{verdict.kernel_bytes / 1e9:.2f} GB, segmented route "
          f"{verdict.segmented_bytes / 1e9:.2f} GB; free "
          f"{verdict.free_bytes / 1e9:.2f} GB); bytes in memory → fix "
          f"{wall:.3f} s, peak memory {peak:.2f} GB  "
          f"[{_smi()}]; leave-stations-out re-solves "
          f"{[round(v, 4) for v in resolve_s]} s on the host; excluded "
          f"{res.excluded_stations}; {len(err)} clean pairs, largest "
          f"|TDOA - truth| {worst:.4f} samples; fix {fix_err:.1f} m; "
          f"launches {launches}, kernel 1 {shapes['k1_shapes']}, kernel 2 "
          f"{shapes['k2_shapes']}")
    for w in res.warnings:
        print(f"   warning: {w}")
    out[key] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                **shapes, "excluded": res.excluded_stations,
                "tdoa_err_max_samples": worst, "fix_err_m": fix_err,
                "resolve_s": resolve_s, "route": verdict.route,
                "verdict_kernel_gb": verdict.kernel_bytes / 1e9,
                "verdict_free_gb": verdict.free_bytes / 1e9}
    _held_to_reckoning(key, peak_above, kernel_need, out, fails)
    if verdict.route != "pallas":
        fails.append(f"{n_st}-station batch: process_captures' verdict "
                     f"{verdict}")
    if res.excluded_stations != [NET_OUTLIER] or not (
            worst < 0.5 and fix_err < 200.0) \
            or launches["corr_accum"] != 3 * tiles:
        fails.append(f"{n_st}-station batch: excluded "
                     f"{res.excluded_stations}, TDOA error {worst:.3f}, fix "
                     f"{fix_err:.1f} m, launches {launches}")
    batch_by_pair = _by_pair(res)
    res_o, wall, launches, shapes, peak = _timed_run(dev, counters,
                                                     overlapped)
    dev_batch = max(abs(v - batch_by_pair[k])
                    for k, v in _by_pair(res_o).items())
    key = f"{WINDOW_S} s: {n_st} stations, process_captures overlapped"
    print(f"-- {key}: {wall:.3f} s, peak memory {peak:.2f} GB; excluded "
          f"{res_o.excluded_stations}; largest |overlapped - batch| "
          f"{dev_batch:.4f} samples; fix {_fix_err_m(res_o.fix, tgt_tx):.1f}"
          f" m; {proc.ingest_diag.get('n_chunks')} chunks, gather "
          f"{proc.ingest_diag.get('gather_s', 0) * 1e3:.1f} ms; launches "
          f"{launches}, kernel 1 {shapes['k1_shapes']}")
    out[key] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                **shapes, "excluded": res_o.excluded_stations,
                "vs_batch_samples": dev_batch}
    if res_o.excluded_stations != [NET_OUTLIER] or not dev_batch < 0.05 \
            or launches["corr_accum"] != tiles_stacked * n_chunks:
        fails.append(f"{n_st}-station overlapped: excluded "
                     f"{res_o.excluded_stations}, {dev_batch:.4f} samples "
                     f"from the batch path, launches {launches} for "
                     f"{n_chunks} chunks")
    if tail:
        t_names = sorted(raws)
        views = [iq_bytes_as_u16(raws[n]) for n in t_names]
        _, spans = ingest.plan_chunks(WINDOW_BLOCK, SEG_LEN)
        _tail_run(proc, t_names, views, WINDOW_BLOCK)  # warm-up
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts(counters)
        res_t, sess, before, after_s = _tail_run(proc, t_names, views,
                                                 WINDOW_BLOCK)
        launches, shapes = _read_counts(counters)
        ready = _tail_ready(spans, WINDOW_BLOCK, views[0].shape[0])
        dev_t = max(abs(v - batch_by_pair[k])
                    for k, v in _by_pair(res_t).items())
        key = f"{WINDOW_S} s: {n_st} stations, tail session"
        print(f"-- {key}: {before}/{sess.total_chunks} chunks dispatched "
              f"before the last tenth ({ready} ready); last byte → fix "
              f"{after_s:.3f} s, peak memory {_peak_gb(dev):.2f} GB; "
              f"excluded {res_t.excluded_stations}; largest |tail - batch| "
              f"{dev_t:.4f} samples; launches {launches}, kernel 1 "
              f"{shapes['k1_shapes']}, kernel 2 {shapes['k2_shapes']}")
        out[key] = {"wall_s": after_s, "peak_gb": _peak_gb(dev),
                    "launches": launches, **shapes,
                    "excluded": res_t.excluded_stations,
                    "vs_batch_samples": dev_t, "chunks_before_close": before,
                    "total_chunks": sess.total_chunks}
        tiles_block = len(_k1_launch_keys(n_st, 96, 1, pairs, True, dev))
        if before != ready or res_t.excluded_stations != [NET_OUTLIER] \
                or not dev_t < 0.05 \
                or launches["corr_accum"] != tiles_block * sess.total_chunks:
            fails.append(f"{n_st}-station tail: {before} chunks before the "
                         f"last tenth ({ready} ready), excluded "
                         f"{res_t.excluded_stations}, {dev_t:.4f} samples "
                         f"from the batch path, launches {launches}")
        del views, res_t, sess
    del raws
    return fails


# Phase 12's scene C: the known recording long enough to cover a 100 s
# capture's 33.3 s TGT block: 441·3375 samples at 44.1 kHz (33.75 s),
# which resample to 67,500,000 at the capture rate (factors 2, 3, 5
# only). The checked LO span scales phase 7's ±1.5 Hz by its block's
# 10 s over 33.3 s: the rf domain's Doppler main lobe narrows as 1/T
# (0.03 Hz here), so the same 64 bins stay as dense across it.
AUDIO_WINDOW_LEN = 441 * 3375
AM_WINDOW_LO_SPAN = AM_LO_SPAN * BLOCK / WINDOW_BLOCK
TEMPLATE_PHASE_TOL = 1e-2  # rad, the card's f32 template against float64


def _window_motion(dev, tmp: Path, counters, out) -> list:
    """Scene B: phase 6's scenes (a) LO offsets and a mover, (b) the mover
    and a static interferer, over the 100 s window through
    ``process_files`` at phase 6's checked settings (a warm-up, then a
    timed run with its stage times and peak memory), held to phase 6's
    checks; then ``_derotate`` alone on one 100 s block of 3 stations,
    its peak memory above the block. Returns the failures."""
    import torch

    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.pipeline.processor import _derotate
    from tdoa_tpu_torch.utils.profiling import StageTimer

    fails = []
    for scene, channel, settings in MOTION:
        name, cfg, check = settings[0]  # the checked run
        mdir = tmp / "window-motion"
        mdir.mkdir()
        try:
            t0 = time.perf_counter()
            files, truth = _synthesize(dev, mdir, prefix="wmotion",
                                       block=WINDOW_BLOCK, **channel)
            torch.cuda.synchronize()
            print(f"-- {WINDOW_S} s, scene {scene}: synthesized in "
                  f"{time.perf_counter() - t0:.1f} s")
            proc = TDOAProcessor.from_csv(
                REF_FREQ, TGT_FREQ, str(ROOT / "lat-lon-table.csv"),
                device=dev, **cfg)
            def run():  # the timer keeps the last run's stages
                proc.timer = StageTimer()  # noqa: B023
                return proc.process_files(files)  # noqa: B023

            held = torch.cuda.memory_allocated(dev)
            res, wall, launches, shapes, peak = _timed_run(dev, counters,
                                                           run)
            peak_above = torch.cuda.max_memory_allocated(dev) - held
            verdict = proc.batch_route(3, WINDOW_BLOCK)  # load_files'
            stages = dict(proc.timer.times)
            key = f"{WINDOW_S} s: {scene} | {name}"
            print(f"-- {key}: capture→fix {wall:.3f} s, peak memory "
                  f"{peak:.2f} GB  [{_smi()}]; stages "
                  f"{({k: round(v, 4) for k, v in stages.items()})}; "
                  f"launches {launches}, kernel 1 {shapes['k1_shapes']}, "
                  f"kernel 2 {shapes['k2_shapes']}")
            nums = _report(name, res, truth)
            bad = (check(res, truth, launches, static_fix=False)
                   if check is _check_joint else check(res, truth, launches))
            print(f"   checks: {'pass' if not bad else bad}")
            fails += [f"{key}: {b}" for b in bad]
            out[key] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                        **shapes, "stages_s": stages, **nums,
                        "route": verdict.route}
            print(f"   batch route verdict (load_files, before the decode): "
                  f"{verdict.route}")
            _held_to_reckoning(key, peak_above, verdict.kernel_bytes
                               if verdict.route == "pallas"
                               else verdict.segmented_bytes, out, fails)
            del proc, res
        finally:
            shutil.rmtree(mdir, ignore_errors=True)
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(2, 3, WINDOW_BLOCK, device=dev, generator=g).to(
        torch.bfloat16)
    shifts = [12.5, -30.0, 4.0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _derotate(x, shifts, FS)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated(dev) - held
    ms = _time_ms(lambda: _derotate(x, shifts, FS), 3)
    print(f"-- _derotate of one {WINDOW_S} s block (3 stations, bf16 "
          f"{x.numel() * 2 / 1e9:.2f} GB): {ms:.3f} ms a call, peak "
          f"{above / 1e9:.2f} GB above the block (f32 block "
          f"{x.numel() * 4 / 1e9:.2f} GB)")
    out[f"{WINDOW_S} s: {MOTION[0][0]} | {MOTION[0][2][0][0]}"].update(
        derotate_ms=ms, derotate_peak_above_block_gb=above / 1e9)
    del x
    torch.cuda.empty_cache()
    return fails


def _window_audio(dev, tmp: Path, counters, out) -> list:
    """Scene C: phase 7's known-audio scene over the 100 s window (the
    recording covers the 33.3 s TGT block; ``.dat`` files and a WAV):
    ``match_captures`` in the audio, rf and auto modes (a warm-up, then
    a timed run each), held to phase 7's bounds; the audio_match CLI on
    the same files against the in-process audio mode; the audio
    domain's device time and its ``kthvalue`` medians' share; the rf
    domain's peak memory above its inputs; the template's f32 phase
    against float64 over 66,666,666 samples (``TEMPLATE_PHASE_TOL``).
    Returns the failures."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.io.wav import read_wav, write_wav
    from tdoa_tpu_torch.ops.kernels.fm_demod import fm_demod_decimate
    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.pipeline.audio_match import (
        _median,
        _with_template,
        match_captures,
        match_template_audio,
        match_template_rf,
        template_iq,
    )
    from tdoa_tpu_torch.sim import write_scene_captures
    from tdoa_tpu_torch.sim.source import bandlimited_noise
    from tdoa_tpu_torch.utils.profiling import StageTimer

    adir = tmp / "window-audio"
    adir.mkdir()
    fails = []
    try:
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(SEED + WINDOW_S)
        a = bandlimited_noise(AUDIO_WINDOW_LEN, 10e3, AUDIO_FS, g)
        audio44 = (0.8 * a / a.abs().max()).cpu().numpy()
        wav = adir / "recording.wav"
        write_wav(str(wav), AUDIO_FS, audio44)
        fs_w, audio = read_wav(str(wav))
        sc = _audio_scene(dev, audio44, block=WINDOW_BLOCK)
        files_map, truth = write_scene_captures(sc, str(adir), prefix="wam-",
                                                device=dev)
        files = sorted(files_map.values())
        torch.cuda.synchronize()
        print(f"-- {WINDOW_S} s known-audio scene: recording {len(audio)} "
              f"samples at {fs_w:.0f} Hz; simulated on the card and written "
              f"in {time.perf_counter() - t0:.1f} s; LO span "
              f"±{AM_WINDOW_LO_SPAN:.3f} Hz")
        csv = str(ROOT / "lat-lon-table.csv")
        proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, csv, device=dev,
                                      max_lag=AM_MAX_LAG)
        results = {}
        for mode in AM_MODES:
            def run():
                proc.timer = StageTimer()  # the last run's stages
                return match_captures(
                    proc, proc.load_files(files), audio, fs_w,
                    mode=mode, deviation_hz=AUDIO_DEV,  # noqa: B023
                    lo_span_hz=AM_WINDOW_LO_SPAN)

            res, wall, launches, shapes, peak = _timed_run(dev, counters,
                                                           run)
            results[mode] = res
            err = _truth_errors(res, sc.station_names, truth)
            fix_err = _fix_err_m(res.fix, sc.tgt_tx_lla)
            key = f"{WINDOW_S} s: audio match | {mode}"
            print(f"-- {key}: capture→fix {wall:.3f} s, peak memory "
                  f"{peak:.2f} GB  [{_smi()}]; stages "
                  f"{({k: round(v, 4) for k, v in proc.timer.times.items()})}"
                  f"; mode_used {res.mode_used}; TDOA err "
                  f"{np.round(err, 4).tolist()} samples; fix {fix_err:.1f} "
                  f"m; PSR {np.round(res.station_quality, 1).tolist()}; "
                  f"covered {res.covered_fraction:.4f}; launches {launches},"
                  f" kernel 1 {shapes['k1_shapes']}, kernel 3 "
                  f"{shapes['k3_shapes']}")
            for w in res.warnings:
                print(f"   warning: {w}")
            bad = _check_audio_match(mode, res, err, fix_err, launches, shapes,
                                     WINDOW_BLOCK, WINDOW_K1[0])
            print(f"   checks: {'pass' if not bad else bad}")
            fails += [f"{key}: {b}" for b in bad]
            out[key] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                        **shapes, "tdoa_err_samples": err.tolist(),
                        "fix_err_m": fix_err}
        audio_res = results["audio"]
        t0 = time.perf_counter()
        cli = json.loads(_cli(
            "tdoa_tpu_torch.cli.audio_match", str(REF_FREQ), str(TGT_FREQ),
            csv, str(wav), *files, "--deviation", str(AUDIO_DEV), "--json",
            "--max-lag", str(AM_MAX_LAG), "--lo-span",
            str(AM_WINDOW_LO_SPAN)).strip().splitlines()[-1])
        d_us = float(np.abs(np.array(cli["tdoa_us"])
                            - audio_res.tdoa_seconds * 1e6).max())
        d_fix = _fix_err_m(audio_res.fix, np.array(
            [cli["fix"]["lat"], cli["fix"]["lon"], cli["fix"]["elev"]]))
        print(f"-- {WINDOW_S} s audio_match CLI --json "
              f"({time.perf_counter() - t0:.1f} s): mode_used "
              f"{cli['mode_used']}; max |CLI − in-process audio mode| "
              f"{d_us:.3e} µs; fixes {d_fix:.3e} m apart")
        if cli["stations"] != audio_res.station_names or not d_us < 1e-6 \
                or not d_fix < 0.01:
            fails.append(f"audio_match CLI: {d_us} µs, {d_fix} m from the "
                         f"in-process result")
        # The domains alone on the TGT blocks and the template.
        caps = proc.load_files(files)
        tgt = torch.stack([caps[n][1].to(torch.float32)
                           for n in audio_res.station_names], dim=1)
        del caps
        tpl, _ = template_iq(audio, fs_w, WINDOW_BLOCK, FS, AUDIO_DEV,
                             device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        match_template_rf(tgt, tpl, FS, max_lag=AM_MAX_LAG,
                          lo_span_hz=AM_WINDOW_LO_SPAN)
        torch.cuda.synchronize()
        rf_peak = torch.cuda.max_memory_allocated(dev) - held
        ax = fm_demod_decimate(_with_template(tgt, tpl), FS, decim=FM_DECIM)

        def audio_domain():
            return match_template_audio(tgt, tpl, FS, decim=FM_DECIM,
                                        max_lag=AM_MAX_LAG,
                                        seg_len=proc.config.seg_len)

        # CUDA events around a loop of calls (the profiler drops a
        # trace's events now and then); its device time beside.
        audio_ms = _time_ms(audio_domain, 3)
        median_ms = _time_ms(lambda: _median(ax), 3)
        audio_dev = _device_busy_ms(audio_domain, 2)
        top = _top_device_ops(audio_domain)
        # A call takes two medians (the median and the MAD) of [4, L/8].
        print(f"-- {WINDOW_S} s domains: rf peak memory {rf_peak / 1e9:.3f} "
              f"GB above its inputs; audio domain {audio_ms:.3f} ms a call "
              f"(device time {audio_dev:.3f} ms), of it the click "
              f"limiter's two medians of [{ax.shape[0]}, {ax.shape[1]}] "
              f"~{2 * median_ms:.3f} ms ({200 * median_ms / audio_ms:.0f} "
              f"%); most device time: " + "; ".join(
                  f"{n} {ms:.3f} ms ×{c}" for n, ms, c in top))
        del ax, tgt, tpl
        torch.cuda.empty_cache()
        err_ph, span_ph = _template_phase_error(dev, audio, fs_w,
                                                WINDOW_BLOCK)
        print(f"-- {WINDOW_S} s template on the card: phase error against "
              f"float64 {err_ph:.3e} rad (bound {TEMPLATE_PHASE_TOL:g}; "
              f"phase reaches {span_ph:.1f} rad)")
        out[f"{WINDOW_S} s: audio match | audio"].update(
            rf_peak_above_inputs_gb=rf_peak / 1e9, audio_domain_ms=audio_ms,
            audio_device_ms=audio_dev, median_ms=median_ms,
            template_phase_err_rad=err_ph)
        if not err_ph < TEMPLATE_PHASE_TOL:
            fails.append(f"template phase error {err_ph:.3e} rad")
    finally:
        shutil.rmtree(adir, ignore_errors=True)
    torch.cuda.empty_cache()
    return fails


def _window_sharded(dev, files, truth, out) -> list:
    """Scene D: phase 9 on the whole 100 s blocks of the window's files
    (f32; no cut to 440 segments): worlds of 1 rank (NCCL) and of 2 and 4
    gloo ranks sharing the card, both routes in each, against the
    unsharded path on the samples that world's ``_chunk_plan`` keeps
    (the kernel route: the first 1479, 1478 or 1476 kernel segments; the
    segmented route: each rank's whole segments, spliced), demeaned over
    the whole block as the sharded step demeans (1e-3 sample), and
    against the truth (0.5 sample). Returns the failures."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.parallel.launch import spawn
    from tdoa_tpu_torch.parallel.mesh import _chunk_plan
    from tdoa_tpu_torch.pipeline.processor import TDOAProcessor
    from tdoa_tpu_torch.solve.multilateration import station_pairs
    from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG

    names = list(truth["tau_tgt"])  # the files' order
    pairs = station_pairs(len(names))
    geo = TDOAProcessor.from_csv(
        REF_FREQ, TGT_FREQ, str(ROOT / "lat-lon-table.csv"), device="cpu",
    )._ref_geo_tdoa_samples(names, pairs).astype(np.float32)
    geo_d = torch.as_tensor(geo, device=dev)
    tau = truth["tau_tgt"]
    want = np.array([tau[names[j]] - tau[names[i]] for i, j in pairs])
    n, max_lag = WINDOW_BLOCK, DEFAULT_MAX_LAG
    counters, fails = _counters(), []
    blocks = [b.to(dev) for b in _host_blocks(files, n, n)]
    demeaned = [b - (b.sum(-1, keepdim=True, dtype=torch.float64) / n).to(
        torch.float32) for b in blocks]
    del blocks
    single = {}
    for world in SHARD_WORLDS:
        for route in SHARD_ROUTES:
            per, seg, _ = _chunk_plan(n, world, max_lag, SHARD_SEG_LEN, route)
            spans = ([(0, per * world)] if route == "pallas" else
                     [(r * per, r * per + per // seg * seg)
                      for r in range(world)])
            kept = [torch.cat([b[..., lo:hi] for lo, hi in spans], -1)
                    for b in demeaned]
            _reset_counts(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = _unsharded(kept, pairs, geo_d, route, max_lag)
            single[world, route] = r[0].cpu().numpy()
            wall = time.perf_counter() - t0
            launches, shapes = _read_counts(counters)
            used = sum(hi - lo for lo, hi in spans)
            print(f"-- {WINDOW_S} s unsharded {route} on {world} rank(s)' "
                  f"samples ({used} a block, {used // seg} segments of "
                  f"{seg}): {wall:.3f} s; truth err "
                  f"{(single[world, route] - want).round(4).tolist()}; "
                  f"launches {launches}, kernel 1 {shapes['k1_shapes']}")
            out[f"{WINDOW_S} s: unsharded {route}, {world} rank(s)' samples"] \
                = {"wall_s": wall, "launches": launches, **shapes}
            del kept, r
    del demeaned
    torch.cuda.empty_cache()
    for world in SHARD_WORLDS:
        t0 = time.perf_counter()
        ranks = spawn(_shard_rank, world, "cuda", files, n, pairs, geo,
                      max_lag, False, SHARD_ROUTES, n)
        print(f"-- {WINDOW_S} s, {world} rank(s), backend "
              f"{ranks[0]['backend']}: world started, ran and joined in "
              f"{time.perf_counter() - t0:.1f} s  [{_smi()}]")
        for route in SHARD_ROUTES:
            runs = [r[route] for r in ranks]
            dev_single = max(float(np.abs(r["corrected"]
                                          - single[world, route]).max())
                             for r in runs)
            err = runs[0]["corrected"] - want
            counts = _sum_counts(runs)
            print(f"   {route}: truth err {err.round(4).tolist()}, max |Δ| "
                  f"vs unsharded {dev_single:.2e}; wall per rank "
                  f"{[round(r['wall_s'], 4) for r in runs]} s, peak memory "
                  f"per rank {[round(r['peak_bytes'] / 1e9, 2) for r in runs]}"
                  f" GB; launches {counts['launches']}, kernel 1 "
                  f"{counts['k1_shapes']}, kernel 2 {counts['k2_shapes']}")
            out[f"{WINDOW_S} s: sharded {route}, {world} rank(s)"] = {
                "wall_s": max(r["wall_s"] for r in runs),
                "backend": ranks[0]["backend"],
                "peak_gb_by_rank": [r["peak_bytes"] / 1e9 for r in runs],
                "max_dev_vs_unsharded": dev_single,
                "tdoa_err_samples": err.tolist(), **counts}
            if not (dev_single < SHARD_TOL and np.all(np.abs(err) < 0.5)):
                fails.append(f"{WINDOW_S} s {route} at {world} ranks: "
                             f"{dev_single:.2e} from unsharded, truth err "
                             f"{err}")
            if route == "pallas" and counts["launches"]["corr_accum"] != world:
                fails.append(f"{WINDOW_S} s pallas at {world} ranks: kernel "
                             f"1 launched {counts['launches']['corr_accum']} "
                             f"times")
    return fails


def phase_window(dev, tmp: Path):
    """Phase 12: the collector's longest window, 100 s (three blocks of
    66,666,666 samples, 1479 whole kernel segments each): a 3-station
    capture through every IQ path, FM, the processor CLI, the
    overlapped ingest and a tail session; the collector writing a 100 s
    window and ``process_files`` on its files; ``dsp.fm.running_sum``
    over a block; phase 11's 12-station scene on the batch kernel route
    and the overlapped ingest. Capture→fix (last byte → fix for the
    tail session) and peak memory per route printed."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.cli import processor as processor_cli
    from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.pipeline import TDOAProcessor, ingest

    print(f"== phase 12: the collector's {WINDOW_S} s window (3 blocks of "
          f"{WINDOW_BLOCK} samples)")
    out, counters = {}, _counters()
    _, spans = ingest.plan_chunks(WINDOW_BLOCK, SEG_LEN)
    if (WINDOW_BLOCK // SEG_LEN, spans[-1][1] // SEG_LEN) != (
            WINDOW_K1[0][1], WINDOW_K1[2][1]):
        raise RuntimeError(f"phase 3 checked kernel 1 at {WINDOW_K1}, the "
                           f"window has chunks {spans}")
    fails = _window_running_sum(dev)
    wdir = tmp / "window"
    wdir.mkdir()
    t0 = time.perf_counter()
    paths, truth = _synthesize(dev, wdir, prefix="win", block=WINDOW_BLOCK)
    torch.cuda.synchronize()
    print(f"synthesized {len(paths)} x {3 * WINDOW_BLOCK} samples in "
          f"{time.perf_counter() - t0:.1f} s")
    tau_tgt, tgt_tx = truth["tau_tgt"], truth["tgt_lla"]
    csv = str(ROOT / "lat-lon-table.csv")
    for name, cfg, tdoa_tol, fix_tol, must, must_not in PATHS:
        key = f"{WINDOW_S} s: {name}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        out[key] = _run_path(dev, paths, tau_tgt, tgt_tx, key, cfg,
                             tdoa_tol, fix_tol, must, must_not)
        out[key]["peak_gb"] = _peak_gb(dev)
        print(f"peak memory {out[key]['peak_gb']:.2f} GB")
        if cfg.get("mode", "iq") == "iq":  # the routes the verdict reckons
            kernel_need, segmented_need = TDOAProcessor.from_csv(
                REF_FREQ, TGT_FREQ, csv, device=dev,
                **cfg).route_bytes(3, WINDOW_BLOCK)
            _held_to_reckoning(
                key, torch.cuda.max_memory_allocated(dev) - held,
                segmented_need if cfg.get("accumulator") == "xla"
                else kernel_need, out, fails)
    fused = out[f"{WINDOW_S} s: fused IQ"]["tdoa_by_pair"]

    # The processor CLI in this process, on the same files.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, text, _ = _tool(processor_cli.main, [str(REF_FREQ), str(TGT_FREQ),
                                             csv, *paths, "--json"])
    wall = time.perf_counter() - t0
    launches, shapes = _read_counts(counters)
    cli = json.loads(text.strip().splitlines()[-1])
    err_c = np.array([t * 1e-6 * FS - (tau_tgt[b] - tau_tgt[a])
                      for (a, b), t in zip(cli["pairs"], cli["tdoa_us"])])
    fix_c = _fix_err_m(SimpleNamespace(**cli["fix"]), tgt_tx)
    key = f"{WINDOW_S} s: processor CLI"
    print(f"-- {key}: exit {rc}, {wall:.3f} s, peak memory "
          f"{_peak_gb(dev):.2f} GB; TDOA err {np.round(err_c, 4).tolist()} "
          f"samples, fix {fix_c:.1f} m; launches {launches}")
    out[key] = {"wall_s": wall, "peak_gb": _peak_gb(dev),
                "launches": launches, **shapes,
                "tdoa_err_samples": err_c.tolist(), "fix_err_m": fix_c}
    if rc != 0 or not (np.all(np.abs(err_c) < 0.5) and fix_c < 200.0) \
            or launches["corr_accum"] != 3:
        fails.append(f"processor CLI: exit {rc}, TDOA error {err_c}, fix "
                     f"{fix_c:.1f} m, launches {launches}")

    # The overlapped ingest and a tail session on the same files.
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ, csv, device=dev)
    res, wall, launches, shapes, peak = _timed_run(
        dev, counters, lambda: proc.process_files_overlapped(paths))
    diag = dict(proc.ingest_diag)
    copy_s = diag["transfer_stream_s"]  # CUDA events; None on the CPU
    key = f"{WINDOW_S} s: process_files_overlapped"
    print(f"-- {key}: {wall:.3f} s, peak memory {peak:.2f} GB  [{_smi()}]; "
          f"chunks {diag['n_chunks']} of {diag['chunk_segs']} segments; "
          f"gather {diag['gather_s'] * 1e3:.1f} ms, copy stream "
          f"{_dev_str(copy_s and copy_s * 1e3, 1)}; launches {launches}, "
          f"kernel 1 {shapes['k1_shapes']}")
    out[key] = {"wall_s": wall, "peak_gb": peak, "launches": launches,
                **shapes, "diag": diag, **_check_overlap_result(
                    key, res, tau_tgt, tgt_tx, fused)}
    if launches["corr_accum"] != len(spans) or diag["n_chunks"] != len(spans):
        fails.append(f"overlapped: {launches['corr_accum']} launches of "
                     f"kernel 1 for a plan of {len(spans)} chunks")
    names = sorted(res.station_names)
    views = []
    for n in names:
        raw = np.memmap(next(p for p in paths if f"-{n}-" in p),
                        dtype=np.uint8, mode="r")
        views.append(iq_bytes_as_u16(raw[: (raw.size // 2) * 2]))
    _tail_run(proc, names, views, WINDOW_BLOCK)  # warm-up
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts(counters)
    res_t, sess, before, after_s = _tail_run(proc, names, views,
                                             WINDOW_BLOCK)
    launches, shapes = _read_counts(counters)
    ready = _tail_ready(spans, WINDOW_BLOCK, views[0].shape[0])
    key = f"{WINDOW_S} s: tail session"
    print(f"-- {key}: {before}/{sess.total_chunks} chunks dispatched before "
          f"the last tenth of the files ({ready} ready); last byte → fix "
          f"{after_s:.3f} s, peak memory {_peak_gb(dev):.2f} GB; launches "
          f"{launches}, kernel 1 {shapes['k1_shapes']}")
    out[key] = {"wall_s": after_s, "peak_gb": _peak_gb(dev),
                "launches": launches, **shapes, "chunks_before_close": before,
                "total_chunks": sess.total_chunks, **_check_overlap_result(
                    key, res_t, tau_tgt, tgt_tx, fused)}
    if before != ready or launches["corr_accum"] != sess.total_chunks \
            or launches["zoom_probe"] != 3:
        fails.append(f"tail: {before} chunks before the last tenth ({ready} "
                     f"ready), launches {launches}")
    del views
    fails += _window_sharded(dev, paths, truth, out)  # scene D
    shutil.rmtree(wdir, ignore_errors=True)
    fails += _window_collector(dev, tmp, counters, out)
    shutil.rmtree(tmp / "window-collector", ignore_errors=True)
    torch.cuda.empty_cache()
    fails += _window_network(dev, tmp, counters, out)
    torch.cuda.empty_cache()
    fails += _window_network(dev, tmp, counters, out,  # scene A
                             NET24_STATIONS, NET24_CLOCK_OFFSETS_S, tail=True)
    torch.cuda.empty_cache()
    fails += _window_motion(dev, tmp, counters, out)  # scene B
    fails += _window_audio(dev, tmp, counters, out)  # scene C
    print(json.dumps({"window": {
        k: {kk: vv for kk, vv in v.items()
            if kk not in (*SHAPE_KEYS.values(), "tdoa_by_pair")}
        for k, v in out.items()}}))
    if fails:
        raise RuntimeError("phase 12: " + "; ".join(fails))
    return out


def phase_slice(dev, tmp: Path):
    """Phases 4 and 5 on a synthesized capture written into ``tmp``;
    returns (the paths' results, the files, the truth)."""
    import torch

    print("== phase 4: the slice (3 stations, 30 s capture), three paths")
    t0 = time.perf_counter()
    paths, truth = _synthesize(dev, tmp)
    tau_tgt, tgt_tx = truth["tau_tgt"], truth["tgt_lla"]
    torch.cuda.synchronize()
    print(f"synthesized {len(paths)} x {3 * BLOCK} samples in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name, cfg, tdoa_tol, fix_tol, must, must_not in PATHS:
        out[name] = _run_path(dev, paths, tau_tgt, tgt_tx, name, cfg,
                              tdoa_tol, fix_tol, must, must_not)
        torch.cuda.empty_cache()
    out.update(phase_overlap(dev, paths, tau_tgt, tgt_tx,
                             out["fused IQ"]["tdoa_by_pair"]))
    return out, paths, truth


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel3-only", action="store_true",
                    help="phases 1 and 2, then kernel 3's checks and times "
                         "alone (for work on that kernel; prints no result "
                         "line)")
    args = ap.parse_args()
    if not (ROOT / "tdoa_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(tdoa_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs the card", file=sys.stderr)
        return 2
    dev = phase_device()
    phase_build()
    if args.kernel3_only:
        print(json.dumps({"kernels": _kernel3(
            dev, torch.Generator(device=dev).manual_seed(SEED))}))
        return 0
    kernels = phase_kernels(dev)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:  # phase 4's files serve phase 8 too
        paths, files, truth = phase_slice(dev, tmp)
        paths.update(phase_motion(dev))
        paths.update(phase_audio_match(dev))
        paths.update(phase_tools(dev, files, truth, tmp))
        paths.update(phase_sharded(dev, files, truth))
        paths.update(phase_calibration(dev, tmp))
        paths.update(phase_network(dev, tmp))
        paths.update(phase_window(dev, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # Every kernel is held against its plain version shape by shape: a
    # path may launch it at no shape that phase 3 did not check, and an
    # entry with a shape counts the launches at that shape.
    later_k1 = [tuple(key) for k in kernels
                for key in k.get("launch_keys", [])]
    checked = {"k1_shapes": set(map(str, (
                   BATCH_SHAPE, *STREAM_SHAPES, *later_k1))),
               "k2_shapes": set(map(str, K2_SHAPES + SHARD_K2_SHAPES
                                    + CAL_K2_SHAPES + NET_K2_SHAPES
                                    + NET_SHARD_K2_SHAPES)),
               "k3_shapes": set(map(str, K3_SHAPES + CAL_K3_SHAPES
                                    + WINDOW_K3_SHAPES)),
               "k4_shapes": set(map(str, K4_SHAPES))}
    for p, r in paths.items():
        for key, ok in checked.items():
            if set(r[key]) - ok:
                raise RuntimeError(f"{p}: {key} {r[key]}, phase 3 checked "
                                   f"{sorted(ok)}")
    for k in kernels:
        if "shape" in k:  # one kernel at one shape (kernel 1: its tiles')
            key = SHAPE_KEYS[k["name"].split("[")[0]]
            shapes = set(map(tuple, k.get("launch_keys", [k["shape"]])))
            by_path = {p: sum(r[key].get(str(sh), 0) for sh in shapes)
                       for p, r in paths.items()}
        else:
            by_path = {p: r["launches"][k["name"]] for p, r in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']} was launched on no path")
    for p, r in paths.items():
        r.pop("tdoa_by_pair", None)
        print(f"slice wall time, {p}: {r['wall_s']:.3f} s")
    print(json.dumps({"kernels": kernels}))
    print(_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
