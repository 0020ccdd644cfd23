#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tdoa_tpu_torch``) on one H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel3-only   # phases 1-2 and kernel 3 alone

Phases, each printing its own lines; any failure exits non-zero:

1. device  — CUDA with compute capability 9.0, versions, card name and
             power limit, TF32 off;
2. build   — the three hand-written kernels from ``tdoa_tpu_torch/csrc/``
             (one nvcc per source, started together);
3. kernels — each kernel against its plain torch version on the card
             (kernel 1: 3 stations, K = 4, DC sums on, bf16, at 16
             segments and at a 10 s block's 443 segments, whose banks
             span many chunks, and 12 stations × 5 segments × K = 2, the
             branch that reloads its accumulators, and at the streaming
             shapes: one bank over 96 segments and over 59 segments (a
             capture's short last chunk), each on the overlapped
             ingest's 9 rows and on a tail session's 3; no path may
             launch it at a shape not checked here; kernel 2: K = 4,
             m = 3, F = 65536 on the 443-segment banks, and the
             segmented path's 9 pairs of 9 channels; kernel 3: 9
             channels × 20 M samples, D = 8, then 3 channels × 2 M
             samples on rows that are not 16-byte aligned, its scalar
             loads, and at D = 16; and 4 channels × 20 M samples, D = 8,
             the audio match's stations and template; no path may
             launch it at a shape not checked here), each launched twice
             on the same input (the outputs must be bitwise equal), then
             each timed at the main path's shapes beside its bound (bytes
             over 3.35 TB/s or f32 operations over 67 TFLOP/s, the
             larger): CUDA events around a loop of wrapper calls
             (``ms``, the host's share included where it is the slower
             side), and the kernel's own device time per call from
             ``torch.profiler`` (``device_ms``);
4. slice   — a synthesized 3-station 30 s capture (three 10 s blocks of
             20 M samples, ``lat-lon-table.csv`` geometry, an FM-like
             source, per-station clock offsets, noise) written as u8
             ``.dat`` files and run through ``TDOAProcessor.process_files``
             on three paths, each run twice (warm-up, then timed with
             every launch count set to 0 just before it):
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
             trial's 4 × 2^17) are checked in phase 3.

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
# Kernel 1's shape on the batch path (stations, segments, banks), and
# its streaming shapes: a default chunk and a 10 s block's short last
# chunk (443 = 4·96 + 59), each over the stacked 9 rows of the
# overlapped ingest and over the 3 rows of a tail session's block.
BATCH_SHAPE = (3, 443, 4)
STREAM_SHAPES = ((9, 96, 1), (9, 59, 1), (3, 96, 1), (3, 59, 1))
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
SHARD_K1_SHAPES = ((9, 440, 1), (9, 220, 1), (9, 110, 1), (9, 440, 4))
DRYRUN_K1_SHAPES = ((3, 1, 1), (3, 4, 2))
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


def _device_ms(fn, kernel: str, iters: int) -> float:
    """The device time per launch of the CUDA kernel whose name contains
    ``kernel`` (each wrapper call launches it once; the wrapper's other
    ops are left out), from a ``torch.profiler`` trace of ``iters``
    calls after a warm-up. Divided by the launches the trace holds: the
    profiler can drop events of a cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if kernel in e.key and e.device_time_total > 0]
    if not seen:
        raise RuntimeError(f"the profiler saw no device time of {kernel}")
    return (sum(e.device_time_total for e in seen)
            / sum(e.count for e in seen) / 1e3)


def _same(a, b) -> bool:
    """Bitwise equality of two outputs (tensors or tuples of them)."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
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


def _pair_list(n_st: int, stacked: bool) -> list:
    """All pairs of ``n_st`` stations; ``stacked``: the 3-station pairs of
    each block of ``n_st // 3`` stacked blocks, offset into the row axis
    (the overlapped ingest's layout: 9 rows carry 9 pairs)."""
    if stacked:
        return [(3 * b + i, 3 * b + j) for b in range(n_st // 3)
                for i, j in ((0, 1), (0, 2), (1, 2))]
    return [(i, j) for i in range(n_st) for j in range(i + 1, n_st)]


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

    # Kernel 1 at the stated check shape (16 segments: one chunk), at the
    # main path's (a 10 s block is 443 segments: chunks of bank_run
    # segments from each of the banks 111/111/111/110, every CTA keeping
    # its items' accumulators in shared memory across the chunks), and
    # at 12 stations (66 pairs, 172 KB of accumulators an item: the
    # branch that reloads them from the outputs at every chunk). Each is
    # launched twice: the outputs must be bitwise equal.
    # The streaming shapes come last: one bank (K = 1) over the stacked
    # 9 rows × 9 pairs of a default chunk and of a capture's short last
    # chunk, and the same two chunks over a tail session's 3 rows.
    k1_abs, k1_rel, k1_cfg = 0.0, 0.0, {}
    stream_x, stream_err = {}, {}
    for n_st, n_seg, kb in ((3, 16, K), (3, 443, K), (12, 5, 2),
                            *STREAM_SHAPES):
        x = block(n_seg, n_st)
        pn = _pair_list(n_st, stacked=kb == 1)
        cfg = corr_accum.kernel_config(n_st, len(pn), True, kb)
        run = corr_accum.bank_run(n_st, kb, n_seg)
        cfg.update(run=run, chunks=int(corr_accum.chunk_plan(
            n_seg, kb, run).shape[0]))
        got = corr_accum.accumulate_banks(x, pn, kb, True)
        again = corr_accum.accumulate_banks(x, pn, kb, True)
        want = corr_accum.accumulate_banks_plain(x, pn, kb, True)
        torch.cuda.synchronize()
        errs = [_errs(a, b) for a, b in zip(got, want)]
        a_err, r_err = max(e[0] for e in errs), max(e[1] for e in errs)
        same = _same(got, again)
        if kb == 1:
            stream_x[(n_st, n_seg, kb)] = x
            stream_err[(n_st, n_seg, kb)] = (a_err, r_err)
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
        if n_seg == 443:
            x443, got443 = x, got
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
    k1_dev = _device_ms(k1_call, "corr_accum_kernel", 5)
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
          f"(device time {k1_dev:.3f} ms), plain {k1_plain:.3f} ms, "
          f"bound {b1['bound_ms']:.4f} ms "
          f"({b1['bound_by']}: {b1['bytes'] / 1e6:.1f} MB, "
          f"{b1['ops'] / 1e9:.2f} GFLOP)")
    print(f"time zoom_probe [K={K}, m=3, F=65536]: kernel {k2_ms:.4f} ms "
          f"(device time {k2_dev:.4f} ms), plain {k2_plain:.3f} ms, "
          f"bound {b2['bound_ms']:.4f} ms "
          f"({b2['bound_by']}: {b2['bytes'] / 1e6:.2f} MB, "
          f"{b2['ops'] / 1e9:.3f} GFLOP)")
    del x443, got443
    streaming = []
    for shape in STREAM_SHAPES:
        n_s, n_seg_s, kb = shape
        xs = stream_x.pop(shape)
        pn = _pair_list(n_s, stacked=True)
        call = lambda: corr_accum.accumulate_banks(xs, pn, kb, True)  # noqa: E731
        ms = _time_ms(call, 10)
        dev_ms = _device_ms(call, "corr_accum_kernel", 10)
        plain = _time_ms(lambda: corr_accum.accumulate_banks_plain(
            xs, pn, kb, True), 2)
        bs = _k1_bound(n_s, len(pn), n_seg_s, kb)
        name = f"corr_accum[{n_s}x{n_seg_s},K={kb}]"
        print(f"time {name}: kernel {ms:.3f} ms (device time {dev_ms:.3f} "
              f"ms), plain {plain:.3f} ms, bound {bs['bound_ms']:.4f} ms "
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
         "launch": k1_cfg},
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
              f"ms (device time {dev_ms:.3f} ms), plain {plain:.3f} ms, "
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
           bound, iters):
    """A ``kernels`` entry for one kernel at one shape: its check's error,
    its time (event loop and profiler device time) beside the plain
    version's and the bound. Prints one line."""
    ms = _time_ms(call, iters)
    dev_ms = _device_ms(call, kernel, iters)
    plain = _time_ms(plain_call, 2)
    print(f"time {name}: kernel {ms:.4f} ms (device time {dev_ms:.4f} ms), "
          f"plain {plain:.3f} ms, bound {bound['bound_ms']:.5f} ms "
          f"({bound['bound_by']}: {bound['bytes'] / 1e6:.2f} MB, "
          f"{bound['ops'] / 1e9:.3f} GFLOP)")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": list(shape), "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": None, "bitwise_deterministic": True}


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

    k1_src = ("tdoa_tpu_torch/csrc/corr_accum.cu",
              "tdoa_tpu/ops/pallas/corr_accum.py:634")
    k2_src = ("tdoa_tpu_torch/csrc/zoom_probe.cu",
              "tdoa_tpu/ops/pallas/zoom_probe.py:244")
    k3_src = ("tdoa_tpu_torch/csrc/fm_demod.cu",
              "tdoa_tpu/ops/pallas/fm_demod.py:189")
    entries = []
    # Kernel 1 as the sharded paths run it: f32, one bank or the
    # comparator's banks, no DC sums.
    for n_st, n_seg, kb in SHARD_K1_SHAPES + DRYRUN_K1_SHAPES:
        x = _k1_block(dev, g, n_seg, n_st, torch.float32)
        pn = _pair_list(n_st, stacked=n_st == 9)
        got = corr_accum.accumulate_banks(x, pn, kb, False)[:2]
        again = corr_accum.accumulate_banks(x, pn, kb, False)[:2]
        want = corr_accum.accumulate_banks_plain(x, pn, kb, False)[:2]
        torch.cuda.synchronize()
        errs = [_errs(a, b) for a, b in zip(got, want)]
        a_err, r_err = max(e[0] for e in errs), max(e[1] for e in errs)
        same = _same(got, again)
        print(f"corr_accum [{n_st} st, {n_seg} seg, K={kb}, f32]: max "
              f"|kernel - plain| = {a_err:.3e}, / row peak = {r_err:.3e} "
              f"(tol {K1_TOL:g}); two launches bitwise equal: {same}")
        if not (r_err < K1_TOL and same):
            raise RuntimeError(f"corr_accum at {n_st} st, {n_seg} seg, "
                               f"K={kb}, f32: error {r_err:.3e}, "
                               f"deterministic {same}")
        entries.append(_entry(
            f"corr_accum[{n_st}x{n_seg},K={kb},f32]", *k1_src,
            (n_st, n_seg, kb), a_err,
            lambda: corr_accum.accumulate_banks(x, pn, kb, False),  # noqa: B023
            lambda: corr_accum.accumulate_banks_plain(x, pn, kb, False),  # noqa: B023
            "corr_accum_kernel",
            _k1_bound(n_st, len(pn), n_seg, kb, 4, False), 10))
        del x, got, again, want
    # Kernel 2 on banks that the segmented correlator accumulates from
    # rows with planted integer delays (2 segments a bank), the coarse
    # delays the planted ones.
    for K, m, F in SHARD_K2_SHAPES + CAL_K2_SHAPES:
        # m pairs: of 3 stations, or of 3 stacked blocks of 3, 4 or 5.
        n_st, grp = {3: (3, 3), 9: (9, 3), 18: (12, 4), 30: (15, 5)}[m]
        pn = [(grp * b + i, grp * b + j) for b in range(n_st // grp)
              for i, j in _pair_list(grp, stacked=False)]
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
    for C, n, decim in CAL_K3_SHAPES:
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
        print(f"fm_demod [{C} ch x {n} samples, D={decim}]: max |kernel - "
              f"plain| = {err:.3e} (tol {K3_TOL:g}); two launches bitwise "
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
    return entries


def _synthesize(dev, out_dir: Path, lo_ppm=(0.0, 0.0, 0.0), mover_enu=None,
                interferer_lla=None, prefix: str = "sim"):
    """Write one u8 [REF | TGT | REF] .dat per station; return (paths,
    truth). ``truth``: per-station TGT delays (samples) at the TGT
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

    table = load_station_table(str(ROOT / "lat-lon-table.csv"),
                               reference_freq=REF_FREQ)
    # The table's KEVO row is the target transmitter; the other
    # callsign rows are the receivers.
    tgt0 = table["KEVO"].lla()
    names = [n for n in table.names if n != "KEVO"]
    st = lla_to_ecef(table.lla_array(names))
    t_mid_tgt = 1.5 * BLOCK / FS
    v_ecef = np.zeros(3)
    if mover_enu is not None:
        v_ecef = (enu_to_ecef(np.asarray(mover_enu, np.float64), tgt0)
                  - enu_to_ecef(np.zeros(3), tgt0))
    p_tgt = lla_to_ecef(tgt0) + v_ecef * t_mid_tgt
    u = st - p_tgt
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    rate_motion = -(u @ v_ecef) / SPEED_OF_LIGHT  # d|station - p|/dt / c
    drift = 1e-6 * np.asarray(lo_ppm, np.float64)

    def delays(tx_ecef):
        return np.linalg.norm(st - tx_ecef, axis=-1) / SPEED_OF_LIGHT * FS

    tau = {"ref": delays(lla_to_ecef(table.reference_tx.lla())),
           "tgt": delays(p_tgt)}
    tau_int = (None if interferer_lla is None
               else delays(lla_to_ecef(np.asarray(interferer_lla))))
    pad = 4096
    n_fft = 1 << (BLOCK + 2 * pad).bit_length()  # > BLOCK + pad + delays
    g = torch.Generator(device=dev).manual_seed(SEED)
    f = torch.fft.fftfreq(n_fft, device=dev, dtype=torch.float64)
    t_rel = (torch.arange(BLOCK, device=dev, dtype=torch.float64)
             - (BLOCK - 1) / 2.0) / FS

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
            torch.ones_like(f), -2 * np.pi * f * d))[pad:pad + BLOCK]

    raw = {n: [] for n in names}
    for b, kind in enumerate(("ref", "tgt", "ref")):
        carrier = TGT_FREQ if kind == "tgt" else REF_FREQ
        # Each station's clock at this block's midpoint, in samples.
        clock = (np.asarray(CLOCK_OFFSETS_S)
                 + drift * (b + 0.5) * BLOCK / FS) * FS
        rate = drift + (rate_motion if kind == "tgt" else 0.0)
        spec = source()
        spec_int = (source() if kind == "tgt" and tau_int is not None
                    else None)
        for s, name in enumerate(names):
            z = delayed(spec, tau[kind][s] + clock[s])
            if rate[s] != 0.0:
                z *= torch.polar(torch.ones_like(t_rel),
                                 -2 * np.pi * carrier * rate[s] * t_rel)
            if spec_int is not None:
                z += delayed(spec_int, tau_int[s] + clock[s])
            noise = torch.randn(2, BLOCK, device=dev, generator=g,
                                dtype=torch.float64)
            iq = torch.stack([0.3 * z.real + 0.1 * noise[0],
                              0.3 * z.imag + 0.1 * noise[1]], dim=-1)
            u8 = torch.clamp(torch.floor(iq * 127.5 + 128.0), 0, 255)
            raw[name].append(u8.to(torch.uint8).reshape(-1).cpu().numpy())
            del z, noise, iq, u8
        del spec, spec_int
    paths = []
    for name in names:
        p = out_dir / f"{prefix}-{name}-1700000000.dat"
        with open(p, "wb") as fh:
            for part in raw[name]:
                fh.write(part.tobytes())
        paths.append(str(p))
    truth = {"tau_tgt": dict(zip(names, tau["tgt"])),
             "tgt_lla": ecef_to_lla(p_tgt),
             "rate": dict(zip(names, rate_motion)), "v_ecef": v_ecef,
             "tau_int": None if tau_int is None else dict(zip(names, tau_int)),
             "int_lla": (None if interferer_lla is None
                         else np.asarray(interferer_lla, np.float64))}
    return paths, truth


# The paths phase 4 drives on the same files: (name, processor settings,
# TDOA bound in samples, fix bound in m, kernels that must launch,
# kernels that must not).
PATHS = (
    ("fused IQ", {}, 0.5, 200.0, ("corr_accum", "zoom_probe"), ()),
    ("segmented IQ (accumulator=xla)", {"accumulator": "xla"}, 0.5, 200.0,
     ("zoom_probe",), ("corr_accum", "fm_demod")),
    ("FM (mode=fm)", {"mode": "fm", "fm_decim": FM_DECIM}, 16.0, 4000.0,
     ("fm_demod",), ("corr_accum",)),
)


def _counters():
    from tdoa_tpu_torch.ops.kernels import corr_accum, fm_demod, zoom_probe

    return {"corr_accum": corr_accum.accumulate_banks,
            "zoom_probe": zoom_probe.loo_zoom_windows,
            "fm_demod": fm_demod.fm_demod_decimate}


def _reset_counts(counters):
    """Every launch count and shape count to 0 (then a path runs)."""
    for fn in counters.values():
        fn.launches = 0
        fn.launch_shapes.clear()


# Each kernel's launches by shape: kernel 1 by (rows, segments, banks),
# kernel 2 by (banks, pairs, FFT length), kernel 3 by (channels,
# samples, decimation).
SHAPE_KEYS = {"corr_accum": "k1_shapes", "zoom_probe": "k2_shapes",
              "fm_demod": "k3_shapes"}


def _read_counts(counters):
    """(launches by kernel, {"k1_shapes": ..., "k2_shapes": ...,
    "k3_shapes": ...}: each kernel's launches by shape) since the
    reset."""
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


def phase_overlap(dev, paths, tau_tgt, tgt_tx, fused_by_pair):
    """Phase 5 on phase 4's files: overlapped ingest, the streaming loop
    without a host wait, a checkpoint round trip, a tail session."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.pipeline import TDOAProcessor, ingest, streaming
    from tdoa_tpu_torch.pipeline.processor import HostCapture
    from tdoa_tpu_torch.solve.multilateration import station_pairs

    print("== phase 5: overlapped ingest, checkpoint, tail session")
    proc = TDOAProcessor.from_csv(REF_FREQ, TGT_FREQ,
                                  str(ROOT / "lat-lon-table.csv"), device=dev)
    counters = _counters()
    _, spans = ingest.plan_chunks(BLOCK, SEG_LEN)
    n_chunks = len(spans)
    if {(rows, n // SEG_LEN, 1) for rows in (9, 3)
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
          f"{launches}, kernel 1 by (rows, segments, banks) "
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

    def tail_run():
        sess = proc.tail_session(t_names, BLOCK)
        before = 0
        for k in range(1, 10):
            before += sess.feed([v[:total * k // 10] for v in t_views])
        caps = {n: HostCapture(u16=v, block_len=BLOCK)
                for n, v in zip(t_names, t_views)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the last byte lands now
        r = proc.process_captures(caps, tail=sess)
        return r, sess, before, time.perf_counter() - t0

    tail_run()  # warm-up at the 3-row shapes
    _reset_counts(counters)
    res_t, sess, before, after_s = tail_run()
    launches_t, shapes_t = _read_counts(counters)
    print(f"-- tail session: {before}/{sess.total_chunks} chunks dispatched "
          f"before the last tenth of the files; last byte → fix "
          f"{after_s:.3f} s; launches {launches_t}, kernel 1 by shape "
          f"{shapes_t['k1_shapes']}; copy stream "
          f"{sess.link_diag['transfer_stream_s'] * 1e3:.1f} ms")
    # Every chunk whose samples lay within the first nine tenths of the
    # files went out before the last tenth arrived (with four or fewer
    # chunks a block that is all but two of them).
    ready = sum(1 for b in range(3) for start, n in spans
                if b * BLOCK + start + n <= total * 9 // 10)
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


def _check_joint(res, truth, launches):
    """(b): a mover and a static interferer separated jointly in lag and
    Doppler, each with its own velocity."""
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
    if not _fix_err_m(static.fix, truth["int_lla"]) < 1000.0:
        fails.append("the static emitter's fix is more than 1000 m off")
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


def _audio_scene(dev, audio44, **kw):
    """The known-audio scene over ``lat-lon-table.csv`` (KEVO the target,
    the other callsign rows the receivers), 30 s, the smoke's clock
    offsets, the recording resampled to the capture rate on the card."""
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
        block_len=BLOCK, clock_offsets_s=np.array(CLOCK_OFFSETS_S),
        tgt_audio=audio_fs, tgt_deviation_hz=AUDIO_DEV, seed=SEED, **kw)


def _truth_errors(res, names, truth):
    """Corrected TDOAs of ``res`` minus the scene's geometric TGT TDOAs
    (``names``: the scene's station order of ``truth``)."""
    import numpy as np

    tau = dict(zip(names, truth.station_delays_samples[:, 1]))
    return np.asarray(res.corrected_tdoa_samples) - np.array(
        [tau[res.station_names[j]] - tau[res.station_names[i]]
         for i, j in res.pair_idx])


def _check_audio_match(mode, res, err, fix_err, launches, shapes):
    """tests/test_audio_match.py's bounds, and the kernels each domain
    runs: kernel 1 three times at the batch shape (the pairwise pass),
    kernel 3 once at (4, BLOCK, 8) when the audio domain runs, never in
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
            str(BATCH_SHAPE): 3}:
        fails.append(f"pairwise pass: kernel 1 {shapes['k1_shapes']}")
    k3 = {} if mode == "rf" else {str((4, BLOCK, FM_DECIM)): 1}
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


def _template_phase_error(dev, audio, fs_w):
    """The largest phase error of the card's template (f32 resampling
    and cumulative sum) against the same template in float64 on the
    card, radians."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.pipeline.audio_match import template_iq

    tpl, _ = template_iq(audio, fs_w, BLOCK, FS, AUDIO_DEV, device=dev)
    a = torch.from_numpy(np.asarray(audio, np.float64)).to(dev)
    n_in = int(a.shape[0])
    n_res = int(round(n_in * FS / fs_w))  # upsampled, then cut to BLOCK
    spec = torch.nn.functional.pad(torch.fft.rfft(a),
                                   (0, n_res // 2 + 1 - (n_in // 2 + 1)))
    if n_in % 2 == 0:  # an even input's Nyquist bin splits in two
        spec[n_in // 2] *= 0.5
    a = torch.fft.irfft(spec, n=n_res)[:BLOCK] * (n_res / n_in)
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


def _host_blocks(paths, n_use: int):
    """Phase 4's files as three planar f32 [2, n_st, n_use] host tensors
    (REF₁, TGT, REF₂), each block cut to its first ``n_use`` samples."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.io.datfile import bytes_to_iq_planar

    raws = [np.fromfile(p, dtype=np.uint8) for p in paths]
    return [torch.stack([bytes_to_iq_planar(torch.from_numpy(
        raw[2 * b * BLOCK:2 * b * BLOCK + 2 * n_use])) for raw in raws],
        dim=1) for b in range(3)]


def _shard_rank(paths, n_use, pairs, geo, max_lag, dryrun):
    """One rank of phase 9: the sharded step on each route (a warm-up,
    then a timed run with the launch counts set to 0 just before it and
    read just after), the rank's peak device memory; with ``dryrun``,
    then ``parallel.dryrun`` on the world, its launches counted apart."""
    import torch
    import torch.distributed as dist

    from tdoa_tpu_torch.parallel import make_mesh, process_blocks_sharded
    from tdoa_tpu_torch.parallel.dryrun import dryrun_multichip

    mesh = make_mesh()
    blocks = _host_blocks(paths, n_use)
    counters = _counters()
    out = {"rank": mesh.rank, "backend": dist.get_backend(mesh.group)}
    for route in SHARD_ROUTES:
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

    from tdoa_tpu_torch.ops.corr import (
        clock_correct_blocks,
        correlate_pairs_fused,
    )
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN
    from tdoa_tpu_torch.parallel.launch import spawn
    from tdoa_tpu_torch.pipeline.processor import TDOAProcessor, process_blocks
    from tdoa_tpu_torch.solve.multilateration import station_pairs
    from tdoa_tpu_torch.utils.constants import DEFAULT_MAX_LAG

    print("== phase 9: the sequence-parallel step (tdoa_tpu_torch/parallel)")
    names = list(truth["tau_tgt"])  # the files' order
    pairs = station_pairs(len(names))
    m = len(pairs)
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

    def unsharded(route):
        if route == "xla":
            return process_blocks(*blocks, pairs, geo_d, max_lag=max_lag,
                                  seg_len=SHARD_SEG_LEN, weighting="ht",
                                  accumulator="xla")
        x = torch.cat(blocks, dim=1)
        x -= x.mean(-1, keepdim=True)
        all_pairs = (pairs[None] + np.arange(3)[:, None, None] * len(names)
                     ).reshape(-1, 2)
        r = correlate_pairs_fused(x, all_pairs, max_lag=max_lag,
                                  weighting="ht")
        return clock_correct_blocks(
            r.delay.reshape(3, m), r.delay_std.reshape(3, m),
            r.quality.reshape(3, m), r.peak_value.reshape(3, m),
            r.corr.reshape(3, m, -1), r.corr_c.reshape(3, m, -1), geo_d)

    counters = _counters()
    single = {}
    for route in SHARD_ROUTES:
        unsharded(route)  # warm-up
        torch.cuda.synchronize()
        _reset_counts(counters)
        t0 = time.perf_counter()
        out = unsharded(route)
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


def phase_calibration(dev):
    """Phase 10: the calibration sweeps at reduced size on the card, with
    their gates (every Monte Carlo regime at its floor and no silent
    failure; the pooled 3σ coverage of the gated ellipse regimes ≥
    90 %) and the kernels' launches by shape."""
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
    if failed or silent or not covered:
        raise RuntimeError(f"phase 10: {failed} regime(s) below the floor, "
                           f"{silent} silent failure(s), pooled 3σ gate "
                           f"met: {covered}")
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
        paths.update(phase_calibration(dev))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # Every kernel is held against its plain version shape by shape: a
    # path may launch it at no shape that phase 3 did not check, and an
    # entry with a shape counts the launches at that shape.
    checked = {"k1_shapes": set(map(str, (
                   BATCH_SHAPE, *STREAM_SHAPES, *SHARD_K1_SHAPES,
                   *DRYRUN_K1_SHAPES))),
               "k2_shapes": set(map(str, K2_SHAPES + SHARD_K2_SHAPES
                                    + CAL_K2_SHAPES)),
               "k3_shapes": set(map(str, K3_SHAPES + CAL_K3_SHAPES))}
    for p, r in paths.items():
        for key, ok in checked.items():
            if set(r[key]) - ok:
                raise RuntimeError(f"{p}: {key} {r[key]}, phase 3 checked "
                                   f"{sorted(ok)}")
    for k in kernels:
        if "shape" in k:  # one kernel at one shape
            key = SHAPE_KEYS[k["name"].split("[")[0]]
            by_path = {p: r[key].get(str(tuple(k["shape"])), 0)
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
