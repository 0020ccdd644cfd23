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
             loads, and at D = 16), each launched twice on the
             same input (the outputs must be bitwise equal), then each
             timed at the main path's shapes beside its bound (bytes
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
             ``process_captures(caps, tail=session)`` to the same bounds.

The last two lines are the card's ``nvidia-smi`` name and power limit,
then ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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


def _k1_bound(n_st: int, m: int, n_seg: int, n_banks: int) -> dict:
    """Kernel 1's bound: bf16 planar input read once; cross, psd and
    DC-sum banks written once. Operations: a 5·F·log2(F) complex FFT per
    station and segment, 8 per bin per pair (cross MAC), 4 (PSD) and 2
    (sums) per bin per station."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import FFT_LEN as F
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN

    return _bound(
        2 * n_st * n_seg * SEG_LEN * 2
        + n_banks * F * (8 * m + 4 * n_st + 8 * n_st),
        n_seg * F * (n_st * 5 * 16 + 8 * m + 6 * n_st))


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

    # Kernel 2 at the segmented IQ path's shape too: K = 4 banks of the
    # 9 pairs of 3 stacked blocks × 3 stations, F = 65536, from the
    # segmented correlator's own accumulation (8 segments of 45536).
    from tdoa_tpu_torch.ops.corr import _accumulate_cross_spectra

    seg9, n9 = 65536 - 20000, 9
    x9 = torch.randn(2, n9, 8 * seg9, device=dev, generator=g)
    for b in range(3):
        x9[:, 3 * b + 1] += 0.5 * torch.roll(x9[:, 3 * b], 37, dims=-1)
        x9[:, 3 * b + 2] += 0.5 * torch.roll(x9[:, 3 * b], -12, dims=-1)
    pairs9 = [(3 * b + i, 3 * b + j) for b in range(3) for i, j in pairs]
    banks = [_accumulate_cross_spectra(
        x9[..., 2 * k * seg9:2 * (k + 1) * seg9], pairs9, seg9, 65536)
        for k in range(K)]
    cross9 = torch.stack([a[0] for a in banks])
    psd9 = torch.stack([a[1] for a in banks])
    coarse9, nseg9 = coarse.repeat(3), torch.full((K * n9,), 6.0, device=dev)
    w9_k = zoom_probe.loo_zoom_windows(cross9, psd9, pairs9, coarse9, nseg9)
    w9_p = zoom_probe.loo_zoom_windows_plain(cross9, psd9, pairs9, coarse9,
                                             nseg9)
    torch.cuda.synchronize()
    d9 = float((parabolic_peak(w9_k.abs())[0]
                - parabolic_peak(w9_p.abs())[0]).abs().max())
    a9, r9 = _errs(w9_k, w9_p)
    print(f"zoom_probe [K={K}, m=9, n_st=9, F=65536]: max |delay kernel - "
          f"plain| = {d9:.3e} samples (tol {K2_TOL:g}); window max |kernel "
          f"- plain| = {a9:.3e}, / row peak {r9:.3e}")
    if not d9 < K2_TOL:
        raise RuntimeError("zoom_probe disagrees with its plain version at "
                           "the segmented path's shape")
    k2_abs, k2_rel = max(k2_abs, a9), max(k2_rel, r9)
    k2_delay = max(k2_delay, d9)
    del x9, banks, cross9, psd9

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
    # Kernel 2: the cross and PSD banks read once, the windows written
    # once. Operations per (probe row, bin): 8 per lag of the 33-lag
    # zoom DFT, ~40 for the LOO weighting and the deramp.
    W = zoom_probe.W
    b2 = _bound(K * F * (8 * m + 4 * n_st) + K * m * W * 8,
                K * m * F * (8 * W + 40))
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
        k3,
        *streaming,
    ]


def _kernel3(dev, g):
    """Kernel 3 against its plain version at the FM path's shape: the 3
    blocks × 3 stations of a 30 s capture, 9 channels × 20 M samples of
    FM-like IQ with noise, D = 8; then both timed."""
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
    got = fm_demod.fm_demod_decimate(x, FS, decim=FM_DECIM)
    again = fm_demod.fm_demod_decimate(x, FS, decim=FM_DECIM)
    want = fm_demod.fm_demod_decimate_plain(x, FS, decim=FM_DECIM)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    same = _same(got, again)
    print(f"fm_demod [{C} ch x {n} samples, D={FM_DECIM}]: max |kernel - "
          f"plain| = {err:.3e} (tol {K3_TOL:g}); audio peak "
          f"{float(want.abs().max()):.3f}; two launches bitwise equal: "
          f"{same}")
    if not err < K3_TOL:
        raise RuntimeError("fm_demod disagrees with its plain version")
    if not same:
        raise RuntimeError("fm_demod is not deterministic")
    del got, want, again
    # Rows off the 16-byte grid (a view that starts one float in: the
    # kernel's scalar loads) and a second decimation, at a ragged length.
    n2 = 2_000_003
    for what, view, decim in (
            ("unaligned rows", x[:, 3:6, 1:1 + n2], FM_DECIM),
            ("aligned rows", x[:, 6:9, :n2], 16)):
        if fm_demod.rows_aligned(view) != (what == "aligned rows"):
            raise RuntimeError(f"fm_demod [{what}]: not the rows meant")
        got = fm_demod.fm_demod_decimate(view, FS, decim=decim)
        want = fm_demod.fm_demod_decimate_plain(view, FS, decim=decim)
        torch.cuda.synchronize()
        e2 = float((got - want).abs().max())
        print(f"fm_demod [3 ch x {n2} samples, {what}, D={decim}]: max "
              f"|kernel - plain| = {e2:.3e} (tol {K3_TOL:g})")
        if not e2 < K3_TOL:
            raise RuntimeError(f"fm_demod disagrees with its plain version "
                               f"({what})")
        err = max(err, e2)
        del got, want
    k3_call = lambda: fm_demod.fm_demod_decimate(x, FS, decim=FM_DECIM)  # noqa: E731
    k3_ms = _time_ms(k3_call, 20)
    k3_dev = _device_ms(k3_call, "fm_demod_kernel", 20)
    k3_plain = _time_ms(lambda: fm_demod.fm_demod_decimate_plain(
        x, FS, decim=FM_DECIM), 2)
    # IQ read once (8 bytes a sample), audio written once; operations:
    # the conjugate product and scale (7) and atan2 (~20) per sample, a
    # multiply-add per tap per output.
    n_out = n // FM_DECIM
    b3 = _bound(C * n * 8 + C * n_out * 4,
                C * n * 27 + C * n_out * 2 * fm_demod.NUM_TAPS)
    print(f"time fm_demod [{C} ch x {n}, D={FM_DECIM}]: kernel {k3_ms:.3f} "
          f"ms (device time {k3_dev:.3f} ms), plain {k3_plain:.3f} ms, "
          f"bound {b3['bound_ms']:.4f} ms "
          f"({b3['bound_by']}: {b3['bytes'] / 1e6:.1f} MB, "
          f"{b3['ops'] / 1e9:.2f} GFLOP)")
    del x
    return {"name": "fm_demod", "route": "cuda",
            "source": "tdoa_tpu_torch/csrc/fm_demod.cu",
            "replaces": "tdoa_tpu/ops/pallas/fm_demod.py:189",
            "max_abs_err": err, "ms": k3_ms, "device_ms": k3_dev,
            "plain_ms": k3_plain, "bitwise_deterministic": True,
            "bound_ms": b3["bound_ms"], "bound_by": b3["bound_by"],
            "library_ms": None, "redesigned": True}


def _synthesize(dev, out_dir: Path):
    """Write one u8 [REF | TGT | REF] .dat per station; return the
    truth: per-station TGT propagation delays (samples) and the TGT
    transmitter's lat/lon/elev."""
    import numpy as np
    import torch

    from tdoa_tpu_torch.geo import lla_to_ecef
    from tdoa_tpu_torch.io.stations import load_station_table
    from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT

    table = load_station_table(str(ROOT / "lat-lon-table.csv"),
                               reference_freq=162_400_000.0)
    # The table's KEVO row is the target transmitter; the other
    # callsign rows are the receivers.
    tgt_tx = table["KEVO"].lla()
    names = [n for n in table.names if n != "KEVO"]
    st = lla_to_ecef(table.lla_array(names))
    clock = np.asarray(CLOCK_OFFSETS_S) * FS

    def delays(tx_lla):
        d = np.linalg.norm(st - lla_to_ecef(tx_lla), axis=-1)
        return d / SPEED_OF_LIGHT * FS

    tau = {"ref": delays(table.reference_tx.lla()), "tgt": delays(tgt_tx)}
    pad = 4096
    n_fft = 1 << (BLOCK + 2 * pad).bit_length()  # > BLOCK + pad + delays
    g = torch.Generator(device=dev).manual_seed(SEED)
    f = torch.fft.fftfreq(n_fft, device=dev, dtype=torch.float64)
    raw = {n: [] for n in names}
    for kind in ("ref", "tgt", "ref"):
        # FM-like source: a 15 kHz low-passed message at 25 kHz rms
        # deviation, exp(i·phase) — one per block.
        msg = torch.fft.fft(torch.randn(n_fft, device=dev, generator=g,
                                        dtype=torch.float64))
        msg[f.abs() > 15e3 / FS] = 0
        msg = torch.fft.ifft(msg).real
        msg = msg / msg.std()
        phase = torch.cumsum(2 * np.pi * 25e3 / FS * msg, 0)
        spec = torch.fft.fft(torch.polar(torch.ones_like(phase), phase))
        del msg, phase
        for s, name in enumerate(names):
            d = tau[kind][s] + clock[s]  # fractional delay, samples
            z = torch.fft.ifft(spec * torch.polar(
                torch.ones_like(f), -2 * np.pi * f * d))[pad:pad + BLOCK]
            noise = torch.randn(2, BLOCK, device=dev, generator=g,
                                dtype=torch.float64)
            iq = torch.stack([0.3 * z.real + 0.1 * noise[0],
                              0.3 * z.imag + 0.1 * noise[1]], dim=-1)
            u8 = torch.clamp(torch.floor(iq * 127.5 + 128.0), 0, 255)
            raw[name].append(u8.to(torch.uint8).reshape(-1).cpu().numpy())
            del z, noise, iq, u8
        del spec
    paths = []
    for name in names:
        p = out_dir / f"sim-{name}-1700000000.dat"
        with open(p, "wb") as fh:
            for part in raw[name]:
                fh.write(part.tobytes())
        paths.append(str(p))
    return paths, dict(zip(names, tau["tgt"])), tgt_tx


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
    proc = TDOAProcessor.from_csv(162_400_000.0, 101_900_000.0,
                                  str(ROOT / "lat-lon-table.csv"),
                                  device=dev, **cfg)
    t0 = time.perf_counter()
    proc.process_files(paths)  # warm-up: cuFFT plans, allocator
    print(f"first run {time.perf_counter() - t0:.3f} s")
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    counters["corr_accum"].launch_shapes.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = proc.process_files(paths)  # results are host arrays: synced
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    shapes = dict(counters["corr_accum"].launch_shapes)
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
    return {"wall_s": wall, "launches": launches,
            "k1_shapes": {str(k): v for k, v in shapes.items()},
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
    proc = TDOAProcessor.from_csv(162_400_000.0, 101_900_000.0,
                                  str(ROOT / "lat-lon-table.csv"), device=dev)
    counters = _counters()
    _, spans = ingest.plan_chunks(BLOCK, SEG_LEN)
    n_chunks = len(spans)
    if {(rows, n // SEG_LEN, 1) for rows in (9, 3)
            for _, n in spans} != set(STREAM_SHAPES):
        raise RuntimeError(f"phase 3 checked kernel 1 at {STREAM_SHAPES}, "
                           f"the plan has chunks {spans}")

    def timed(fn):
        for c in counters.values():
            c.launches = 0
        counters["corr_accum"].launch_shapes.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(paths)  # results are host arrays: synced
        return res, time.perf_counter() - t0, {
            k: c.launches for k, c in counters.items()}

    t0 = time.perf_counter()
    proc.process_files_overlapped(paths)  # warm-up: pinned buffers, plans
    print(f"-- process_files_overlapped: first run "
          f"{time.perf_counter() - t0:.3f} s")
    res, wall, launches = timed(proc.process_files_overlapped)
    shapes = dict(counters["corr_accum"].launch_shapes)
    diag = dict(proc.ingest_diag)
    _, wall_batch, _ = timed(proc.process_files)
    print(f"timed run: process_files_overlapped {wall:.3f} s, process_files "
          f"{wall_batch:.3f} s right after it  [{_smi()}]")
    print(f"chunks {diag['n_chunks']} of {diag['chunk_segs']} segments; "
          f"gather {diag['gather_s'] * 1e3:.1f} ms on the host, copy stream "
          f"{diag['transfer_stream_s'] * 1e3:.1f} ms; kernel launches "
          f"{launches}, kernel 1 by (rows, segments, banks) {shapes}")
    out = {"overlapped": _check_overlap_result(
        "overlapped", res, tau_tgt, tgt_tx, fused_by_pair)}
    out["overlapped"].update(wall_s=wall, batch_wall_s=wall_batch,
                             launches=launches, diag=diag,
                             k1_shapes={str(k): v for k, v in shapes.items()})
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
    for c in counters.values():
        c.launches = 0
    counters["corr_accum"].launch_shapes.clear()
    res_t, sess, before, after_s = tail_run()
    launches_t = {k: c.launches for k, c in counters.items()}
    shapes_t = dict(counters["corr_accum"].launch_shapes)
    print(f"-- tail session: {before}/{sess.total_chunks} chunks dispatched "
          f"before the last tenth of the files; last byte → fix "
          f"{after_s:.3f} s; launches {launches_t}, kernel 1 by shape "
          f"{shapes_t}; copy stream "
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
    out["tail"].update(wall_s=after_s, launches=launches_t,
                       k1_shapes={str(k): v for k, v in shapes_t.items()},
                       chunks_before_close=before,
                       total_chunks=sess.total_chunks)
    print(json.dumps({"overlap": {
        "overlapped_s": wall, "batch_s": wall_batch,
        "copy_stream_s": diag["transfer_stream_s"],
        "gather_s": diag["gather_s"], "chunk_segs": diag["chunk_segs"],
        "n_chunks": diag["n_chunks"], "tail_last_byte_to_fix_s": after_s,
        "tail_chunks_before_close": before}}))
    return out


def phase_slice(dev):
    import torch

    print("== phase 4: the slice (3 stations, 30 s capture), three paths")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        paths, tau_tgt, tgt_tx = _synthesize(dev, tmp)
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
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
        print(json.dumps({"kernels": [_kernel3(
            dev, torch.Generator(device=dev).manual_seed(SEED))]}))
        return 0
    kernels = phase_kernels(dev)
    paths = phase_slice(dev)
    # Kernel 1 is held against its plain version shape by shape: a path
    # may launch it at no shape that phase 3 did not check, and each of
    # its entries counts the launches at its own shape.
    checked = {str(BATCH_SHAPE), *map(str, STREAM_SHAPES)}
    for p, r in paths.items():
        if set(r["k1_shapes"]) - checked:
            raise RuntimeError(f"{p}: kernel 1 launched at {r['k1_shapes']}, "
                               f"phase 3 checked {sorted(checked)}")
    for k in kernels:
        if "shape" in k:  # kernel 1 at one shape
            by_path = {p: r["k1_shapes"].get(str(tuple(k["shape"])), 0)
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
