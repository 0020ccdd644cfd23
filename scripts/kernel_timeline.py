#!/usr/bin/env python3
"""Per-phase timelines of the port's kernels on the card.

    python3 scripts/kernel_timeline.py [--kernels 1 2 3] [--stations 3 12]

A profiler sees each kernel's launches but not the phases inside them
(kernel 1, ``csrc/corr_accum.cu``, is two launches, the second
interleaving row fetches, transforms and sums; kernel 2,
``csrc/zoom_probe.cu``, is a cooperative launch with grid-wide barriers
between its phases; kernel 3, ``csrc/fm_demod.cu``, has a CTA-wide
barrier between its two). This script builds the kernels with
``-DTDOA_TIMELINE``, which compiles their ``%globaltimer`` stamps
(``TDOA_TL`` in the sources), and runs them through their wrappers at
the main path's shapes:

- kernel 1 (443 segments, K = 4, bf16, DC sums, all pairs of each
  ``--stations`` count, or where one launch does not hold them the
  first tile of ``plan_tiles``, launched alone): the spans of its two
  launches (first CTA's start to last CTA's end) and, for stage 2's CTA
  0, the time it spends fetching and transforming rows, accumulating
  and storing items, over its rounds;
- kernel 2 (K = 4, m = 3, F = 65536): its three phases and two barriers
  as CTA 0 sees them;
- kernel 3 (9 channels × 20 M samples, D = 8): over all CTAs of a
  launch, the mean time a CTA spends in its load+discriminate phase and
  in its FIR phase (other CTAs share its SM meanwhile), the launch's
  span from the first CTA's start to the last one's end, and the mean
  number of CTAs in flight per SM.

Needs one CUDA card; imports nothing of JAX. The instrumented build
lives beside the plain one under ``build/`` (its own source hash).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TL_S = 8  # kernel 1's stamps (csrc/corr_accum.cu)
PAIRS = ((0, 1), (0, 2), (1, 2))


def _us(ns) -> float:
    return float(ns) / 1e3


def _kernel3(lib, dev, g) -> None:
    import torch

    from tdoa_tpu_torch.ops.kernels import fm_demod

    lib.tdoa_fm_demod_timeline.argtypes = [ctypes.c_void_p]
    C, n, decim, fs = 9, 20_000_000, 8, 2e6
    phase = torch.cumsum(0.3 * torch.randn(C, n, device=dev, generator=g), 1)
    x = torch.stack([0.3 * torch.cos(phase), 0.3 * torch.sin(phase)])
    del phase
    x += 0.1 * torch.randn(2, C, n, device=dev, generator=g)
    for _ in range(3):
        fm_demod.fm_demod_decimate(x, fs, decim=decim)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 5)()
    if lib.tdoa_fm_demod_timeline(ctypes.addressof(buf)) != 0:
        raise RuntimeError("could not read kernel 3's stamps")
    load, fir, ctas, start, end = (int(v) for v in buf)
    span = end - start
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"fm_demod [{C} ch x {n} samples, D={decim}] {ctas} CTAs: mean a "
          f"CTA: load+discriminate {_us(load / ctas):.2f} us, FIR "
          f"{_us(fir / ctas):.2f} us (FIR / load {fir / load:.2f}); launch "
          f"span {_us(span):.1f} us; mean CTAs in flight per SM "
          f"{(load + fir) / span / sms:.2f}")


def _kernel1(lib, dev, g, n_st: int = 3) -> None:
    import torch

    from tdoa_tpu_torch.ops.kernels import corr_accum
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN

    lib.tdoa_corr_accum_timeline.argtypes = [ctypes.c_void_p]
    x = (0.3 * torch.randn(2, n_st, 443 * SEG_LEN, device=dev, generator=g)
         + 0.01).to(torch.bfloat16)
    pairs = [(i, j) for i in range(n_st) for j in range(i + 1, n_st)]
    tiles = corr_accum.plan_tiles(pairs, n_st, True,
                                  corr_accum.smem_optin(dev))
    r0, r1, lo, hi = tiles[0]
    x = x[:, r0:r1]
    pairs = [(i - r0, j - r0) for i, j in pairs[lo:hi]]
    cfg = corr_accum.kernel_config(r1 - r0, pairs, True)
    buf = (ctypes.c_ulonglong * TL_S)()
    for _ in range(2):
        corr_accum.accumulate_banks(x, pairs, 4, True)
        torch.cuda.synchronize()
        # Each read resets the stamps: the second run's remain.
        if lib.tdoa_corr_accum_timeline(ctypes.addressof(buf)) != 0:
            raise RuntimeError("could not read kernel 1's stamps")
    s = np.array(buf, np.int64)
    rounds = max(int(s[7]), 1)
    print(f"corr_accum [{n_st} st, 443 seg, K=4; tile 1 of {len(tiles)}: "
          f"{r1 - r0} rows x {len(pairs)} pairs, stage-1 grid "
          f"{cfg['stage1_grid']}, stage-2 grid {cfg['grid']}]: stage 1 "
          f"span {_us(s[1] - s[0]):.1f} us, stage 2 span "
          f"{_us(s[3] - s[2]):.1f} us, gap {_us(s[2] - s[1]):.1f} us; "
          f"stage-2 CTA 0 over {int(s[7])} rounds: fetch+transform "
          f"{_us(s[4]):.1f} us ({_us(s[4] / rounds):.2f} a round), "
          f"accumulate {_us(s[5]):.1f} us ({_us(s[5] / rounds):.2f} a "
          f"round), store {_us(s[6]):.1f} us")


def _kernel2(lib, dev, g) -> None:
    import torch

    from tdoa_tpu_torch.ops.kernels import zoom_probe

    lib.tdoa_zoom_probe_timeline.argtypes = [ctypes.c_void_p]
    K, m, F = 4, 3, 65536
    cross = torch.randn(K, m, F, dtype=torch.complex64, device=dev,
                        generator=g)
    psd = torch.rand(K, 3, F, device=dev, generator=g) + 0.5
    coarse = torch.tensor([37.0, -12.0, -49.0], device=dev)
    nseg = torch.full((K * m,), 332.0, device=dev)
    for _ in range(3):
        zoom_probe.loo_zoom_windows(cross, psd, PAIRS, coarse, nseg)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 6)()
    if lib.tdoa_zoom_probe_timeline(ctypes.addressof(buf)) != 0:
        raise RuntimeError("could not read kernel 2's stamps")
    t = np.array(buf, np.int64)
    names = ("phase 0", "barrier 1", "phase 1", "barrier 2", "phase 2")
    spans = {n: _us(t[i + 1] - t[i]) for i, n in enumerate(names)}
    spans["kernel"] = _us(t[5] - t[0])
    print(f"zoom_probe [K={K}, m={m}, F={F}] CTA 0: " + ", ".join(
        f"{k} {v:.2f} us" for k, v in spans.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", type=int, nargs="+", default=[1, 2, 3],
                    choices=[1, 2, 3], help="which kernels to run")
    ap.add_argument("--stations", type=int, nargs="+", default=[3],
                    help="kernel 1's station counts")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the timelines need the card", file=sys.stderr)
        return 2
    from tdoa_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}  torch {torch.__version__}")
    lib = _build.load(("TDOA_TIMELINE",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    sections = {2: _kernel2, 3: _kernel3}
    for k in sorted(set(args.kernels)):
        if k == 1:
            for n_st in args.stations:
                _kernel1(lib, dev, g, n_st)
        else:
            sections[k](lib, dev, g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
