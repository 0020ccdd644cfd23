"""Station-count sweep of the port's batch correlator on the card.

The port's counterpart of ``scripts/station_sweep.py`` (which drives the
JAX package on a TPU). For each station count: three blocks of a third
of ``--seconds`` each (443 kernel segments of 2 Msps samples in a 30 s
window, 1479 in the collector's longest, 100 s) as bf16 planar tensors
on the card, drawn from a seeded ``torch.Generator`` — a common wideband source
delayed by a whole number of samples per station (REF and TGT delays
apart), plus independent noise — through
``pipeline.processor.process_blocks(..., max_lag=20000,
weighting="ht", accumulator="pallas")``, the kernel route (kernel 1
pair-tiled where one launch does not hold the pairs, kernel 2 for the
split σ). Beside it, the same blocks through the segmented route
(``accumulator="xla"`` at the processor's 2^16-sample segment).

Each station count prints one JSON line: steady latency (median of 5
runs, each ended by a device sync), sustained latency (5 runs queued,
one sync, per run), kernel 1's tiles, launches and device time
per run, kernel 2's device time per run (``torch.profiler``), the
segmented route's steady latency, each route's peak device memory of a
run (the blocks included) and largest corrected-TDOA error against the
planted delays. A route whose run the card cannot hold in its memory is
reported as refused, with the allocator's message, in place of its
numbers (``kernel_refused``, ``segmented_refused``); the sweep goes on,
and no route stands in for another. The card's name and power limit
(``nvidia-smi``) come first. The TPU sweep's dispatch floor, MFU and
FLOP-model fields have no counterpart here.

    python3 scripts/station_sweep_torch.py [--stations 3 5 8 12 16 24]
        [--seconds 30] [--seed 7] [--out stations.jsonl]

Needs the card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tdoa_tpu_torch.ops.kernels import corr_accum  # noqa: E402
from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN  # noqa: E402
from tdoa_tpu_torch.pipeline.processor import (  # noqa: E402
    ProcessorConfig,
    process_blocks,
)
from tdoa_tpu_torch.solve import station_pairs  # noqa: E402

FS = 2e6
MAX_LAG = 20000


def make_blocks(n_st: int, seconds: float, seed: int, device):
    """(ref1, tgt, ref2, pairs, truth): three bf16 planar [2, n_st, L]
    blocks of ``seconds / 3`` each, L cut to whole kernel segments; a
    unit-power complex source common to every station, each station's
    copy delayed by an integer (REF blocks and the TGT block apart) at
    amplitude 0.5, plus unit-variance noise; ``truth`` the corrected
    TDOA of every pair in samples (the TGT delay difference less the REF
    one)."""
    L = int(seconds * FS / 3) // SEG_LEN * SEG_LEN
    g = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    d_ref = rng.integers(-300, 301, n_st)
    d_tgt = rng.integers(-300, 301, n_st)
    pairs = station_pairs(n_st)
    blocks = []
    for d in (d_ref, d_tgt, d_ref):
        src = torch.randn(2, L, device=device, generator=g)
        x = torch.empty(2, n_st, L, dtype=torch.bfloat16, device=device)
        for s in range(n_st):
            noise = torch.randn(2, L, device=device, generator=g)
            x[:, s] = 0.5 * torch.roll(src, int(d[s]), dims=-1) + noise
        blocks.append(x)
        del src, noise
    truth = (d_tgt - d_ref)[pairs[:, 1]] - (d_tgt - d_ref)[pairs[:, 0]]
    return (*blocks, pairs, truth.astype(np.float64))


def run(blocks, accumulator: str = "pallas"):
    """One ``process_blocks`` call on ``make_blocks``' blocks (not
    synced): the corrected TDOAs first. The segmented route takes the
    processor's segment (``ProcessorConfig.seg_len``), as
    ``TDOAProcessor`` passes it."""
    ref1, tgt, ref2, pairs = blocks[:4]
    geo = torch.zeros(len(pairs), device=ref1.device)
    return process_blocks(ref1, tgt, ref2, pairs, geo, max_lag=MAX_LAG,
                          seg_len=ProcessorConfig.seg_len, weighting="ht",
                          accumulator=accumulator)


def tdoa_error(out, truth) -> float:
    """Largest |corrected TDOA − planted| over the pairs, samples."""
    return float(np.abs(out[0].cpu().numpy() - truth).max())


def _steady(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _device_ms(fn) -> dict:
    """Device time of one call by kernel: kernel 1 and kernel 2, ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"corr_accum": 0.0, "zoom_probe": 0.0}
    for e in prof.key_averages():
        for k in out:
            if f"{k}_kernel" in e.key:
                out[k] += e.device_time_total / 1e3
    return out


def _refused(route, *args) -> dict:
    """``route(*args)``'s fields, or ``{"refused": ...}`` with the
    allocator's message where the card cannot hold the route's run."""
    try:
        return route(*args)
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e).splitlines()[0]
    torch.cuda.empty_cache()
    return {"refused": f"out of memory: {msg}"}


def _kernel_route(blocks, device) -> dict:
    """The kernel route's fields of one station count's JSON line."""
    pairs, truth = blocks[3], blocks[4]
    n_st = int(blocks[0].shape[1])
    tiles = corr_accum.plan_tiles(pairs, n_st, True,
                                  corr_accum.smem_optin(device))
    err = tdoa_error(run(blocks), truth)  # warm-up: plans, allocator
    before = corr_accum.accumulate_banks.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    run(blocks)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    launches = corr_accum.accumulate_banks.launches - before
    steady = _steady(lambda: run(blocks))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [run(blocks) for _ in range(5)]
    torch.cuda.synchronize()
    sustained = (time.perf_counter() - t0) / 5
    del outs
    dev = _device_ms(lambda: run(blocks))
    return {
        "k1_tiles": len(tiles), "k1_tile_pairs": [hi - lo for *_, lo, hi
                                                  in tiles],
        "k1_launches_per_run": launches,
        "steady_latency_s": steady, "sustained_latency_s": sustained,
        "k1_device_ms_per_run": dev["corr_accum"],
        "k2_device_ms_per_run": dev["zoom_probe"],
        "peak_memory_bytes": peak, "tdoa_err_samples": err,
    }


def _segmented_route(blocks, device) -> dict:
    """The segmented route's fields of one station count's JSON line."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    err = tdoa_error(run(blocks, "xla"), blocks[4])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    return {"segmented_steady_latency_s": _steady(lambda: run(blocks, "xla")),
            "segmented_peak_memory_bytes": peak,
            "segmented_tdoa_err_samples": err}


def sweep_one(n_st: int, seconds: float, seed: int, device) -> dict:
    """The JSON line of one station count."""
    blocks = make_blocks(n_st, seconds, seed + n_st, device)
    pairs = blocks[3]
    n_seg = int(blocks[0].shape[-1]) // SEG_LEN
    line = {"stations": n_st, "pairs": len(pairs),
            "capture_seconds": seconds, "segments_per_block": n_seg,
            "blocks_bytes": 3 * blocks[0].numel() * blocks[0].element_size(),
            "card_bytes": torch.cuda.mem_get_info(device)[1]}
    for name, route in (("kernel", _kernel_route),
                        ("segmented", _segmented_route)):
        fields = _refused(route, blocks, device)
        if "refused" in fields:
            fields = {f"{name}_refused": fields["refused"]}
        line.update(fields)
    line["k2_shape"] = [4, len(pairs), corr_accum.FFT_LEN]
    return line


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stations", type=int, nargs="+",
                    default=[3, 5, 8, 12, 16, 24])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("station_sweep_torch.py needs the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"nvidia-smi: {smi()}", flush=True)
    lines = []
    for n_st in args.stations:
        line = sweep_one(n_st, args.seconds, args.seed, dev)
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(v) + "\n" for v in lines)
    return 0


if __name__ == "__main__":
    sys.exit(main())
