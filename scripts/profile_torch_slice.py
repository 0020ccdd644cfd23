#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's 3-station slice.

    python3 scripts/profile_torch_slice.py [--runs 12] [--mode iq|fm]
        [--accumulator auto|xla] [--seconds 30|100] [--out FILE]
    python3 scripts/profile_torch_slice.py --overlap
        [--chunk-segs 12 24 48 96 192]

Needs one CUDA card (sm_90a) and imports nothing of JAX. It synthesizes
the capture ``chip_smoke.py`` runs (three blocks per station of a third
of ``--seconds`` each: 20 M samples in the default 30 s window,
66,666,666 in the collector's longest, 100 s; ``lat-lon-table.csv``
geometry), then on a warm process
of the chosen path (``--mode fm``: FM demod by kernel 3 and the
segmented correlator on the audio; ``--accumulator xla``: the segmented
IQ correlator; the defaults: the fused IQ kernels):

1. times ``--runs`` runs of ``TDOAProcessor.process_files``, split into
   ``load_files`` (read + copy + decode) and ``process_captures``
   (correlate + solve), each span ended by a device sync; prints the
   median, quartiles and max of each;
2. splits ingest per file into the read (``np.fromfile``), the pageable
   host→card copy and the decode on the card;
3. traces one ``process_captures`` with ``torch.profiler`` and prints
   its wall time, the card's busy time (sum of the device kernels' and
   copies' own time) and the device ops that take the most of it.

``--overlap`` measures the overlapped ingest instead (fused IQ only):
capture→fix of ``process_files_overlapped`` and of ``process_files`` in
turns within the one process (``--runs`` pairs), with the host's gather
time and the copy stream's time (CUDA events) of every overlapped run;
with ``--chunk-segs`` the overlapped path at each chunk size, the sizes
taken in turns (overlapped runs back to back, each with its gather
time); and one traced ``process_files_overlapped``.

Everything printed also goes into the JSON file given by ``--out``; the
default name of an ``--overlap`` report carries the time and the process
id, so that a later call does not overwrite an earlier one's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _quantiles(xs) -> dict:
    q = np.quantile(np.asarray(xs, np.float64), [0.25, 0.5, 0.75])
    return {"q25": q[0], "median": q[1], "q75": q[2], "max": max(xs),
            "runs": list(xs)}


def _device_time(evt) -> float:
    """Device time of a profiler event that ran on the card (a kernel
    or a copy), µs; 0 for host ops, whose device time is their
    kernels' and would count twice. The attribute's name changed
    across torch releases."""
    if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
        return 0.0
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _trace(fn) -> dict:
    """Wall time, the card's busy time and the top device ops of one
    traced call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [(e.key, _device_time(e) / 1e3, e.count)
           for e in prof.key_averages()]
    ops = sorted((o for o in ops if o[1] > 0), key=lambda o: -o[1])
    busy = sum(o[1] for o in ops)
    print(f"traced: wall {wall:.2f} ms, card busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %)")
    if not ops:
        print("  the trace holds no device time: the profiler did not "
              "see the card")
    for k, t, c in ops[:15]:
        print(f"  {t:8.3f} ms  x{c:<5d} {k[:90]}")
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_busy_share": busy / wall,
            "top_device_ops": [{"op": k, "ms": t, "count": c}
                               for k, t, c in ops[:15]]}


def _timed_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # the result is host arrays: the card has finished
    return (time.perf_counter() - t0) * 1e3


def _overlap(proc, paths, runs: int, chunk_segs) -> dict:
    """The overlapped ingest beside the batch path, in turns."""
    from tdoa_tpu_torch.pipeline import ingest

    report = {}
    proc.process_files_overlapped(paths)  # warm-up: pinned buffers, plans
    over, batch, gather, copy = [], [], [], []
    for _ in range(runs):
        over.append(_timed_ms(lambda: proc.process_files_overlapped(paths)))
        gather.append(proc.ingest_diag["gather_s"] * 1e3)
        copy.append(proc.ingest_diag["transfer_stream_s"] * 1e3)
        batch.append(_timed_ms(lambda: proc.process_files(paths)))
    report["capture_to_fix_ms"] = {
        "process_files_overlapped": _quantiles(over),
        "process_files": _quantiles(batch),
        "overlapped_gather": _quantiles(gather),
        "overlapped_copy_stream": _quantiles(copy),
        "chunk_segs": proc.ingest_diag["chunk_segs"],
        "n_chunks": proc.ingest_diag["n_chunks"]}
    for name in ("process_files_overlapped", "process_files",
                 "overlapped_gather", "overlapped_copy_stream"):
        q = report["capture_to_fix_ms"][name]
        print(f"{name:26s} median {q['median']:.3f} ms  q25 {q['q25']:.3f}"
              f"  q75 {q['q75']:.3f}  max {q['max']:.3f}  ({runs} runs)")
    if chunk_segs:
        default = ingest.DEFAULT_CHUNK_SEGS
        times = {n: [] for n in chunk_segs}
        gathers = {n: [] for n in chunk_segs}
        try:
            for n in chunk_segs:  # warm-up: buffers and plans of each size
                ingest.DEFAULT_CHUNK_SEGS = n
                proc.process_files_overlapped(paths)
            for _ in range(runs):
                for n in chunk_segs:
                    ingest.DEFAULT_CHUNK_SEGS = n
                    times[n].append(_timed_ms(
                        lambda: proc.process_files_overlapped(paths)))
                    gathers[n].append(proc.ingest_diag["gather_s"] * 1e3)
        finally:
            ingest.DEFAULT_CHUNK_SEGS = default
        report["chunk_size_sweep_ms"] = {
            str(n): _quantiles(t) for n, t in times.items()}
        report["chunk_size_sweep_gather_ms"] = {
            str(n): _quantiles(t) for n, t in gathers.items()}
        for n, t in times.items():
            q, g = _quantiles(t), _quantiles(gathers[n])
            print(f"chunk of {n:3d} segments: median {q['median']:.3f} ms  "
                  f"q25 {q['q25']:.3f}  q75 {q['q75']:.3f}  max "
                  f"{q['max']:.3f}; gather median {g['median']:.3f}  q25 "
                  f"{g['q25']:.3f}  q75 {g['q75']:.3f}  ({runs} runs, sizes "
                  f"in turns)")
    print("one traced process_files_overlapped:")
    report["trace"] = _trace(lambda: proc.process_files_overlapped(paths))
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--mode", default="iq", choices=["iq", "fm"])
    ap.add_argument("--accumulator", default="auto",
                    choices=["auto", "xla", "pallas"])
    ap.add_argument("--overlap", action="store_true",
                    help="measure process_files_overlapped beside "
                         "process_files (fused IQ)")
    ap.add_argument("--seconds", type=int, default=30, choices=[30, 100],
                    help="the capture window: the collector's default or "
                         "its longest")
    ap.add_argument("--chunk-segs", type=int, nargs="*", default=[],
                    help="with --overlap: chunk sizes (segments) to sweep")
    ap.add_argument("--out", default=None,
                    help="JSON report (default: chiprun_out/"
                         "profile_torch_slice[_<mode>_<accumulator>].json; "
                         "with --overlap chiprun_out/profile_torch_slice_"
                         "overlap_<time>_<pid>.json)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs the card", file=sys.stderr)
        return 2
    import chip_smoke
    from tdoa_tpu_torch.io.datfile import bytes_to_iq_planar
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": chip_smoke._smi(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "mode": args.mode,
              "accumulator": args.accumulator, "seconds": args.seconds}
    print(f"nvidia-smi: {report['device']}  torch {report['torch']}")
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="profile_slice_", dir=ROOT / "build"))
    try:
        paths, _ = chip_smoke._synthesize(
            dev, tmp, block=args.seconds * int(chip_smoke.FS) // 3)
        torch.cuda.synchronize()
        proc = TDOAProcessor.from_csv(162_400_000.0, 101_900_000.0,
                                      str(ROOT / "lat-lon-table.csv"),
                                      device=dev, mode=args.mode,
                                      accumulator=args.accumulator)
        proc.process_files(paths)  # warm-up: build, cuFFT plans, allocator
        if args.overlap:
            if (args.mode, args.accumulator) != ("iq", "auto"):
                raise SystemExit("--overlap measures the fused IQ path")
            report["overlap"] = _overlap(proc, paths, args.runs,
                                         args.chunk_segs)
            out = Path(args.out or ROOT / "chiprun_out" / (
                "profile_torch_slice_overlap_"
                f"{time.strftime('%Y%m%dT%H%M%S')}_{os.getpid()}.json"))
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1, default=float))
            print(f"wrote {out}")
            return 0
        # The decode dtype load_files picks for this path (bf16 for the
        # fused kernels, f32 for the segmented correlator).
        dtype = next(iter(proc.load_files(paths).values()))[0].dtype

        # 1. Spans of process_files.
        load, corr, total = [], [], []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            caps = proc.load_files(paths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            proc.process_captures(caps)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            load.append((t1 - t0) * 1e3)
            corr.append((t2 - t1) * 1e3)
            total.append((t2 - t0) * 1e3)
            del caps
        report["spans_ms"] = {"load_files": _quantiles(load),
                              "process_captures": _quantiles(corr),
                              "process_files": _quantiles(total)}
        for name, q in report["spans_ms"].items():
            print(f"{name:17s} median {q['median']:.1f} ms  q25 "
                  f"{q['q25']:.1f}  q75 {q['q75']:.1f}  max {q['max']:.1f}"
                  f"  ({args.runs} runs)")

        # 2. Ingest per file.
        ingest = []
        for p in paths:
            t0 = time.perf_counter()
            raw = np.fromfile(p, dtype=np.uint8)
            t1 = time.perf_counter()
            d = torch.from_numpy(raw).to(dev)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            bytes_to_iq_planar(d, dtype)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ingest.append({"bytes": int(raw.size), "read_ms": (t1 - t0) * 1e3,
                           "copy_ms": (t2 - t1) * 1e3,
                           "decode_ms": (t3 - t2) * 1e3})
            print(f"ingest {Path(p).name}: {raw.size / 1e6:.1f} MB, read "
                  f"{ingest[-1]['read_ms']:.2f} ms, copy "
                  f"{ingest[-1]['copy_ms']:.2f} ms, decode "
                  f"{ingest[-1]['decode_ms']:.2f} ms")
            del raw, d
        report["ingest"] = ingest

        # 3. One traced process_captures.
        caps = proc.load_files(paths)
        torch.cuda.synchronize()
        print("one traced process_captures:")
        report["trace"] = _trace(lambda: proc.process_captures(caps))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    suffix = ("" if (args.mode, args.accumulator) == ("iq", "auto")
              else f"_{args.mode}_{args.accumulator}")
    suffix += "" if args.seconds == 30 else f"_{args.seconds}s"
    out = Path(args.out or ROOT / "chiprun_out"
               / f"profile_torch_slice{suffix}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1, default=float))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
