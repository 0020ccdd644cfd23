#!/usr/bin/env python3
"""Kernel 1 of two checkouts on the card, in turns: bitwise and times.

    python3 scripts/corr_accum_ab.py [--other DIR] [--iters 3]
        [--shapes NAME ...] [--out build/corr_accum_ab.jsonl]

Runs kernel 1 (``ops.kernels.corr_accum.accumulate_banks``) at the
launch shapes of the port's paths in this checkout and, with
``--other``, in another one (a ``git archive`` of an earlier commit,
unpacked into a git-ignored directory such as ``build/``), each run in
its own process that builds its own tree's kernels; the order is other,
this, this, other. Every process draws the same inputs (a seeded
``torch.Generator`` on the card, bf16 or f32 planar blocks whose rows
carry delayed copies of the first), hashes every output (SHA-256 of the
bytes), times the call (CUDA events around ``--iters`` calls after a
warm-up) and reports the launch its tree's ``kernel_config`` gives;
each line also carries the shape's bound (``chip_smoke._k1_bound``).

Prints the card's name and power limit, one JSON line a shape and run
(also written to ``--out``), then for every shape whether its outputs
are bitwise equal across all runs and trees; exits 1 where they are
not. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 20261017
# name: (rows, segments, banks, rows a block (0: all pairs), f32, sums).
# The batch path's 10 s block (443 segments, K = 4, bf16, DC sums) at 3,
# 5, 8, 12, 16 (2 tiles) and 24 stations (6 tiles), and its 100 s block
# (1479 segments) at 3; the overlapped ingest's stacked rows (K = 1, a
# default chunk of 96 segments, a 10 s block's last of 59 and a 100 s
# block's last of 39) at 3 and 12 stations; a tail session's 3 rows at
# 96 and 59; the 12-station sharded step's f32 rows without DC sums (a
# rank's 220 segments at K = 1, the comparator's 440 at K = 4).
SHAPES = {
    "3st-443-K4": (3, 443, 4, 0, False, True),
    "3st-1479-K4": (3, 1479, 4, 0, False, True),
    "9x3-96-K1": (9, 96, 1, 3, False, True),
    "9x3-59-K1": (9, 59, 1, 3, False, True),
    "9x3-39-K1": (9, 39, 1, 3, False, True),
    "3st-96-K1": (3, 96, 1, 0, False, True),
    "3st-59-K1": (3, 59, 1, 0, False, True),
    "5st-443-K4": (5, 443, 4, 0, False, True),
    "8st-443-K4": (8, 443, 4, 0, False, True),
    "12st-443-K4": (12, 443, 4, 0, False, True),
    "16st-443-K4": (16, 443, 4, 0, False, True),
    "24st-443-K4": (24, 443, 4, 0, False, True),
    "36x12-96-K1": (36, 96, 1, 12, False, True),
    "36x12-59-K1": (36, 59, 1, 12, False, True),
    "36x12-220-K1-f32": (36, 220, 1, 12, True, False),
    "36x12-440-K4-f32": (36, 440, 4, 12, True, False),
}


def _pairs(rows: int, block: int) -> list:
    block = block or rows
    return [(b + i, b + j) for b in range(0, rows, block)
            for i in range(block) for j in range(i + 1, block)]


def _digest(outs) -> str:
    h = hashlib.sha256()
    for t in outs:
        if t is not None:
            h.update(t.contiguous().view(-1).cpu().numpy().tobytes())
    return h.hexdigest()


def worker(tree: Path, names: list, iters: int) -> None:
    """One run in ``tree``: a JSON line a shape on stdout."""
    sys.path.insert(0, str(tree))
    import torch

    from tdoa_tpu_torch.ops.kernels import corr_accum
    from tdoa_tpu_torch.ops.kernels.corr_accum import SEG_LEN

    dev = torch.device("cuda")
    for name in names:
        rows, n_seg, kb, block, f32, sums = SHAPES[name]
        g = torch.Generator(device=dev).manual_seed(
            SEED + list(SHAPES).index(name))
        x = torch.randn(2, rows, n_seg * SEG_LEN, device=dev, generator=g)
        for s in range(1, rows):
            x[:, s] += 0.5 * torch.roll(x[:, 0], 11 * s - 70, dims=-1)
        x = (0.3 * x + 0.01).to(torch.float32 if f32 else torch.bfloat16)
        x = x.contiguous()
        pn = _pairs(rows, block)
        # A tree from before the launch shape stopped depending on the
        # banks takes them.
        banks = ([kb] if "n_banks" in inspect.signature(
            corr_accum.kernel_config).parameters else [])
        cfg = corr_accum.kernel_config(rows, pn, sums, *banks, not f32)

        def call():
            return corr_accum.accumulate_banks(x, pn, kb, sums)

        digest = _digest(call())
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            call()
        t1.record()
        torch.cuda.synchronize()
        print(json.dumps({"shape": name, "sha256": digest,
                          "ms": t0.elapsed_time(t1) / iters,
                          "launch": cfg}), flush=True)
        del x
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout, run in turns with this one")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--shapes", nargs="+", default=list(SHAPES),
                    choices=list(SHAPES))
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "corr_accum_ab.jsonl")
    ap.add_argument("--worker", type=Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.shapes, args.iters)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the comparison needs the card",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}  torch {torch.__version__}", flush=True)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _k1_bound

    trees = [("this", ROOT)]
    if args.other is not None:
        other = ("other", args.other.resolve())
        trees = [other, trees[0], trees[0], other]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    digests = {}
    with args.out.open("w") as f:
        for turn, (label, tree) in enumerate(trees):
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", str(tree),
                 "--iters", str(args.iters), "--shapes", *args.shapes],
                capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            for line in proc.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                rec = {"tree": label, "turn": turn, **json.loads(line)}
                rows, n_seg, kb, block, f32, sums = SHAPES[rec["shape"]]
                b = _k1_bound(rows, len(_pairs(rows, block)), n_seg, kb,
                              4 if f32 else 2, sums)
                rec.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"])
                digests.setdefault(rec["shape"], set()).add(rec["sha256"])
                print(json.dumps(rec), flush=True)
                f.write(json.dumps(rec) + "\n")
    same = {name: len(d) == 1 for name, d in digests.items()}
    print(json.dumps({"bitwise_equal_across_runs_and_trees": same}))
    print(smi)
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
