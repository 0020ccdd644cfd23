"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python3 portbench/control.py --workload <cell> --seeds <n> <n> ...
        [--control-seeds N] [--out FILE]

For each seed it makes the cell's scenes, runs the timed path's entry
once on each (after one warm-up window), and prints one JSON line per
seed with the numbers ``harness.judge`` compares, one for each of the
cell's limit keys (``checks/<key>.py``): ``program`` (the program
against the float64 reference: the lower reading) and ``control`` (the
traffic's reference estimator computed in bfloat16, put in the
program's place: the upper reading). The benchmark's own runs do not
run this."""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness, spec  # noqa: E402


def readings(answers, refs, cfg, keys) -> dict:
    worst = {}
    for s, ans in answers:
        for k, v in harness.gaps(ans, refs[s], cfg, keys).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first N seeds only")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    trf = spec.traffic(cell["traffic"])
    keys = list(spec.limits(cell["name"])["limits"])
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 2
    harness._keep_caches_in(spec.ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    proc = None
    for n, seed in enumerate(args.seeds):
        with_control = args.control_seeds is None or n < args.control_seeds
        tmp = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            t0 = time.perf_counter()
            scenes = harness.make_scenes(cfg, trf, seed, tmp, device)
            gc.collect()
            torch.cuda.empty_cache()
            if proc is None:
                proc = harness.build_processor(cfg, trf, device, tmp)
                getattr(proc, trf["entry"])(scenes[0])
            entry = getattr(proc, trf["entry"])
            answers = [(s, harness.program_answer(entry(p), keys))
                       for s, p in enumerate(scenes)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            refs = harness.reference_answers(cfg, trf, scenes, device)
            t2 = time.perf_counter()
            line = {"workload": cell["name"], "seed": seed,
                    "program": readings(answers, refs, cfg, keys)}
            if with_control:
                ctl = harness.reference_answers(cfg, trf, scenes, device,
                                                "bf16")
                line["control"] = readings(list(enumerate(ctl)), refs, cfg,
                                           keys)
            line.update({
                "truth_error": max(harness.truth_error(a, cfg)
                                   for _, a in answers),
                "reference_s": t2 - t1, "scenes_and_program_s": t1 - t0})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
