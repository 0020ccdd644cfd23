"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result's line.

A run, in order: the card (or an exit without a result); the kernels
from the port's build cache under ``build/`` in the checkout; the cell's
scenes made on the card from ``--seed`` and written as ``.dat`` files
under ``TMPDIR``; one ``TDOAProcessor``, as a service holds one; one
warm-up window per scene; then a closed loop with one caller for
``--seconds``: each window calls the traffic's entry on the next scene's
files as soon as the previous fix is back. A window's latency is the
host clock from the call to the returned result, the card synchronised.
With ``--trace 1`` the loop runs under ``torch.profiler`` with the
run's ``SpanTimer`` as the processor's timer, and the per-layer readers
take their numbers from that window. After the window the program's
state is freed and the reference answers each scene once; every window's
answer is held to its scene's (``judge``), one number for each of the
cell's limits.

The configuration's scene (``scenes/<name>.py``), the traffic's
reference estimator (``estimators/<name>.py``) and each number compared
(``checks/<name>.py``) are files found by name (``spec``); every function
here that uses one takes the ``root`` of the checkout it is found in."""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import reference, scene, spec, tracing

BANNED = ("jax", "jaxlib", "flax", "tdoa_tpu")
# The numbers that every cell compares, on its TDOAs and its fix; a
# cell's limits may add others.
REQUIRED_CHECKS = ("tdoa_gap", "fix_gap_m")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    latencies: List[float]
    window_s: float
    # Traced runs only: per window the stages' seconds and the overlapped
    # ingest's counters; the kernels' launches by shape over the window;
    # the trace of the window.
    windows: List[dict] = dataclasses.field(default_factory=list)
    launches: Dict[str, collections.Counter] = dataclasses.field(
        default_factory=dict)
    trace: Optional[tracing.TraceSummary] = None


def _counters() -> dict:
    """The port's launch counters, by kernel."""
    from tdoa_tpu_torch.ops.kernels import corr_accum, fm_demod, zoom_probe

    return {"corr_accum": corr_accum.accumulate_banks,
            "zoom_probe": zoom_probe.loo_zoom_windows,
            "fm_demod": fm_demod.fm_demod_decimate}


def write_stations(cfg: dict, path: str) -> str:
    with open(path, "w") as f:
        f.write("Name,Latitude,Longitude,Elevation\n")
        for name, lat, lon, elev in cfg["stations"]:
            f.write(f"{name},{lat!r},{lon!r},{elev!r}\n")
    return path


def build_processor(cfg: dict, trf: dict, device, tmp: str):
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    settings = {**cfg["processor"], **trf.get("processor", {})}
    return TDOAProcessor.from_csv(
        float(cfg["ref_freq"]), float(cfg["tgt_freq"]),
        write_stations(cfg, os.path.join(tmp, "stations.csv")),
        device=device, **settings)


def make_scenes(cfg: dict, trf: dict, seed: int, tmp: str, device,
                root: Path = spec.ROOT) -> List[List[str]]:
    gen = spec.scene(cfg, root)
    return [gen.write_scene(cfg, scene.scene_seed(seed, k),
                            os.path.join(tmp, f"scene{k}"), device)
            for k in range(int(trf["scenes"]))]


def program_answer(res, keys: Sequence[str] = (),
                   root: Path = spec.ROOT) -> reference.Answer:
    """A ``TDOAResult`` as an ``Answer``: TDOAs keyed by the pair's names
    in sorted order, signed for that order, the fix, and the named
    outputs that the checks ``keys`` take from it (``take``); with no
    keys, the TDOAs and the fix alone."""
    tdoa = {}
    for (i, j), t in zip(res.pair_idx, res.corrected_tdoa_samples):
        a, b = res.station_names[i], res.station_names[j]
        tdoa[(a, b) if a < b else (b, a)] = float(t if a < b else -t)
    ans = reference.Answer(tdoa, np.array([res.fix.lat, res.fix.lon,
                                           res.fix.elev]))
    for check in spec.checks(keys, root).values():
        take = getattr(check, "take", None)
        if take is not None:
            ans.outputs.update(take(res))
    return ans


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(proc, trf: dict, scenes: List[List[str]], seconds: float,
            device, trace: bool, tmp: str, t_start: float,
            keys: Sequence[str] = (), root: Path = spec.ROOT):
    """Warm-up, then the closed loop. Returns (Run, answers: list of
    (scene index, Answer or None for a window that raised)); each answer
    holds what the checks ``keys`` compare (``program_answer``)."""
    entry = getattr(proc, trf["entry"])
    for paths in scenes:
        entry(paths)
    _sync(device)
    run = Run(setup_s=time.perf_counter() - t_start, latencies=[],
              window_s=0.0)
    tracer = tracing.Tracer(proc, _counters()) if trace else None
    answers = []
    k = 0
    t0 = time.perf_counter()
    while True:
        s = k % len(scenes)
        t1 = time.perf_counter()
        try:
            with tracer.window() if tracer else contextlib.nullcontext():
                res = entry(scenes[s])
            _sync(device)
            answers.append((s, program_answer(res, keys, root)))
        except Exception:  # a window that fails is counted, the loop goes on
            _sync(device)
            answers.append((s, None))
            if sum(a is None for _, a in answers) == 1:
                traceback.print_exc()
        t2 = time.perf_counter()
        run.latencies.append(t2 - t1)
        if tracer and t2 - t0 >= tracing.TRACE_SECONDS:
            tracer.stop()
        k += 1
        if t2 - t0 >= seconds:
            break
    run.window_s = t2 - t0
    if tracer:
        tracer.stop()
        run.windows, run.launches, run.trace = tracer.read(tmp)
    return run, answers


def reference_answers(cfg: dict, trf: dict, scenes: List[List[str]], device,
                      precision: str = "f64",
                      root: Path = spec.ROOT) -> List[reference.Answer]:
    est = spec.estimator(trf, root)
    out = []
    for paths in scenes:
        raws = {scene_station(cfg, p): np.fromfile(p, np.uint8) for p in paths}
        out.append(est.window(raws, cfg, trf["reference"], device, precision))
        del raws
    return out


def scene_station(cfg: dict, path: str) -> str:
    base = os.path.basename(path)
    return next(n for n in cfg["receivers"] if f"-{n}-" in base)


def gaps(got: reference.Answer, want: reference.Answer, cfg: dict,
         keys: Sequence[str] = REQUIRED_CHECKS,
         root: Path = spec.ROOT) -> dict:
    """The numbers compared for one answer, by check (``keys``: a cell's
    limit keys; by default the two that every cell has): each check's
    ``gap``, infinite where it is not finite or where the two answers
    cover different pairs."""
    checks = spec.checks(keys, root)
    if set(got.tdoa) != set(want.tdoa):
        return {k: float("inf") for k in checks}
    out = {k: float(check.gap(got, want, cfg)) for k, check in checks.items()}
    return {k: v if np.isfinite(v) else float("inf") for k, v in out.items()}


def judge(answers, refs: List[reference.Answer], cfg: dict,
          limits: Dict[str, float], root: Path = spec.ROOT):
    """(numbers: the widest reading of each over the windows, failed:
    windows that raised or read over a limit)."""
    worst = {k: 0.0 for k in limits}
    failed = 0
    for s, ans in answers:
        if ans is None:
            failed += 1
            continue
        g = gaps(ans, refs[s], cfg, list(limits), root)
        worst = {k: max(worst[k], g[k]) for k in limits}
        failed += any(not g[k] <= limits[k] for k in limits)
    return worst, failed


def truth_error(ans: reference.Answer, cfg: dict,
                root: Path = spec.ROOT) -> float:
    """The widest corrected-TDOA error against the geometry the scene
    planted."""
    truth = spec.scene(cfg, root).truth_tdoa_samples(cfg)
    return max(abs(ans.tdoa[p] - truth[p]) for p in truth)


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _keep_caches_in(root: Path) -> None:
    """Every build and kernel cache under ``build/`` of the checkout, at
    fixed paths: only a checkout's first run builds."""
    build = root / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    trf = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])["limits"]
    # Every file the cell names resolves before the card is touched.
    spec.scene(cfg)
    spec.estimator(trf)
    spec.checks(limits)
    if not torch.cuda.is_available():
        print("no CUDA device is visible: the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    _keep_caches_in(spec.ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        scenes = make_scenes(cfg, trf, args.seed, tmp, device)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        proc = build_processor(cfg, trf, device, tmp)
        run, answers = measure(proc, trf, scenes, args.seconds, device,
                               bool(args.trace), tmp, t_start, list(limits))
        peak = int(torch.cuda.max_memory_allocated(device))
        del proc
        gc.collect()
        torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        refs = reference_answers(cfg, trf, scenes, device)
        t_ref = time.perf_counter() - t_ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers, failed = judge(answers, refs, cfg, limits)
    metrics = {}
    for m in spec.metrics(bench, cell["name"], bool(args.trace)):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": peak,
                   "power": _power_limit()}
    out = {"correct": failed == 0 and bool(answers), "attempted": len(answers),
           "failed": failed, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    lat = np.asarray(run.latencies)
    quarters = [float(np.median(q)) for q in np.array_split(lat, 4) if len(q)]
    done = [a for _, a in answers if a is not None]
    print(f"{cell['name']} seed {args.seed}: {len(lat)} windows in "
          f"{run.window_s:.3f} s; latency min/median/max "
          f"{lat.min():.4f} / {np.median(lat):.4f} / {lat.max():.4f} s; "
          f"set-up {run.setup_s:.3f} s; peak {peak} B; {device_info['power']}",
          file=sys.stderr)
    print("median latency by quarter of the window: "
          + " / ".join(f"{q:.4f}" for q in quarters), file=sys.stderr)
    print(f"reference: {t_ref:.3f} s for {len(refs)} scenes", file=sys.stderr)
    if run.trace is not None:
        print("host spans in the trace (s): " + ", ".join(
            f"{n} {s:.4f}" for n, s in sorted(run.trace.stage_s.items(),
                                               key=lambda x: -x[1])[:12]),
              file=sys.stderr)
    if done:
        print(f"widest TDOA error against the planted geometry: "
              f"{max(truth_error(a, cfg) for a in done):.5f} samples",
              file=sys.stderr)
    found = banned_modules()
    if found:
        print(f"modules that the benchmark may not load were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for k in limits:
        print(f"check {k} {numbers[k]!r} limit {limits[k]!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
