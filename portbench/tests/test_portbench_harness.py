"""CPU tests of the benchmark: its data and plug-ins (scenes, reference
estimators, compared numbers, metric readers) resolve by name, a new
traffic mix, cell, metric and a whole deployment with its own scene,
estimator and compared number are found and run without an edit, a
tiny-block run of the harness's loop agrees with the plain reference,
the frozen roofline counts, the import rules, and the run's refusal
without a card.

Run from the root of the repository: ``python -m pytest portbench/tests``.
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, roofline, spec  # noqa: E402

BENCH = spec.benchmark()
TINY_BLOCK = 400_000  # 8 kernel segments, the fused route's least


def tiny_config(name: str = "omaha3-30s") -> dict:
    cfg = spec.config(BENCH, name)
    cfg["block_samples"] = TINY_BLOCK
    return cfg


def tiny_run(tmp_path, traffic: str, seed: int = 2 ** 33 + 5):
    """One warm-up and one measured window per scene on the CPU (the
    kernels' plain versions); returns (answers, reference answers, cfg)."""
    cfg = tiny_config()
    trf = spec.traffic(traffic)
    dev = torch.device("cpu")
    scenes = harness.make_scenes(cfg, trf, seed, str(tmp_path), dev)
    proc = harness.build_processor(cfg, trf, dev, str(tmp_path))
    _, answers = harness.measure(proc, trf, scenes, 0.0, dev, False,
                                 str(tmp_path), 0.0)
    refs = harness.reference_answers(cfg, trf, scenes, dev)
    return answers, refs, cfg


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    trf = spec.traffic(w["traffic"])
    lim = spec.limits(cell)["limits"]
    assert cfg["name"] == w["config"]
    assert callable(getattr(TDOAProcessor, trf["entry"]))
    # A cell may add checks; the TDOAs and the fix are held in every one.
    assert {"tdoa_gap", "fix_gap_m"} <= set(lim)
    for trace in (False, True):
        for m in spec.metrics(BENCH, cell, trace):
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_resolves(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = spec.config(BENCH, config)
    assert entry["file"].startswith("portbench/")
    assert cfg["source"] == entry["source"]
    assert set(cfg["receivers"]) <= {r[0] for r in cfg["stations"]}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_config_names_a_scene_that_resolves(config):
    gen = spec.scene(spec.config(BENCH, config))
    assert callable(gen.write_scene) and callable(gen.truth_tdoa_samples)


@pytest.mark.parametrize("traffic", sorted({w["traffic"]
                                            for w in BENCH["workloads"]}))
def test_every_traffic_names_an_estimator_that_resolves(traffic):
    assert callable(spec.estimator(spec.traffic(traffic)).window)


@pytest.mark.parametrize("cell,key", [
    (w["name"], k) for w in BENCH["workloads"]
    for k in spec.limits(w["name"])["limits"]])
def test_every_limit_names_a_check_that_resolves(cell, key):
    check = spec.checks([key])[key]
    assert callable(check.gap)
    assert callable(getattr(check, "take", lambda res: {}))


def test_a_config_without_a_scene_is_refused_by_its_file(tmp_path):
    (tmp_path / "portbench/configs").mkdir(parents=True)
    cfg = json.loads((ROOT / "portbench/configs/omaha3-30s.json").read_text())
    del cfg["scene"]
    (tmp_path / "portbench/configs/bare.json").write_text(json.dumps(cfg))
    bench = {"configs": [{"name": "bare",
                          "file": "portbench/configs/bare.json"}]}
    with pytest.raises(KeyError, match="portbench/configs/bare.json"):
        spec.config(bench, "bare", tmp_path)
    with pytest.raises(KeyError, match="scenes/moving.py"):
        spec.scene({"scene": "moving"})


def test_static_scene_refuses_a_drift():
    cfg = tiny_config()
    cfg["assumed"]["receiver_drift_ppm"] = 0.3
    with pytest.raises(ValueError, match="receiver_drift_ppm"):
        spec.scene(cfg).write_scene(cfg, 1, "unused", torch.device("cpu"))


# A deployment added as new files only: the static scene with one
# receiver's TGT block planted late, an estimator that also gives the
# raw TGT delays, and a compared number on those delays.
LATE_SCENE = '''
from portbench import spec
from portbench.scene import receivers, write_files

static = spec.plugin("scenes", "static")


def write_scene(cfg, seed, out_dir, device):
    late = cfg["assumed"]["late_tgt"]
    delays = static.block_delays(cfg)
    delays["tgt"][receivers(cfg).index(late["receiver"])] += late["samples"]
    return write_files(static.synthesize(cfg, seed, device, delays), out_dir)


def truth_tdoa_samples(cfg):
    late = cfg["assumed"]["late_tgt"]
    shift = {late["receiver"]: float(late["samples"])}
    return {(a, b): t + shift.get(b, 0.0) - shift.get(a, 0.0)
            for (a, b), t in static.truth_tdoa_samples(cfg).items()}
'''
TGT_ESTIMATOR = '''
from portbench import reference, spec

iq = spec.plugin("estimators", "iq")


def window(raws, cfg, path, device, precision="f64"):
    prec = reference.Precision(precision)
    max_lag = int(cfg["processor"]["max_lag"])
    blk = reference.per_block(
        raws, device, prec,
        lambda x, pairs, p: iq.iq_delays(x, pairs, max_lag, path["dc"], p))
    ans = reference.answer(cfg, blk)
    ans.outputs["tgt_delay"] = {
        (blk.names[i], blk.names[j]): float(d)
        for (i, j), d in zip(blk.pairs, blk.delays[1])}
    return ans
'''
TGT_CHECK = '''
def take(res):
    out = {}
    for (i, j), d in zip(res.pair_idx, res.tgt_delay_samples):
        a, b = res.station_names[i], res.station_names[j]
        out[(a, b) if a < b else (b, a)] = float(d if a < b else -d)
    return {"tgt_delay": out}


def gap(got, want, cfg):
    g, w = got.outputs["tgt_delay"], want.outputs["tgt_delay"]
    return max(abs(g[p] - w[p]) for p in w)
'''


def _late_run(root, work, seed: int = 2 ** 33 + 41):
    """The tiny harness loop over the added deployment, every piece found
    under ``root``: (numbers, failed, answers, cfg)."""
    bench = spec.benchmark(root)
    w = spec.cell(bench, "omaha3-30s-late.files-tgt")
    cfg = spec.config(bench, w["config"], root)
    cfg["block_samples"] = TINY_BLOCK
    trf = spec.traffic(w["traffic"], root)
    limits = spec.limits(w["name"], root)["limits"]
    dev = torch.device("cpu")
    work.mkdir(exist_ok=True)
    scenes = harness.make_scenes(cfg, trf, seed, str(work), dev, root)
    proc = harness.build_processor(cfg, trf, dev, str(work))
    _, answers = harness.measure(proc, trf, scenes, 0.0, dev, False,
                                 str(work), 0.0, list(limits), root)
    refs = harness.reference_answers(cfg, trf, scenes, dev, root=root)
    numbers, failed = harness.judge(answers, refs, cfg, limits, root)
    return numbers, failed, answers, cfg


def _tgt_altered(original):
    """clock_correct_blocks with the first pair's raw TGT delay moved by
    0.05 sample and the corrected TDOAs left as they were."""
    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        tgt = out[1].clone()
        tgt[0] += 0.05
        return (out[0], tgt) + tuple(out[2:])
    return wrapper


def test_new_cell_is_found_without_edits(tmp_path, monkeypatch):
    """A traffic mix, a cell and a metric added as new files (and entries
    in BENCHMARK.json) resolve; no file under portbench/ changes."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    trf = json.loads((ROOT / "portbench/traffic/files.json").read_text())
    trf["scenes"] = 3
    (tmp_path / "portbench/traffic/files3.json").write_text(json.dumps(trf))
    (tmp_path / "portbench/workloads/omaha3-100s.files3.json").write_text(
        json.dumps({"limits": {"tdoa_gap": 1.0, "fix_gap_m": 1.0}}))
    (tmp_path / "portbench/metrics/windows_n.py").write_text(
        "def read(run):\n    return len(run.latencies)\n")
    bench["workloads"].append({"name": "omaha3-100s.files3",
                               "config": "omaha3-100s", "traffic": "files3",
                               "chips": 1, "why": "three scenes"})
    bench["per_layer"].append({"name": "windows_n", "unit": "windows",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "fix_s",
                               "workloads": ["omaha3-100s.files3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    got = spec.benchmark(tmp_path)
    cell = spec.cell(got, "omaha3-100s.files3")
    assert spec.config(got, cell["config"], tmp_path)["block_samples"] \
        == 66_666_666
    assert spec.traffic(cell["traffic"], tmp_path)["scenes"] == 3
    assert spec.limits(cell["name"], tmp_path)["limits"]["tdoa_gap"] == 1.0
    names = [m["name"] for m in spec.metrics(got, cell["name"], True)]
    assert "windows_n" in names and "k3_roofline" not in names
    run = harness.Run(setup_s=1.0, latencies=[0.1, 0.2], window_s=0.3)
    assert spec.reader("windows_n", tmp_path)(run) == 2

    # A deployment of its own: scene, estimator and compared number.
    pb = tmp_path / "portbench"
    (pb / "scenes/late_tgt.py").write_text(LATE_SCENE)
    (pb / "estimators/iq_tgt.py").write_text(TGT_ESTIMATOR)
    (pb / "checks/tgt_delay_gap.py").write_text(TGT_CHECK)
    cfg = json.loads((ROOT / "portbench/configs/omaha3-30s.json").read_text())
    cfg.update(name="omaha3-30s-late", scene="late_tgt")
    cfg["assumed"]["late_tgt"] = {"receiver": "n3pay", "samples": 160}
    (pb / "configs/omaha3-30s-late.json").write_text(json.dumps(cfg))
    trf = json.loads((ROOT / "portbench/traffic/files.json").read_text())
    trf["reference"]["estimator"] = "iq_tgt"
    (pb / "traffic/files-tgt.json").write_text(json.dumps(trf))
    (pb / "workloads/omaha3-30s-late.files-tgt.json").write_text(json.dumps(
        {"limits": {"tdoa_gap": 0.003, "tgt_delay_gap": 0.003}}))
    bench["configs"].append({"name": "omaha3-30s-late",
                             "source": cfg["source"],
                             "file": "portbench/configs/omaha3-30s-late.json",
                             "reduced": [], "why": "n3pay's TGT late"})
    bench["workloads"].append({"name": "omaha3-30s-late.files-tgt",
                               "config": "omaha3-30s-late",
                               "traffic": "files-tgt", "chips": 1,
                               "why": "a late TGT and its raw delays"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    numbers, failed, answers, late_cfg = _late_run(tmp_path,
                                                   tmp_path / "work")
    assert answers and failed == 0, numbers
    assert set(numbers) == {"tdoa_gap", "tgt_delay_gap"}
    # The program reads the planted lateness, which the static truth lacks.
    assert max(harness.truth_error(a, late_cfg, tmp_path)
               for _, a in answers) < 0.5
    static = spec.plugin("scenes", "static", tmp_path)
    truth = static.truth_tdoa_samples(late_cfg)
    assert min(max(abs(a.tdoa[p] - truth[p]) for p in truth)
               for _, a in answers) > 150

    # A fault planted where the raw TGT delay is produced: only the added
    # number sees it, and every window fails.
    from tdoa_tpu_torch.pipeline import ingest, processor

    for mod in (processor, ingest):
        monkeypatch.setattr(mod, "clock_correct_blocks",
                            _tgt_altered(mod.clock_correct_blocks))
    numbers, failed, answers, _ = _late_run(tmp_path, tmp_path / "work")
    assert failed == len(answers) > 0, numbers
    assert numbers["tdoa_gap"] <= 0.003 < numbers["tgt_delay_gap"]

    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("traffic", ["files", "overlapped", "fm"])
def test_tiny_run_agrees_with_reference(tmp_path, traffic):
    answers, refs, cfg = tiny_run(tmp_path, traffic)
    cell = next(w["name"] for w in BENCH["workloads"]
                if w["traffic"] == traffic)
    limits = spec.limits(cell)["limits"]
    numbers, failed = harness.judge(answers, refs, cfg, limits)
    assert answers and failed == 0, numbers
    # The paths hold the planted geometry too (8 segments: ~0.2 sample
    # of noise; FM times the audio's 8× coarser samples).
    tol = 4.0 if traffic == "fm" else 0.5
    assert max(harness.truth_error(a, cfg) for _, a in answers) < tol


def test_frozen_counts():
    """The numbers PERF.md quotes for kernel 1 at 3 stations × 443
    segments, K = 4, bf16, and kernel 3 at 9 × 20 M, D = 8."""
    b = roofline.k1_bound(3, 3, 443, 4)
    assert round(b["ops"] / 1e9, 2) == 8.19
    assert round(b["bytes"] / 1e6) == 255
    assert round(b["seconds"] * 1e3, 3) == 0.122
    b = roofline.k3_bound(9, 20_000_000, 8)
    assert round(b["bytes"] / 1e9, 2) == 1.53
    assert round(b["ops"] / 1e9, 1) == 10.6
    assert round(b["seconds"] * 1e3, 3) == 0.457


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_run_imports_no_jax(tmp_path):
    """A CPU run through the harness leaves no module named jax, jaxlib,
    flax or tdoa_tpu (whole top-level names) in its process."""
    code = f"""
import sys, torch
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness, spec
cfg = spec.config(spec.benchmark(), "omaha3-30s")
cfg["block_samples"] = {TINY_BLOCK}
trf = spec.traffic("files")
dev = torch.device("cpu")
scenes = harness.make_scenes(cfg, trf, 7, {str(tmp_path)!r}, dev)
proc = harness.build_processor(cfg, trf, dev, {str(tmp_path)!r})
harness.measure(proc, trf, scenes[:1], 0.0, dev, False, {str(tmp_path)!r}, 0.0)
print(*sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    names = _top_level(code)
    assert "tdoa_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "tdoa_tpu"}


PLUGINS = ("scenes", "estimators", "checks")
BANNED_HERE = {"tdoa_tpu_torch", "tdoa_tpu", "jax", "jaxlib", "flax"}


def test_reference_imports_nothing_of_the_program():
    """The reference, the scenes, the estimators and the compared
    numbers load nothing of the program or of JAX, and name none of it."""
    names = _top_level(f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference, portbench.scene, portbench.roofline
from portbench import spec
for kind in {PLUGINS!r}:
    for p in sorted((spec.HERE / kind).glob("*.py")):
        spec.plugin(kind, p.stem)
print(*sorted({{m.split(".")[0] for m in sys.modules}}))
""")
    assert not names & BANNED_HERE
    files = [ROOT / "portbench" / f
             for f in ("reference.py", "geo.py", "scene.py", "roofline.py")]
    files += [p for kind in PLUGINS
              for p in sorted((ROOT / "portbench" / kind).glob("*.py"))]
    assert len(files) > 4 + len(PLUGINS)
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.module.split(".")[0] not in BANNED_HERE, f
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] not in BANNED_HERE
                           for a in node.names), f


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "omaha3-30s.files",
         "--seed", "2147483649", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    """The whole command on the card: a result line, correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "omaha3-30s.files",
         "--seed", "2147483651", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_traced_tiny_run_feeds_the_readers(tmp_path):
    """The traced loop on the CPU: per-window stage spans and the trace's
    window reach the readers; the device readers find no kernel there
    and return nothing."""
    cfg = tiny_config()
    trf = spec.traffic("files")
    dev = torch.device("cpu")
    scenes = harness.make_scenes(cfg, trf, 3, str(tmp_path), dev)
    proc = harness.build_processor(cfg, trf, dev, str(tmp_path))
    run, answers = harness.measure(proc, trf, scenes, 0.0, dev, True,
                                   str(tmp_path), 0.0)
    assert answers and len(run.windows) == len(answers)
    assert proc.timer is None and run.trace.window_s > 0.0
    assert spec.reader("load_ms")(run) > 0.0
    assert spec.reader("solve_ms")(run) > 0.0
    assert spec.reader("gather_ms")(run) is None
    assert spec.reader("k1_roofline")(run) is None
    assert not list(tmp_path.glob("trace.json"))


def test_trace_summary_splits_idle_time_by_stage(tmp_path):
    """Busy time is the union of device intervals inside the windows; the
    idle rest is split by the stage open on the host, the window outside
    its stages, and the time between windows."""
    from portbench import tracing

    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    events = [x(tracing.WINDOW, "user_annotation", 0, 100),
              x(tracing.WINDOW, "user_annotation", 120, 80),
              x("load+decode", "user_annotation", 0, 60),
              x("solve", "user_annotation", 130, 20),
              x("k", "kernel", 10, 20), x("Memcpy", "gpu_memcpy", 20, 20),
              x("k", "kernel", 150, 10), x("aten::add", "cpu_op", 0, 5)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = tracing.TraceSummary(str(path))
    assert t.window_s == pytest.approx(200e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.kernel_s(("k",)) == pytest.approx(30e-6)
    idle = dict(t.idle_gaps())
    assert idle["load+decode"] == pytest.approx(30e-6)
    assert idle["solve"] == pytest.approx(20e-6)
    assert idle["window, outside the program's stages"] == pytest.approx(
        90e-6)
    assert idle["between windows"] == pytest.approx(20e-6)
