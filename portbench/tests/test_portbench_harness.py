"""CPU tests of the benchmark: its data resolves by name, a new traffic
mix and cell are found without an edit, a tiny-block run of the
harness's loop agrees with the plain reference, the frozen roofline
counts, the import rules, and the run's refusal without a card.

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
    w = spec.cell(BENCH, cell)
    cfg = spec.config(BENCH, w["config"])
    trf = spec.traffic(w["traffic"])
    lim = spec.limits(cell)["limits"]
    assert cfg["name"] == w["config"]
    assert trf["entry"] in ("process_files", "process_files_overlapped")
    assert set(lim) == {"tdoa_gap", "fix_gap_m"}
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


def test_new_cell_is_found_without_edits(tmp_path):
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


def test_reference_imports_nothing_of_the_program():
    names = _top_level(f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference, portbench.scene, portbench.roofline
print(*sorted({{m.split(".")[0] for m in sys.modules}}))
""")
    assert not names & {"tdoa_tpu_torch", "tdoa_tpu", "jax", "jaxlib"}
    for f in ("reference.py", "geo.py", "scene.py", "roofline.py"):
        tree = ast.parse((ROOT / "portbench" / f).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                assert node.module.split(".")[0] != "tdoa_tpu_torch", f
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != "tdoa_tpu_torch"
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
