"""Tracing and stage timing of the port (``tdoa_tpu_torch/utils/
profiling.py``) and the processor's stage names, against the JAX
package's ``utils/profiling.py`` and processor on the same simulated
files (the port on CPU tensors).

The stage names a ``TDOAProcessor.timer`` sees are what ``--profile``
reports: after ``process_files`` and ``process_files_overlapped`` the
port names the same stages, in the same order, as the reference —
``load+decode``, ``mmap`` and ``re-solve (echo-bias σ)`` included.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, scene  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    from tdoa_tpu.cli import processor as jax_cli
    from tdoa_tpu.dsp import multipath as jmultipath
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.sim import write_scene_captures
    from tdoa_tpu.utils import profiling as jprof
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.dsp import multipath as tmultipath
from tdoa_tpu_torch.pipeline import TDOAProcessor
from tdoa_tpu_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parents[1]
CSV = str(REPO / "lat-lon-table.csv")
OMAHA = {
    "names": ("kx0u", "n3pay", "kf0mtl"),
    "station_lla": np.array([
        [41.18660274289527, -95.96064116595667, 355.69],
        [41.24669616513154, -96.08366304481238, 329.0],
        [41.32916620016985, -96.03513381562004, 373.18],
    ]),
    "ref_tx_lla": np.array([41.25703803095629, -95.95512763589404, 349.07]),
    "tgt_tx_lla": np.array([41.30888549464701, -96.02619229605524, 356.0]),
    "ref_freq": 162_400_000.0,
    "tgt_freq": 101_900_000.0,
}
FREQS = (OMAHA["ref_freq"], OMAHA["tgt_freq"])
SMALL = dict(seg_len=1 << 14, max_lag=512)


def test_stage_timer_report_format_equals_the_references():
    times = {"load+decode": 0.2034, "correlate+clock": 0.0412,
             "re-solve (echo-bias σ)": 0.0031, "solve": 0.0205}
    timers = [tprof.StageTimer(), jprof.StageTimer()]
    for t in timers:
        for name, sec in times.items():
            t.times[name] = sec
            t.order.append(name)
    assert timers[0].report() == timers[1].report()
    assert timers[0].report().splitlines()[0] == "total    268.2 ms"


def test_stage_timer_accumulates_in_first_seen_order():
    t = tprof.StageTimer()
    for name in ("a", "b", "a"):
        with t.stage(name):
            pass
    assert t.order == ["a", "b"]
    assert set(t.times) == {"a", "b"} and t.times["a"] >= 0.0
    with pytest.raises(KeyError):  # a stage that raises is still timed
        with t.stage("c"):
            raise KeyError("c")
    assert t.order == ["a", "b", "c"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "tr").glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_sync_of_cpu_tensors_leaves_the_card_alone(monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("synchronised a card for CPU tensors")

    monkeypatch.setattr(torch.cuda, "synchronize", no_card)
    tprof.sync({"a": [torch.ones(2), (torch.zeros(1), 3)], "b": None})
    tprof.StageTimer().observe(torch.ones(1))


@pytest.mark.cuda
def test_sync_finds_cuda_tensors_in_nested_structures(cuda_sm90, monkeypatch):
    import dataclasses
    from typing import NamedTuple

    class NT(NamedTuple):
        x: object

    @dataclasses.dataclass
    class DC:
        y: object

    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    tprof.sync({"k": [NT(x=DC(y=torch.ones(1, device=cuda_sm90)))]})
    assert seen == [torch.ones(1, device=cuda_sm90).device]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 3 × 2¹⁷-sample scene with clock offsets, as ``.dat`` files."""
    sc = scene(OMAHA, 1 << 17, seed=11,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
    out = tmp_path_factory.mktemp("profiling")
    paths, _ = write_scene_captures(sc, str(out))
    return sorted(paths.values())


@pytest.fixture
def no_echo_sigma(monkeypatch):
    """Both packages' echo-bias σ forced to zero: no re-solve."""
    def sigma(offset, env_confirmed=False):
        return np.zeros(np.shape(offset))

    monkeypatch.setattr(jmultipath, "echo_bias_sigma", sigma)
    monkeypatch.setattr(tmultipath, "echo_bias_sigma", sigma)


@pytest.mark.parametrize("run,echo", [
    ("process_files", True),
    ("process_files_overlapped", True),
    ("process_files", False),
])
def test_stage_names_equal_the_references(files, request, run, echo):
    """On this scene both packages add an echo-bias σ and solve again
    (``re-solve (echo-bias σ)``); with that σ forced to zero neither
    does."""
    if not echo:
        request.getfixturevalue("no_echo_sigma")
    jp = JaxProcessor.from_csv(*FREQS, CSV, **SMALL)
    tp = TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **SMALL)
    jp.timer, tp.timer = jprof.StageTimer(), tprof.StageTimer()
    getattr(jp, run)(files)
    getattr(tp, run)(files)
    assert tp.timer.order == jp.timer.order
    assert ("re-solve (echo-bias σ)" in tp.timer.order) is echo
    assert tp.timer.order[0] == ("mmap" if run.endswith("overlapped")
                                 else "load+decode")


_STAGE_LINE = re.compile(r"^  (.+?)\s+[\d.]+ ms  \(\s*[\d.]+%\)$")


def _stages(report_text):
    """The stage names of a ``--profile`` report on stderr."""
    lines = report_text.split("stage timings:\n", 1)[1].splitlines()
    assert lines[0].startswith("total ")
    return [m.group(1) for m in map(_STAGE_LINE.match, lines[1:]) if m]


@pytest.mark.parametrize("extra", [[], ["--overlap-ingest"]])
def test_cli_profile_reports_the_references_stages(files, capsys, tmp_path,
                                                   extra):
    """``--profile`` prints the stage report to stderr; with ``--trace DIR``
    beside it the port writes a Chrome trace of the run into DIR."""
    args = [str(FREQS[0]), str(FREQS[1]), CSV, *files, "--max-lag", "512",
            "--seg-len", str(1 << 14), "--json", "--profile", *extra]
    assert jax_cli.main(args) == 0
    want = _stages(capsys.readouterr().err)
    trace_dir = tmp_path / "trace"
    assert port_cli.main([*args, "--device", "cpu",
                          "--trace", str(trace_dir)]) == 0
    got = _stages(capsys.readouterr().err)
    assert got == want and len(got) >= 3
    (trace,) = trace_dir.glob("trace-*.json")
    assert json.loads(trace.read_text())["traceEvents"]
