"""What a run reads from the data: ``BENCHMARK.json`` at the root of the
checkout names the cells, configurations and metrics; each has a file of
its own, found by its name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  deployment, its stations, the processor's settings, what was assumed;
- ``traffic/<traffic>.json``: the entry a window calls, the processor
  settings it adds, the scenes a run rotates, the reference's estimator;
- ``workloads/<cell>.json``: the cell's correctness limits and the
  readings they were set from;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``.

A new cell, configuration, traffic mix or metric is a new file and an
entry in ``BENCHMARK.json``; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(root / c["file"])
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "portbench" / "traffic" / f"{name}.json")


def limits(cell_name: str, root: Path = ROOT) -> dict:
    return _json(root / "portbench" / "workloads" / f"{cell_name}.json")


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones without
    trace, the per-layer ones with it; a metric with ``workloads``
    only in the cells it lists."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str,
           root: Path = ROOT) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
