"""What a run reads from the data: ``BENCHMARK.json`` at the root of the
checkout names the cells, configurations and metrics; each has a file of
its own, found by its name:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  deployment, its stations, the processor's settings, what was assumed,
  and ``scene``, the name of its scene;
- ``traffic/<traffic>.json``: the entry a window calls, the processor
  settings it adds, the scenes a run rotates, the reference's estimator
  (``reference.estimator``) and its settings;
- ``workloads/<cell>.json``: the cell's correctness limits, one for each
  number compared, and the readings they were set from;
- ``metrics/<metric>.py``: a reader, ``read(run) -> float | None``;
- ``scenes/<scene>.py``: the generator of a window's files,
  ``write_scene(cfg, seed, out_dir, device) -> paths``, and the planted
  geometry, ``truth_tdoa_samples(cfg) -> {pair: samples}``;
- ``estimators/<estimator>.py``: the plain reference's answer to a
  window, ``window(raws, cfg, path, device, precision) -> Answer``;
- ``checks/<number>.py``, one for each key of a cell's ``limits``:
  ``gap(got, want, cfg) -> float``, how far the program's answer lies
  from the reference's, and optionally ``take(res) -> dict``, the named
  outputs of the program's ``TDOAResult`` it compares beyond the TDOAs
  and the fix.

A new cell, configuration, traffic mix, metric, scene, estimator or
compared number is a new file and, for the first four, an entry in
``BENCHMARK.json``; no file here changes."""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, Iterable, List, Optional

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
            cfg = _json(root / c["file"])
            if "scene" not in cfg:
                raise KeyError(f"{c['file']} names no scene: give it a "
                               f"\"scene\" key, a file of scenes/")
            return cfg
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


@functools.lru_cache(maxsize=None)
def plugin(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``<kind>/<name>.py`` under ``portbench/`` of ``root``,
    loaded once a process."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no file {kind}/{name}.py under {root / 'portbench'}")
    mod_spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def reader(name: str,
           root: Path = ROOT) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    return plugin("metrics", name, root).read


def scene(cfg: dict, root: Path = ROOT) -> ModuleType:
    """``scenes/<scene>.py`` of a configuration."""
    return plugin("scenes", cfg["scene"], root)


def estimator(trf: dict, root: Path = ROOT) -> ModuleType:
    """``estimators/<estimator>.py`` of a traffic mix's reference."""
    return plugin("estimators", trf["reference"]["estimator"], root)


def checks(names: Iterable[str], root: Path = ROOT) -> Dict[str, ModuleType]:
    """``checks/<name>.py`` of each number compared, by name."""
    return {k: plugin("checks", k, root) for k in names}
