"""What every scene shares (``scenes/<name>.py`` makes a window's
files; a configuration names its scene under ``scene``): the generator
seed of each scene of a run, the receivers in file order, a station's
coordinates, and the files' names.

Every seed gives the same sizes, geometry and clocks: a seed draws the
sources and the noise alone, so the work of a window never depends on
it."""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

EPOCH = 1_700_000_000


def scene_seed(seed: int, k: int) -> int:
    """The generator seed of scene ``k`` of a run started with ``seed``
    (any integer): 63 bits of a ``SeedSequence`` of the two."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(k)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def receivers(cfg: dict) -> List[str]:
    """The receiving stations, sorted: the order of the files a window
    hands the processor, and of its pairs."""
    return sorted(cfg["receivers"])


def station_lla(cfg: dict, name: str) -> np.ndarray:
    row = next(r for r in cfg["stations"] if r[0] == name)
    return np.asarray(row[1:4], np.float64)


def write_files(raws: Dict[str, np.ndarray], out_dir: str) -> List[str]:
    """Write one window's bytes by receiver into ``out_dir``
    (``sim-<station>-<epoch>.dat``, the simulator's names) and return
    their paths in the order of ``raws``."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, raw in raws.items():
        p = os.path.join(out_dir, f"sim-{name}-{EPOCH}.dat")
        raw.tofile(p)
        paths.append(p)
    return paths
