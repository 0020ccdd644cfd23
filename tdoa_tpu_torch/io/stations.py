"""Station geometry: ``lat-lon-table.csv`` loading and filename conventions.

Contract (reference: processor.go:52-107 and lat-lon-table.csv):
CSV columns ``Name,Latitude,Longitude,Elevation`` with a header row. The
reference transmitter's row is *named by its frequency in Hz* formatted as
``"%.0f"`` (processor.go:96-98). Capture filenames embed the station name
(``{station}-{epoch}.dat``); station identity is recovered by substring
search of known station names in the filename (processor.go:110-122).
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Station:
    name: str
    lat: float  # degrees
    lon: float  # degrees
    elev: float  # meters above the WGS84 ellipsoid

    def lla(self) -> "np.ndarray":
        """(lat°, lon°, elev m) row, the geometry modules' currency."""
        return np.array([self.lat, self.lon, self.elev])


@dataclasses.dataclass
class StationTable:
    """All known sites plus the reference transmitter, if identified."""

    stations: List[Station]
    reference_tx: Optional[Station] = None  # the REF-frequency transmitter
    extra: List[Station] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._by_name: Dict[str, Station] = {s.name: s for s in self.stations}

    def __getitem__(self, name: str) -> Station:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    @property
    def names(self) -> List[str]:
        return [s.name for s in self.stations]

    def lla_array(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        """Stack (lat, lon, elev) rows for the given stations — solver input."""
        sel = self.stations if names is None else [self[n] for n in names]
        return np.array([[s.lat, s.lon, s.elev] for s in sel], dtype=np.float64)


def load_station_table(path: str, reference_freq: Optional[float] = None) -> StationTable:
    """Parse the station CSV.

    A row whose name equals ``f"{reference_freq:.0f}"`` is the reference
    transmitter and is excluded from the receiver-station list
    (processor.go:96-105). Any other row named by a bare frequency (all
    digits) is a transmitter keyed by that frequency and lands in
    ``extra``. Callsign-named transmitter rows (e.g. KEVO, the target
    transmitter in the shipped table) are indistinguishable from receivers
    by the CSV contract and stay in ``stations`` — reference parity: its
    processor also carries them, relying on capture filenames only ever
    matching real receivers.
    """
    ref_name = f"{reference_freq:.0f}" if reference_freq is not None else None
    stations: List[Station] = []
    extra: List[Station] = []
    ref_tx: Optional[Station] = None
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is not None and _looks_like_data(header):
            # No header row — rewind by treating it as data.
            rows = [header] + list(reader)
        else:
            rows = list(reader)
    for row in rows:
        if len(row) < 4 or not row[0].strip():
            continue
        st = Station(
            name=row[0].strip(),
            lat=float(row[1]),
            lon=float(row[2]),
            elev=float(row[3]),
        )
        if ref_name is not None and st.name == ref_name:
            ref_tx = st
        elif st.name.isdigit():
            # Frequency-named row for some OTHER frequency: a known
            # transmitter, not a receiver.
            extra.append(st)
        else:
            stations.append(st)
    return StationTable(stations=stations, reference_tx=ref_tx, extra=extra)


def _looks_like_data(row: List[str]) -> bool:
    try:
        float(row[1])
        return True
    except (IndexError, ValueError):
        return False


def station_from_filename(filename: str, known_names: Sequence[str]) -> Optional[str]:
    """Recover station identity by substring search in the filename
    (processor.go:110-122). Longest match wins to disambiguate names that
    contain one another."""
    base = filename.rsplit("/", 1)[-1].lower()
    hits = [n for n in known_names if n.lower() in base]
    return max(hits, key=len) if hits else None


def parse_epoch_from_filename(filename: str) -> Optional[int]:
    """Extract the capture start epoch from ``{station}-{epoch}.dat``."""
    base = filename.rsplit("/", 1)[-1]
    stem = base[:-4] if base.endswith(".dat") else base
    tail = stem.rsplit("-", 1)[-1]
    return int(tail) if tail.isdigit() else None
