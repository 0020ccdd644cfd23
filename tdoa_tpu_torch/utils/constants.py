"""System-wide constants.

Values mirror the reference system's data contracts (SURVEY.md §1):
2 Msps capture rate (collector.go:83), 3-block [REF|TGT|REF] captures,
and a ±10 ms correlation search window (processor.go:633).
"""

# Physics
SPEED_OF_LIGHT = 299_792_458.0  # m/s (processor.go uses 299792458.0)

# Capture contract (collector.go:82-85)
DEFAULT_SAMPLE_RATE = 2_000_000.0  # samples/s
MAX_CAPTURE_SECONDS = 100  # collector.go:31-34
SWITCH_INTERVAL_SECONDS = 10  # collector.go:85 — per-frequency block length
NUM_BLOCKS = 3  # [REF | TGT | REF]

# u8 IQ encoding: byte b maps to (b - 127.5) / 127.5 (processor.go:198-200)
IQ_CENTER = 127.5
IQ_SCALE = 127.5

# Correlation search window: maxLag samples (processor.go:633).
# Physical TDOAs for the reference's ~17 km network are < 57 us = 114
# samples at 2 Msps (PROJECT_NOTES.md:29-32); 20000 mirrors the
# reference's generous window.
DEFAULT_MAX_LAG = 20_000

# WGS84 ellipsoid (processor.go:126-129)
WGS84_A = 6_378_137.0  # semi-major axis, m
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_E2 = 2 * WGS84_F - WGS84_F * WGS84_F  # first eccentricity squared
