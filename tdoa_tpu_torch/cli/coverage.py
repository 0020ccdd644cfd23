"""Coverage / GDOP planning map: predicted fix uncertainty over an area.

Answers the deployment-planning question the reference's field notes
circle around (PROJECT_NOTES.md:25-32 discusses baselines and valid
TDOA ranges but offers no placement tool): for THIS station geometry,
where can the network actually locate an emitter, and how well?

For every grid point the tool linearly propagates a per-pair TDOA error
through the range-difference Jacobian (the same
solve/multilateration.py:134-155 math used for a real fix's error
ellipse) and reports the 1σ ellipse semi-axes plus a dimensionless GDOP
(geometric dilution: ellipse RMS semi-axis per meter of ranging error).
Batched over the grid in one vectorized numpy pass: the tool does no
tensor work, so it has no device (as in the JAX package).

    python -m tdoa_tpu_torch.cli.coverage lat-lon-table.csv \
        [--tdoa-sigma-us 0.1] [--grid lat0 lon0 lat1 lon1] [--n 31] \
        [--csv-out out.csv]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tdoa_tpu_torch.geo import lla_to_enu, network_origin
from tdoa_tpu_torch.io.stations import load_station_table
from tdoa_tpu_torch.solve.multilateration import error_ellipse, station_pairs
from tdoa_tpu_torch.utils.constants import SPEED_OF_LIGHT


def coverage_grid(
    station_lla: np.ndarray,  # [n, 3]
    grid_lla: np.ndarray,  # [g, 3]
    tdoa_sigma_s: float,
) -> dict:
    """Per-grid-point 1σ ellipse axes and GDOP, vectorized.

    Returns dict of [g] arrays: semi_major_m, semi_minor_m, azimuth_deg,
    gdop (RMS ellipse semi-axis / (c·tdoa_sigma)).
    """
    n = len(station_lla)
    pairs = station_pairs(n)
    origin = network_origin(station_lla)
    st = lla_to_enu(station_lla, origin)  # [n, 3]
    pts = lla_to_enu(grid_lla, origin)  # [g, 3]

    di = pts[:, None, :] - st[None, pairs[:, 0], :]  # [g, m, 3]
    dj = pts[:, None, :] - st[None, pairs[:, 1], :]
    ui = di / np.maximum(np.linalg.norm(di, axis=-1, keepdims=True), 1e-9)
    uj = dj / np.maximum(np.linalg.norm(dj, axis=-1, keepdims=True), 1e-9)
    jac = (uj - ui)[..., :2]  # [g, m, 2]

    sigma_m = SPEED_OF_LIGHT * tdoa_sigma_s
    jtj = np.einsum("gmi,gmj->gij", jac, jac) / sigma_m**2  # [g, 2, 2]
    # Analytic 2×2 inverse; singular geometry (collinear etc.) → inf.
    a, b = jtj[:, 0, 0], jtj[:, 0, 1]
    c, d = jtj[:, 1, 0], jtj[:, 1, 1]
    det = a * d - b * c
    bad = det <= 1e-30
    det_safe = np.where(bad, 1.0, det)
    cov = (
        np.stack([np.stack([d, -b], -1), np.stack([-c, a], -1)], -2)
        / det_safe[:, None, None]
    )
    cov[bad] = np.inf

    g = len(pts)
    major = np.empty(g)
    minor = np.empty(g)
    az = np.empty(g)
    for i in range(g):  # error_ellipse is scalar; grid is small
        if not np.isfinite(cov[i]).all():
            major[i] = minor[i] = np.inf
            az[i] = 0.0
            continue
        major[i], minor[i], az[i] = error_ellipse(cov[i])
    gdop = np.sqrt((major**2 + minor**2) / 2.0) / sigma_m
    return {
        "semi_major_m": major,
        "semi_minor_m": minor,
        "azimuth_deg": az,
        "gdop": gdop,
    }


_RAMP = " .:-=+*#%@"  # low → high uncertainty


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="coverage",
        description="Predicted fix-uncertainty (GDOP) map for a station "
        "geometry",
    )
    p.add_argument("csv", help="lat-lon-table.csv station geometry")
    p.add_argument("--ref-freq", type=float, default=162_400_000.0,
                   help="reference frequency (identifies the ref-tx row)")
    p.add_argument("--tdoa-sigma-us", type=float, default=0.1,
                   help="assumed per-pair 1-sigma TDOA error, microseconds")
    p.add_argument("--grid", type=float, nargs=4, default=None,
                   metavar=("LAT0", "LON0", "LAT1", "LON1"),
                   help="map bounds (default: station bbox + 50%% margin)")
    p.add_argument("--n", type=int, default=31,
                   help="grid points per axis")
    p.add_argument("--elev", type=float, default=350.0,
                   help="assumed emitter elevation, m")
    p.add_argument("--stations", nargs="+", default=None, metavar="NAME",
                   help="receiver subset to evaluate (default: every "
                        "station row; note ground-truth transmitter rows "
                        "like KEVO count as receivers unless excluded)")
    p.add_argument("--csv-out", default=None,
                   help="write lat,lon,semi_major_m,semi_minor_m,"
                        "azimuth_deg,gdop rows")
    args = p.parse_args(argv)

    table = load_station_table(args.csv, reference_freq=args.ref_freq)
    try:
        lla = table.lla_array(args.stations)
    except KeyError as e:
        print(f"unknown station: {e}", file=sys.stderr)
        return 2
    if len(lla) < 3:
        print("need at least 3 stations", file=sys.stderr)
        return 2

    if args.grid is not None:
        lat0, lon0, lat1, lon1 = args.grid
    else:
        lat_c = (lla[:, 0].min() + lla[:, 0].max()) / 2
        lon_c = (lla[:, 1].min() + lla[:, 1].max()) / 2
        lat_h = max(lla[:, 0].max() - lla[:, 0].min(), 1e-3)
        lon_h = max(lla[:, 1].max() - lla[:, 1].min(), 1e-3)
        lat0, lat1 = lat_c - lat_h, lat_c + lat_h
        lon0, lon1 = lon_c - lon_h, lon_c + lon_h

    lats = np.linspace(lat0, lat1, args.n)
    lons = np.linspace(lon0, lon1, args.n)
    gl, gn = np.meshgrid(lats, lons, indexing="ij")
    grid = np.stack(
        [gl.ravel(), gn.ravel(), np.full(gl.size, args.elev)], axis=-1
    )
    cov = coverage_grid(lla, grid, args.tdoa_sigma_us * 1e-6)
    major = cov["semi_major_m"].reshape(args.n, args.n)

    sigma_m = SPEED_OF_LIGHT * args.tdoa_sigma_us * 1e-6
    print(
        f"Coverage map: {len(lla)} stations, TDOA sigma "
        f"{args.tdoa_sigma_us:.3f} us ({sigma_m:.0f} m ranging error)"
    )
    finite = np.isfinite(major)
    if finite.any():
        print(
            f"1-sigma semi-major axis over the map: best "
            f"{major[finite].min():.0f} m, median "
            f"{np.median(major[finite]):.0f} m"
        )
        frac_km = float(np.mean(major[finite] < 1000.0))
        print(f"{100*frac_km:.0f}% of the map localizes to < 1 km (1 sigma)")

    # ASCII map, north up: log scale from the best cell to 100x it.
    lo = max(major[finite].min(), 1.0) if finite.any() else 1.0
    print(f"\n  uncertainty map ({_RAMP!r} = {lo:.0f} m ... {100*lo:.0f} m+, "
          f"S = station):")
    st_cells = {
        (int(round((s[0] - lat0) / max(lat1 - lat0, 1e-9) * (args.n - 1))),
         int(round((s[1] - lon0) / max(lon1 - lon0, 1e-9) * (args.n - 1))))
        for s in lla
    }
    for r in range(args.n - 1, -1, -1):  # north at top
        row = []
        for ccol in range(args.n):
            if (r, ccol) in st_cells:
                row.append("S")
                continue
            v = major[r, ccol]
            if not np.isfinite(v):
                row.append("@")
                continue
            t = np.clip(np.log10(v / lo) / 2.0, 0.0, 1.0)
            row.append(_RAMP[int(t * (len(_RAMP) - 1))])
        print("  " + "".join(row))

    if args.csv_out:
        with open(args.csv_out, "w") as f:
            f.write("lat,lon,semi_major_m,semi_minor_m,azimuth_deg,gdop\n")
            for i in range(len(grid)):
                f.write(
                    f"{grid[i,0]:.6f},{grid[i,1]:.6f},"
                    f"{cov['semi_major_m'][i]:.1f},"
                    f"{cov['semi_minor_m'][i]:.1f},"
                    f"{cov['azimuth_deg'][i]:.1f},{cov['gdop'][i]:.2f}\n"
                )
        print(f"\nwrote {len(grid)} rows to {args.csv_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
