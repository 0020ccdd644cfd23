"""Continuous processing CLI: a directory of epoch-stamped captures →
per-epoch fixes → smoothed target track.

Torch port of ``tdoa_tpu.cli.stream_processor``. Each collection round
produces ``{station}-{epoch}.dat`` files; this tool groups them by
epoch, runs the standard pipeline per window on the card (``--device
cpu`` for the CPU), and feeds the fixes through the tracker
(pipeline/streaming.py — Kalman blend when the windows carry calibrated
covariances, alpha-beta otherwise).

    python -m tdoa_tpu_torch.cli.stream_processor <ref_freq> <tgt_freq> \
        <stations.csv> <capture_dir> [--target-id T] [--watch [SECS]]

``--watch`` turns the tool into a long-running service: it keeps
polling the directory and processes each new epoch window as its
captures land (the deployment loop — collectors scp files in, fixes
stream out), stopping only on Ctrl-C or ``--idle-exit`` seconds with
nothing new.

``--overlap-ingest CAPTURE_SECS`` adds tail-ingest: capture files are
consumed WHILE the collectors write them (pipeline/ingest.TailIngest),
chunk by chunk each poll, so at window close only the final chunks and
the finalize remain between the last byte and the fix — instead of the
whole read+copy+compute the batch path pays.

``--multi-emitter N>1`` tracks each separated co-channel emitter as its
own target; ``--solve-velocity`` feeds each window's CAF/FDOA velocity to
the tracker. ``--geojson`` needs a module the port does not have yet and
exits at start-up with the ``ROADMAP.md`` item that ports it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import defaultdict

import numpy as np

from tdoa_tpu_torch.cli import parse_prior, rewrite_prior_argv

# Options of the reference CLI whose machinery is not ported yet: their
# default (accepted) and the ROADMAP item that ports it.
_UNPORTED = {
    "geojson": (None, "host tools"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="stream_processor")
    p.add_argument("ref_freq", type=float)
    p.add_argument("target_freq", type=float)
    p.add_argument("csv")
    p.add_argument("capture_dir")
    p.add_argument("--target-id", default="target")
    p.add_argument("--max-lag", type=int, default=20000)
    p.add_argument("--seg-len", type=int, default=1 << 21)
    p.add_argument("--min-stations", type=int, default=3)
    p.add_argument("--watch", nargs="?", const=2.0, type=float, default=None,
                   metavar="POLL_SECS",
                   help="keep watching the directory for new epochs")
    p.add_argument("--settle", type=float, default=1.0,
                   help="seconds a window's newest file must be old "
                        "before processing (writers may still be going)")
    p.add_argument("--overlap-ingest", type=float, default=None,
                   metavar="CAPTURE_SECS",
                   help="tail-ingest GROWING capture files: give the "
                        "collection duration per window (the "
                        "collector's --duration) and each poll streams "
                        "newly-written chunks to the device while the "
                        "writers append, so the fix lands ~immediately "
                        "at window close instead of paying "
                        "read+copy+compute after it. A window whose "
                        "final file sizes disagree with the expected "
                        "duration falls back to the batch path. "
                        "Without --watch, complete files stream via "
                        "the one-shot overlapped path instead. "
                        "(Standard IQ pipeline only: incompatible "
                        "with --solve-velocity and --multi-emitter>1)")
    p.add_argument("--multi-emitter", type=int, default=1, metavar="N",
                   help="separate up to N co-channel emitters per window "
                        "and track each as its own target; tracks are "
                        "named {target-id}-1, -2, ... with cross-window "
                        "identity by nearest TDOA set")
    p.add_argument("--emitter-match-gate", type=float, default=20.0,
                   help="base TDOA distance (samples) for cross-window "
                        "emitter identity; grows 2 samples/s with window "
                        "spacing to cover emitter motion (~270 m/s)")
    p.add_argument("--power-disambiguation", action="store_true",
                   help="move ghost-ambiguous fixes to the 1/r "
                        "received-power-preferred candidate when the "
                        "ranking is decisive (see the processor CLI)")
    p.add_argument("--solve-velocity", action="store_true",
                   help="per-window CAF+FDOA velocity fused into the "
                        "track (instant velocity instead of "
                        "position-differencing)")
    p.add_argument("--prior", metavar="LAT,LON,RADIUS_KM", default=None,
                   help="coverage prior: surveillance area as center "
                        "lat,lon (deg) and radius (km) — resolves "
                        "ghost-ambiguous window fixes, warns on "
                        "out-of-prior fixes (see the processor CLI)")
    p.add_argument("--no-outlier-rejection", action="store_true",
                   help="disable per-window leave-one-station-out "
                        "outlier rejection (>= 5-station networks)")
    p.add_argument("--geojson", metavar="PATH", default=None,
                   help="maintain a live GeoJSON snapshot at PATH "
                        "(stations, current tracks with velocity/coast "
                        "state, per-track trails), rewritten after "
                        "every processed window — point a map at it")
    p.add_argument("--idle-exit", type=float, default=None,
                   help="with --watch: exit after this many seconds "
                        "without a new window (default: run forever)")
    p.add_argument("--jsonl", metavar="PATH", default=None,
                   help="append one JSON record per (window, target) "
                        "to PATH: window fix with its 1σ ellipse, "
                        "track state (position, velocity, own σ, "
                        "coast counter), quality, warnings — the "
                        "service counterpart of the batch processor's "
                        "--json, safe to tail -f")
    p.add_argument("--process-sigma-v", type=float, default=15.0,
                   metavar="MPS",
                   help="tracker process noise (m/s): how fast the "
                        "track's uncertainty grows per second to cover "
                        "unmodeled maneuvers — governs the Kalman gain "
                        "on calibrated windows and how much the "
                        "innovation gate widens across gaps (default "
                        "15, ~ a turning vehicle)")
    p.add_argument("--state", metavar="PATH", default=None,
                   help="checkpoint/resume for the tracking layer: "
                        "persist tracks, emitter identities, and the "
                        "processed-epoch set to PATH after every "
                        "window (atomic rewrite), and resume from it "
                        "on startup — a restarted --watch service "
                        "keeps its tracks instead of starting cold "
                        "and reprocessing the directory")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; an error when "
                        "none is visible — pass cpu to run on the CPU)")

    args = p.parse_args(
        rewrite_prior_argv(sys.argv[1:] if argv is None else argv)
    )
    for name, (default, item) in _UNPORTED.items():
        if getattr(args, name) != default:
            p.error(f"--{name.replace('_', '-')} is not ported to "
                    f"tdoa_tpu_torch yet (ROADMAP.md: \"{item}\"); "
                    f"use python -m tdoa_tpu.cli.stream_processor")
    prior = None if args.prior is None else parse_prior(args.prior, p.error)
    if args.overlap_ingest is not None:
        if args.overlap_ingest <= 0:
            p.error("--overlap-ingest needs a positive capture duration")
        # Same restrictions as the processor's host-resident mode
        # (process_captures raises too, but fail at startup, not on the
        # first window).
        if args.solve_velocity:
            p.error("--overlap-ingest is incompatible with "
                    "--solve-velocity (needs whole blocks on device)")
        if args.multi_emitter > 1:
            p.error("--overlap-ingest is incompatible with "
                    "--multi-emitter > 1 (needs whole blocks on device)")

    from tdoa_tpu_torch.io.stations import (
        load_station_table,
        parse_epoch_from_filename,
        station_from_filename,
    )
    from tdoa_tpu_torch.pipeline import TDOAProcessor
    from tdoa_tpu_torch.pipeline.streaming import TargetTracker

    table = load_station_table(args.csv, reference_freq=args.ref_freq)
    known = table.names

    warned = set()

    def scan_windows():
        """Group the directory's captures by epoch."""
        found = defaultdict(dict)
        for fn in sorted(os.listdir(args.capture_dir)):
            if not fn.endswith(".dat"):
                continue
            st = station_from_filename(fn, known)
            ep = parse_epoch_from_filename(fn)
            if st is None or ep is None:
                if fn not in warned:
                    warned.add(fn)
                    print(f"skipping {fn} (unknown station/epoch)",
                          file=sys.stderr)
                continue
            found[ep][st] = os.path.join(args.capture_dir, fn)
        return found

    windows = scan_windows()
    if not windows and args.watch is None:
        print("no usable captures found", file=sys.stderr)
        return 1

    try:
        proc = TDOAProcessor.from_csv(
            args.ref_freq, args.target_freq, args.csv, device=args.device,
            max_lag=args.max_lag, seg_len=args.seg_len,
            solve_velocity=args.solve_velocity,
            multi_emitter=args.multi_emitter,
            power_disambiguation=args.power_disambiguation,
            prior=prior,
            outlier_rejection=not args.no_outlier_rejection,
        )
    except RuntimeError as e:  # no card visible and no --device
        print(f"error: {e}", file=sys.stderr)
        return 2
    # Tail-ingest sessions (--overlap-ingest): one per unprocessed
    # epoch window, created when the window first reaches
    # --min-stations files, fed every poll with whatever bytes the
    # writers have appended since. ep -> (TailIngest, {station: path}).
    sessions: dict = {}
    overlap_block = None
    if args.overlap_ingest is not None:
        # The collector's own sample math:
        # samples_per_freq = duration * sample_rate // 3.
        overlap_block = (
            int(round(args.overlap_ingest * proc.config.sample_rate)) // 3
        )

    def open_views(files_map, names):
        """Current packed-u16 views of (possibly growing) captures —
        re-mmapped each call so the view length tracks the writer."""
        from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16

        views = []
        for n in names:
            raw = np.memmap(files_map[n], dtype=np.uint8, mode="r")
            views.append(iq_bytes_as_u16(raw[: (raw.size // 2) * 2]))
        return views

    def ensure_sessions(done) -> None:
        if overlap_block is None or args.watch is None:
            return
        for ep, files in windows.items():
            if ep in done or ep in sessions:
                continue
            if len(files) < args.min_stations:
                continue
            sessions[ep] = (
                proc.tail_session(sorted(files), overlap_block),
                dict(files),
            )

    def feed_sessions(done) -> None:
        nonlocal last_new
        for ep in list(sessions):
            if ep in done or ep not in windows:
                del sessions[ep]
                continue
            sess, files_map = sessions[ep]
            try:
                views = open_views(files_map, sess.names)
            except (OSError, ValueError):
                continue  # a file vanished or is still empty; next poll
            if sess.feed(views):
                # Streaming a live capture is service activity — the
                # --idle-exit clock must not expire mid-window.
                last_new = time.time()
                print(
                    f"epoch {ep}: tail-ingest "
                    f"{sess.chunks_dispatched}/{sess.total_chunks} chunks",
                    file=sys.stderr,
                )

    # Tracker over the station set actually present in each window;
    # rebuilt when the set changes (tracks carry over only while the
    # geometry is stable — a different set means a different pair basis).
    tracker = None
    tracker_order = None
    # Cross-window emitter identity (multi-emitter mode): each window's
    # separated TDOA sets are matched to the previous window's by
    # nearest TDOA distance — emitter order from the association is
    # strength-sorted and can swap between windows. Every window routes
    # through this (even single-emitter ones) so identity survives
    # 1 <-> 2 emitter transitions.
    emitter_refs: dict = {}  # id -> (TDOA set samples, epoch)
    # id -> [[lat, lon], ...]: the map trails of --geojson. Not filled
    # here until that option is ported, but carried through --state so a
    # state file moves between this service and the reference's.
    track_history: dict = {}
    emitter_seq = 0
    seen_warnings: set = set()  # print each distinct warning once
    restored_processed: set = set()

    def _atomic_write_json(path: str, obj: dict, label: str) -> None:
        import json as _json

        try:
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                _json.dump(obj, fh)
            os.replace(tmp, path)  # atomic for live readers
        except OSError as e:
            print(f"warning: could not write {label}: {e}",
                  file=sys.stderr)

    if args.state and os.path.exists(args.state):
        import json as _json

        try:
            with open(args.state) as fh:
                st = _json.load(fh)
            if st.get("version") != 1:
                raise ValueError(
                    f"state version {st.get('version')!r}, want 1"
                )
            # The saved ENU frame and TDOA basis are only meaningful
            # for the same run: same station coordinates (a corrected
            # CSV shifts the network origin) and same frequencies.
            for key, want in (("ref_freq", args.ref_freq),
                              ("target_freq", args.target_freq)):
                if key in st and float(st[key]) != float(want):
                    raise ValueError(
                        f"state was saved for {key}={st[key]}, "
                        f"this run uses {want}"
                    )
            order = [str(n) for n in st["station_order"]]
            unknown = [n for n in order if n not in known]
            if unknown:
                raise ValueError(
                    f"stations {unknown} not in {args.csv}"
                )
            if "station_lla" in st:
                saved = np.asarray(st["station_lla"], np.float64)
                cur = np.asarray(table.lla_array(order), np.float64)
                # rtol must be 0: allclose's default rtol=1e-5 on a
                # ~41 deg latitude swallows ~1e-4 deg (≈ 10 m) moves.
                # JSON round-trips float64 exactly; 1e-9 deg is slack.
                if saved.shape != cur.shape or not np.allclose(
                        saved, cur, rtol=0.0, atol=1e-9):
                    raise ValueError(
                        "station coordinates changed since the state "
                        "was saved (the track ENU frame moved)"
                    )
            tracker_order = order
            tracker = TargetTracker(table.lla_array(tracker_order),
                        process_sigma_v=args.process_sigma_v)
            tracker.load_state_dict(st.get("tracks", {}))
            emitter_seq = int(st.get("emitter_seq", 0))
            emitter_refs = {
                str(k): (np.asarray(v["tdoa"], float), float(v["epoch"]))
                for k, v in st.get("emitter_refs", {}).items()
            }
            track_history = {
                str(k): [[float(a), float(b)] for a, b in v]
                for k, v in st.get("track_history", {}).items()
            }
            restored_processed = {int(e) for e in st.get("processed", [])}
            print(
                f"resumed {len(tracker.tracks)} track(s) / "
                f"{len(restored_processed)} processed epoch(s) "
                f"from {args.state}",
                file=sys.stderr,
            )
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(
                f"warning: could not resume --state {args.state} "
                f"({e}); starting fresh",
                file=sys.stderr,
            )
            tracker = tracker_order = None
            emitter_refs, track_history = {}, {}
            emitter_seq = 0
            restored_processed = set()

    def save_state(processed_eps, present_eps) -> None:
        if not args.state or tracker is None:
            return
        st = {
            "version": 1,
            "station_order": list(tracker_order),
            "station_lla": [
                [float(v) for v in row]
                for row in table.lla_array(tracker_order)
            ],
            "ref_freq": float(args.ref_freq),
            "target_freq": float(args.target_freq),
            "tracks": tracker.state_dict(),
            "emitter_seq": emitter_seq,
            "emitter_refs": {
                k: {"tdoa": [float(x) for x in v[0]],
                    "epoch": float(v[1])}
                for k, v in emitter_refs.items()
            },
            # Pruned to epochs whose files are still in the directory:
            # the set only guards against REprocessing present files,
            # and an unpruned list grows without bound in a run-forever
            # service (rewritten every window).
            "processed": sorted(
                int(e) for e in processed_eps if e in present_eps
            ),
            "track_history": track_history,
        }
        _atomic_write_json(args.state, st, "--state")

    def assign_emitter_ids(sets, ep: float) -> dict:
        """Greedy nearest-neighbor matching of this window's emitter
        TDOA sets to known emitter ids; unmatched sets get new ids.
        The match gate widens with the time since an id was last seen
        (a moving emitter walks its TDOAs between windows)."""
        nonlocal emitter_seq
        assigned = {}
        used = set()
        entries = []
        for k, es in enumerate(sets):
            for eid, (ref, ref_ep) in emitter_refs.items():
                if len(ref) == len(es.tdoa_samples):
                    d = float(np.abs(es.tdoa_samples - ref).max())
                    gate = (args.emitter_match_gate
                            + 2.0 * abs(float(ep) - ref_ep))
                    if d <= gate:
                        entries.append((d, k, eid))
        for d, k, eid in sorted(entries):
            if k in assigned or eid in used:
                continue
            assigned[k] = eid
            used.add(eid)
        for k, es in enumerate(sets):
            if k not in assigned:
                emitter_seq += 1
                assigned[k] = f"{args.target_id}-{emitter_seq}"
            emitter_refs[assigned[k]] = (
                np.asarray(sets[k].tdoa_samples, float), float(ep)
            )
        return assigned

    def settled(files) -> bool:
        """Writers may still be appending — require the window's newest
        file to be at least --settle seconds old."""
        try:
            newest = max(os.path.getmtime(f) for f in files.values())
        except OSError:
            return False
        return (time.time() - newest) >= args.settle

    def prefer_track_candidate(res, ep: float):
        """Stream-level ghost disambiguation: the batch processor's
        ladder (prior > FDOA > power) can stay inconclusive when both
        intersections are close and both fitted speeds plausible — but
        an ESTABLISHED track knows where the emitter is heading. When
        the window fix is ghost-ambiguous, the candidate consistent
        with the track's own predicted position is the physical one;
        decisively closer (inside the innovation gate, with the other
        candidate well outside) swaps the fix. Returns the (possibly
        refit) fix."""
        fix = res.fix
        tr = tracker.tracks.get(args.target_id) if tracker else None
        if (tr is None or tr.n_updates < 2
                or fix.candidates_lla is None
                or len(fix.candidates_lla) < 2
                or fix.candidates_rms is None):
            return fix
        sigma_m = (
            float(np.median(np.asarray(res.tdoa_std_s))) * 299792458.0
            if res.tdoa_std_s is not None else 0.0
        )
        # Same runner-up-fits-within-noise test as the processor's
        # ghost warning — unambiguous fixes are left alone.
        if float(fix.candidates_rms[1]) > max(
                2.0 * fix.rms_residual_m, 3.0 * sigma_m, 5.0):
            return fix
        from tdoa_tpu_torch.geo import lla_to_enu
        from tdoa_tpu_torch.solve import refit_to_candidate

        pred = tr.pos_enu + tr.vel_enu * max(float(ep) - tr.last_t, 0.0)
        d = np.array([
            np.linalg.norm(lla_to_enu(
                np.asarray(c, np.float64), tracker.origin)[:2] - pred[:2])
            for c in fix.candidates_lla
        ])
        k = int(np.argmin(d))
        gate = max(tracker.gate_floor_m, tracker.gate_k * tr.innov_ema_m)
        if k == 0 or d[k] > gate or np.delete(d, k).min() < 2.0 * gate:
            return fix
        fix = refit_to_candidate(
            fix, k, table.lla_array(tracker_order), res.pair_idx,
            weights=res.solve_weights, tdoa_sigma_s=res.tdoa_std_s,
        )
        print(
            f"epoch {ep}: ghost-ambiguous window fix moved to the "
            f"track-consistent candidate ({d[k]:.0f} m from the "
            f"predicted position vs {np.delete(d, k).min():.0f} m)",
            file=sys.stderr,
        )
        return fix

    def process_window(ep, files) -> None:
        nonlocal tracker, tracker_order
        res = None
        entry = sessions.pop(ep, None)
        if entry is not None:
            sess, files_map = entry
            if set(files) != set(sess.names):
                print(
                    f"epoch {ep}: station set changed after tail-ingest "
                    f"started ({sorted(sess.names)} -> {sorted(files)}); "
                    f"using the batch path",
                    file=sys.stderr,
                )
            else:
                from tdoa_tpu_torch.pipeline.processor import HostCapture

                try:
                    views = open_views(files_map, sess.names)
                    caps = {
                        n: HostCapture(u16=v, block_len=v.shape[0] // 3)
                        for n, v in zip(sess.names, views)
                    }
                    res = proc.process_captures(caps, tail=sess)
                except (ValueError, OSError) as e:
                    print(
                        f"epoch {ep}: tail-ingest fell back to the "
                        f"batch path ({e})",
                        file=sys.stderr,
                    )
        if res is None:
            res = (
                proc.process_files_overlapped(sorted(files.values()))
                if overlap_block is not None
                else proc.process_files(sorted(files.values()))
            )
        if tracker is None or tracker_order != res.station_names:
            if tracker is not None:
                print(
                    f"station set changed "
                    f"({','.join(tracker_order)} -> "
                    f"{','.join(res.station_names)}); restarting tracks",
                    file=sys.stderr,
                )
            tracker_order = res.station_names
            tracker = TargetTracker(table.lla_array(tracker_order),
                        process_sigma_v=args.process_sigma_v)
            # Refs live in the old station set's pair basis; a match
            # against them after a geometry change would be meaningless.
            emitter_refs.clear()
            track_history.clear()
        fdoa = None
        vel_meas = {}
        fix0 = prefer_track_candidate(res, float(ep))
        swapped = fix0 is not res.fix
        fixes = {args.target_id: fix0}
        updates = {args.target_id: res.tdoa_seconds}
        # The processor's final solve weights (gates + outlier
        # exclusions) must govern the tracker's re-solve too.
        upd_weights = {args.target_id: res.solve_weights}
        # In multi-emitter mode quality is the associated peak height;
        # in plain mode it is the peak-to-sidelobe ratio — consistent
        # within a run, different scales between modes.
        qualities = {args.target_id: float(res.quality.mean())}
        # Empty association (res.emitters == []) falls through to the
        # single-target path above: the window's primary fix is still
        # valid and must reach the tracker, not be dropped.
        if res.emitters:
            ids = assign_emitter_ids(res.emitters, float(ep))
            updates = {}
            qualities = {}
            fixes = {}
            upd_weights = {}
            for k, es in enumerate(res.emitters):
                updates[ids[k]] = es.tdoa_samples / proc.config.sample_rate
                qualities[ids[k]] = float(es.peak_value.mean())
                fixes[ids[k]] = es.fix
                upd_weights[ids[k]] = es.solve_weights
            # Joint (lag, Doppler) separation attributes each emitter
            # its own velocity; pass the processor's WEIGHTED solve
            # straight to the tracker (re-solving from raw FDOA here
            # would drop the peak-ratio weights and sigma floor).
            vel_meas = {
                ids[k]: e.velocity_enu
                for k, e in enumerate(res.emitters)
                if e.velocity_enu is not None
            }
            if not vel_meas and res.fdoa_hz is not None \
                    and len(res.emitters) == 1:
                fdoa = {ids[0]: res.fdoa_hz}
        elif res.fdoa_hz is not None:
            if swapped:
                # The processor solved its velocity at the OLD primary
                # (the ghost): re-solve from the measured Dopplers at
                # the track-consistent position instead.
                fdoa = {args.target_id: res.fdoa_hz}
            elif res.velocity_enu is not None:
                vel_meas = {args.target_id: res.velocity_enu}
            else:
                fdoa = {args.target_id: res.fdoa_hz}
        for wmsg in res.warnings:
            if wmsg not in seen_warnings:
                seen_warnings.add(wmsg)
                print(f"epoch {ep}: WARNING: {wmsg}", file=sys.stderr)
        from tdoa_tpu_torch.geo import lla_to_enu as _lla_to_enu

        # Feed the PROCESSOR's fixes to the tracker instead of letting
        # it re-solve raw TDOAs: the per-window fix went through the
        # full defense ladder (ghost disambiguation, outlier exclusion,
        # the track-consistency swap above) — a raw re-solve can land
        # in a basin the processor rejected.
        positions = {
            tid: _lla_to_enu(
                np.array([f.lat, f.lon, f.elev]), tracker.origin
            )
            for tid, f in fixes.items()
        }
        # Calibrated window covariances (FixResult.cov_en, present when
        # the processor produced split-σ TDOA errors) upgrade the
        # tracker's position blend to a Kalman gain.
        covs = {
            tid: f.cov_en for tid, f in fixes.items()
            if f.cov_en is not None
        }
        tracker.update(
            float(ep),
            updates,
            qualities=qualities,
            fdoa_hz=fdoa,
            carrier_hz=args.target_freq,
            velocity_enu=vel_meas or None,
            weights=upd_weights or None,
            positions_enu=positions,
            covs_en=covs or None,
        )
        for tid in updates:
            tr = tracker.tracks[tid]
            tlla = tr.lla(tracker.origin)
            f = fixes[tid]
            coast = (
                f" COASTING[{tr.coasts}] (window fix rejected by the "
                f"innovation gate)" if tr.coasts else ""
            )
            sig = ""
            if tr.cov_p is not None:
                # 1σ semi-major axis of the TRACK estimate (shrinks as
                # calibrated windows accumulate, unlike the per-window
                # ellipse).
                sig = f" ±{np.sqrt(np.linalg.eigvalsh(tr.cov_p)[-1]):.0f}m"
            print(
                f"epoch {ep}: fix {f.lat:.6f},{f.lon:.6f} "
                f"(rms {f.rms_residual_m:.1f} m)  "
                f"{tid} {tlla[0]:.6f},{tlla[1]:.6f}{sig} "
                f"v=({tr.vel_enu[0]:+.1f},{tr.vel_enu[1]:+.1f}) m/s "
                f"[{tr.n_updates} updates]{coast}",
                flush=True,
            )
            if args.jsonl:
                import json as _json

                rec = {
                    "epoch": int(ep),
                    "id": str(tid),
                    "fix": {
                        "lat": float(f.lat), "lon": float(f.lon),
                        "elev_m": float(f.elev),
                        "rms_residual_m": float(f.rms_residual_m),
                    },
                    "track": {
                        "lat": float(tlla[0]), "lon": float(tlla[1]),
                        "vel_e_mps": float(tr.vel_enu[0]),
                        "vel_n_mps": float(tr.vel_enu[1]),
                        "n_updates": int(tr.n_updates),
                        "coasting": int(tr.coasts),
                    },
                    "quality": float(qualities.get(tid, 0.0)),
                    "warnings": list(res.warnings),
                }
                if f.ellipse is not None:
                    maj, mnr, azd = f.ellipse
                    rec["fix"]["ellipse_1sigma_m"] = {
                        "semi_major": float(maj),
                        "semi_minor": float(mnr),
                        "azimuth_deg": float(azd),
                    }
                if tr.cov_p is not None:
                    rec["track"]["sigma_major_m"] = float(
                        np.sqrt(max(np.linalg.eigvalsh(tr.cov_p)[-1],
                                    0.0))
                    )
                try:
                    with open(args.jsonl, "a") as fh:
                        fh.write(_json.dumps(rec) + "\n")
                except OSError as e:
                    print(f"warning: could not append --jsonl: {e}",
                          file=sys.stderr)

    processed = set(restored_processed)
    skipped_thin = set()
    last_new = time.time()
    while True:
        ensure_sessions(processed)
        feed_sessions(processed)
        for ep in sorted(windows):
            if ep in processed:
                continue
            files = windows[ep]
            if len(files) < args.min_stations:
                # One-shot mode reports thin windows; watch mode keeps
                # waiting — the missing station may still scp in.
                if args.watch is None and ep not in skipped_thin:
                    skipped_thin.add(ep)
                    print(f"epoch {ep}: only {len(files)} stations — skipped")
                continue
            if args.watch is not None and not settled(files):
                continue
            process_window(ep, files)
            processed.add(ep)
            save_state(processed, windows.keys())
            last_new = time.time()
        if args.watch is None:
            break
        if (args.idle_exit is not None
                and time.time() - last_new > args.idle_exit):
            print(f"idle for {args.idle_exit} s — exiting watch")
            break
        try:
            time.sleep(args.watch)
        except KeyboardInterrupt:
            break
        windows = scan_windows()
        # Epochs whose files left the directory can never be re-seen;
        # keep the guard set bounded in a run-forever service.
        processed &= set(windows)
    if tracker is None:
        print("no complete windows", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
