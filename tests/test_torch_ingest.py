"""Overlapped ingest, tail sessions and the stream service of
``tdoa_tpu_torch`` against ``tdoa_tpu`` on the same simulated ``.dat``
files (CPU tensors; ``accumulator="xla"`` gives the port the geometry the
JAX package takes off the TPU), and against the port's own batch path on
kernel 1's geometry."""

import json
import re
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, scene  # noqa: F401

try:  # the card's machine has no JAX: there only the `cuda` tests run
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.pipeline import ingest as jingest
    from tdoa_tpu.pipeline.processor import HostCapture as JaxHostCapture
    from tdoa_tpu.sim import NoiseProfile, write_scene_captures
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.cli import stream_processor as port_stream
from tdoa_tpu_torch.geo import lla_to_enu
from tdoa_tpu_torch.io.datfile import iq_bytes_as_u16
from tdoa_tpu_torch.pipeline import TDOAProcessor
from tdoa_tpu_torch.pipeline import ingest as tingest
from tdoa_tpu_torch.pipeline.processor import HostCapture

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
SMALL = dict(seg_len=1 << 14, max_lag=512)  # the segmented geometry
K_SEG = 45056
_NUMBER = re.compile(r"[-+]?\d+(?:\.\d+)?")


def _views(paths, names):
    out = []
    for n in names:
        raw = np.memmap(paths[n], dtype=np.uint8, mode="r")
        out.append(iq_bytes_as_u16(raw[: (raw.size // 2) * 2]))
    return out


def _grow(sess, views, steps=10):
    """The 'writer' appends in ten steps: feed views cut to k/10 of the
    file; returns the chunks dispatched before the last step."""
    total = views[0].shape[0]
    before = 0
    for k in range(1, steps + 1):
        d = sess.feed([v[:total * k // 10] for v in views])
        if k < 10:
            before += d
    return before


def _fix_error_m(fix):
    est = np.array([fix.lat, fix.lon, OMAHA["tgt_tx_lla"][2]])
    return float(np.linalg.norm(lla_to_enu(est, OMAHA["tgt_tx_lla"])[:2]))


# ---- plan_chunks ------------------------------------------------------

def test_plan_chunks_equals_the_reference_on_a_grid():
    for block_len in (0, 895, 896, 10_000, 1 << 17, 20_000_000):
        for seg in (896, 1 << 14, K_SEG):
            for chunk in (1, seg, 3 * seg, 3 * seg + 5, 48 * seg):
                assert tingest.plan_chunks(block_len, seg, chunk) == \
                    jingest.plan_chunks(block_len, seg, chunk)
            # no size given: the port's own measured default
            assert tingest.plan_chunks(block_len, seg) == jingest.plan_chunks(
                block_len, seg, tingest.DEFAULT_CHUNK_SEGS * seg)
    chunk, spans = tingest.plan_chunks(20_000_000, K_SEG)
    assert chunk == tingest.DEFAULT_CHUNK_SEGS * K_SEG
    assert sum(n for _, n in spans) == 443 * K_SEG


# ---- against the JAX package, segmented geometry ----------------------

@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """Files of a 3 × 2¹⁷-sample scene with clock offsets, the JAX
    package's batch, overlapped and ten-step tail results on them."""
    sc = scene(OMAHA, 1 << 17, seed=11,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
    out = tmp_path_factory.mktemp("ingest-small")
    paths, truth = write_scene_captures(sc, str(out))
    files = sorted(paths.values())
    jp = JaxProcessor.from_csv(*FREQS, CSV, **SMALL)
    names = sorted(OMAHA["names"])
    views = _views(paths, names)
    bl = views[0].shape[0] // 3
    sess = jp.tail_session(names, bl, chunk_samples=bl // 4)
    _grow(sess, views)
    caps = {n: JaxHostCapture(u16=v, block_len=bl)
            for n, v in zip(names, views)}
    return {
        "paths": paths, "files": files, "truth": truth, "names": names,
        "block_len": bl,
        "jax_batch": jp.process_files(files),
        "jax_overlapped": jp.process_files_overlapped(files),
        "jax_tail": jp.process_captures(caps, tail=sess),
    }


def _port(**cfg):
    return TDOAProcessor.from_csv(*FREQS, CSV, device="cpu", **cfg)


def _words_and_numbers(text):
    nums = [float(v) for v in _NUMBER.findall(text)]
    return _NUMBER.sub("#", text), nums


def _same_verdicts(rt, rj):
    """Same warnings word for word (their numbers to the printed digit or
    1e-3 relative), same ghost verdict, same exclusions."""
    assert len(rt.warnings) == len(rj.warnings)
    for wt, wj in zip(rt.warnings, rj.warnings):
        tt, nt = _words_and_numbers(wt)
        tj, nj = _words_and_numbers(wj)
        assert tt == tj
        np.testing.assert_allclose(nt, nj, rtol=1e-3, atol=0.1)
    assert (rt.ghost is None) == (rj.ghost is None)
    if rj.ghost is not None:
        assert rt.ghost.best == rj.ghost.best
        assert rt.ghost.decided == rj.ghost.decided
    assert rt.excluded_stations == rj.excluded_stations


def test_overlapped_matches_jax(small_scene):
    """``process_files_overlapped`` on both packages, same chunk plan and
    geometry: corrected TDOAs within 0.05 sample (measured: ~1e-4), raw
    delays likewise, σ within 5 %, same station order, warnings and ghost
    verdict; and within 0.05 sample of the JAX batch path, 0.5 of the
    truth."""
    rj = small_scene["jax_overlapped"]
    proc = _port(accumulator="xla", **SMALL)
    rt = proc.process_files_overlapped(small_scene["files"])
    assert rt.station_names == rj.station_names
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=0.05)
    np.testing.assert_allclose(rt.tgt_delay_samples, rj.tgt_delay_samples,
                               atol=0.05)
    np.testing.assert_allclose(rt.ref_delay_samples, rj.ref_delay_samples,
                               atol=0.05)
    np.testing.assert_allclose(rt.tdoa_std_s, rj.tdoa_std_s, rtol=0.05)
    np.testing.assert_allclose(rt.clock_drift_ppm, rj.clock_drift_ppm,
                               atol=1e-3)
    _same_verdicts(rt, rj)
    np.testing.assert_allclose(
        rt.corrected_tdoa_samples,
        small_scene["jax_batch"].corrected_tdoa_samples, atol=0.05)
    tau = dict(zip(OMAHA["names"],
                   small_scene["truth"].station_delays_samples[:, 1]))
    np.testing.assert_allclose(
        rt.corrected_tdoa_samples,
        [tau[rt.station_names[j]] - tau[rt.station_names[i]]
         for i, j in rt.pair_idx], atol=0.5)
    assert _fix_error_m(rt.fix) < 150.0
    assert np.all(rt.tdoa_std_s > 0)
    d = proc.ingest_diag
    assert d["transfer_stream_s"] is None
    assert d["n_chunks"] == len(tingest.plan_chunks(1 << 17, 1 << 14)[1])


def test_tail_session_matches_jax(small_scene):
    """A tail session fed the files in ten growth steps, then
    ``process_captures(caps, tail=session)``: all but the last chunks
    went out before the last step, and the result is the JAX session's
    (0.05 sample, same warnings and ghost verdict)."""
    rj = small_scene["jax_tail"]
    names, bl = small_scene["names"], small_scene["block_len"]
    proc = _port(accumulator="xla", **SMALL)
    views = _views(small_scene["paths"], names)
    sess = proc.tail_session(names, bl, chunk_samples=bl // 4)
    assert sess.names == names and sess.total_chunks >= 9
    assert not sess.complete and sess.chunks_dispatched == 0
    before_close = _grow(sess, views)
    assert before_close >= sess.total_chunks - 2
    assert sess.complete and sess.chunks_dispatched == sess.total_chunks
    caps = {n: HostCapture(u16=v, block_len=bl) for n, v in zip(names, views)}
    rt = proc.process_captures(caps, tail=sess)
    assert rt.station_names == rj.station_names == names
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=0.05)
    np.testing.assert_allclose(rt.tdoa_std_s, rj.tdoa_std_s, rtol=0.05)
    _same_verdicts(rt, rj)
    assert _fix_error_m(rt.fix) < 150.0
    assert np.all(rt.tdoa_std_s > 0)


def test_ingest_overlapped_direct_call_and_block_lens():
    """``ingest_overlapped`` on synthetic u16 captures of unequal file
    sizes (per-station ``block_lens``), against the JAX function on the
    same words: the 10-tuple's delays within 2e-3 samples."""
    rng = np.random.default_rng(4)
    seg, block_len = 2048, 16 * 2048
    delays, extra = [0, 5, -3], [0, 640, 128]
    pad = 64
    ref = rng.standard_normal(block_len + 2 * pad + 1024) \
        + 1j * rng.standard_normal(block_len + 2 * pad + 1024)
    tgt = rng.standard_normal(block_len + 2 * pad + 1024) \
        + 1j * rng.standard_normal(block_len + 2 * pad + 1024)
    host = []
    for d, e in zip(delays, extra):
        n = block_len + e  # this station's own block length
        z = np.concatenate([ref[pad:pad + n], tgt[pad - d:pad - d + n],
                            ref[pad:pad + n]]) * 0.25
        i = np.clip(np.round(z.real * 127.5 + 127.5), 0, 255).astype(np.uint16)
        q = np.clip(np.round(z.imag * 127.5 + 127.5), 0, 255).astype(np.uint16)
        host.append((i | (q << 8)).astype(np.uint16))
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    kw = dict(block_len=block_len,
              block_lens=[block_len + e for e in extra], max_lag=256,
              seg_len=seg, weighting="ht", chunk_samples=4 * seg)
    diag = {}
    got = tingest.ingest_overlapped(host, pair, np.zeros(3), device="cpu",
                                    accumulator="xla", diag=diag, **kw)
    want = jingest.ingest_overlapped(host, pair, np.zeros(3, np.float32),
                                     adaptive=False, **kw)
    assert len(got) == len(want) == 10
    # resolve_seg: FFT 2048, segments of 2048 − 256 samples
    assert diag["chunk_segs"] == 4 and diag["n_chunks"] == 5
    for k in (0, 1, 2, 3, 6, 8):  # the delay and σ entries
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-3)
    np.testing.assert_allclose(
        got[0].numpy(), [delays[j] - delays[i] for i, j in pair], atol=0.5)
    with pytest.raises(ValueError, match="block_lens"):
        tingest.ingest_overlapped(host, pair, np.zeros(3), device="cpu",
                                  **{**kw, "block_lens": [block_len - 1] * 3})


# ---- errors -----------------------------------------------------------

@pytest.mark.parametrize("cfg,named", [
    ({"solve_velocity": True}, "solve_velocity"),
    ({"mode": "fm"}, "mode='fm'"),
    ({"multi_emitter": 2}, "multi_emitter"),
    ({"lo_compensation": "auto"}, "lo_compensation"),
])
def test_overlapped_refuses_options_that_need_whole_blocks(small_scene, cfg,
                                                           named):
    proc = _port(**SMALL, **cfg)
    with pytest.raises(ValueError, match="overlapped ingest") as e:
        proc.process_files_overlapped(small_scene["files"])
    assert named in str(e.value)


@pytest.mark.parametrize("case,exc,match", [
    ("missing", FileNotFoundError, "capture file not found"),
    ("unknown", ValueError, "cannot infer station"),
    ("twice", ValueError, "two capture files resolve"),
    ("short", ValueError, "capture too short"),
])
def test_overlapped_filename_errors(small_scene, tmp_path, case, exc, match):
    files = list(small_scene["files"])
    if case == "missing":
        files[0] = str(tmp_path / "kx0u-1.dat")
    elif case == "unknown":
        files[0] = str(shutil.copy(files[0], tmp_path / "nobody-1.dat"))
    elif case == "twice":
        files[1] = str(shutil.copy(files[0], tmp_path / "again-kx0u-2.dat"))
        files[0] = small_scene["paths"]["kx0u"]
    else:
        (tmp_path / "kx0u-3.dat").write_bytes(b"\x80" * 4)
        files = [str(tmp_path / "kx0u-3.dat")]
    with pytest.raises(exc, match=match):
        _port(**SMALL).process_files_overlapped(files)


def test_ingest_takes_no_adaptive_option():
    """The reference's ``adaptive`` picks a chunk ladder tuned on its
    tunnel link, which the port does not carry: asking for it is an
    error, not a setting that is silently dropped."""
    pair = np.array([[0, 1], [0, 2], [1, 2]], np.int32)
    with pytest.raises(TypeError, match="adaptive"):
        tingest.TailIngest(list(OMAHA["names"]), pair, np.zeros(3),
                           block_len=1 << 15, device="cpu", adaptive=True)
    host = [np.zeros(3 << 15, np.uint16)] * 3
    with pytest.raises(TypeError, match="adaptive"):
        tingest.ingest_overlapped(host, pair, np.zeros(3), block_len=1 << 15,
                                  device="cpu", adaptive=False)


def test_tail_size_mismatch_is_refused(small_scene):
    """A finished file whose block length disagrees with the session's
    means every block-1/2 chunk mixed two blocks: refuse, do not fix."""
    names, bl = small_scene["names"], small_scene["block_len"]
    proc = _port(accumulator="xla", **SMALL)
    views = _views(small_scene["paths"], names)
    sess = proc.tail_session(names, bl + 4096)
    sess.feed(views)
    caps = {n: HostCapture(u16=v, block_len=bl) for n, v in zip(names, views)}
    with pytest.raises(ValueError, match="mismatch"):
        proc.process_captures(caps, tail=sess)
    assert sess.mismatch is not None
    with pytest.raises(ValueError, match="tail session stations"):
        proc.process_captures(dict(reversed(list(caps.items()))), tail=sess)
    with pytest.raises(ValueError, match="HostCapture"):
        proc.process_captures(
            {n: tuple(np.zeros(8, np.complex64) for _ in range(3))
             for n in names}, tail=sess)
    with pytest.raises(ValueError, match="capture_block_len"):
        tingest.TailIngest(names, sess._pairs, np.zeros(3), block_len=bl,
                           capture_block_len=bl - 1, device="cpu", **SMALL)


def test_finalize_on_an_incomplete_capture_raises_value_error(small_scene):
    """The reference's message promises a ValueError here (its own code
    raises AttributeError from a removed field): the port keeps the
    promise and names the samples the last chunk needs."""
    names, bl = small_scene["names"], small_scene["block_len"]
    proc = _port(accumulator="xla", **SMALL)
    views = _views(small_scene["paths"], names)
    sess = proc.tail_session(names, bl, chunk_samples=bl // 4)
    half = [v[:v.shape[0] // 2] for v in views]
    seg = (1 << 14) - 512  # resolve_seg keeps the FFT, shrinks the segment
    need = 2 * bl + (bl // seg) * seg
    with pytest.raises(ValueError, match="capture incomplete") as e:
        sess.finalize(half)
    assert f"needs {need} samples" in str(e.value)
    assert 0 < sess.chunks_dispatched < sess.total_chunks
    out = sess.finalize(views)  # the rest arrives: the session completes
    assert len(out) == 10 and sess.complete


# ---- kernel 1's geometry: against the port's own batch path -----------

@pytest.fixture(scope="module")
def kernel_scene(tmp_path_factory):
    """Files of a 3 × (8 × 45056)-sample scene and the port's fused batch
    result on them (CPU tensors: the kernels' plain versions)."""
    prof = NoiseProfile(signal_amplitude=0.3, noise_amplitude=0.15)
    sc = scene(OMAHA, 8 * K_SEG, seed=5, ref_profile=prof, tgt_profile=prof,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
    out = tmp_path_factory.mktemp("ingest-kernel")
    paths, truth = write_scene_captures(sc, str(out))
    files = sorted(paths.values())
    return {"paths": paths, "files": files, "truth": truth,
            "batch": _port(max_lag=512).process_files(files)}


def _against_batch(res, kernel_scene):
    batch = kernel_scene["batch"]
    by_pair = {frozenset((batch.station_names[i], batch.station_names[j])):
               (batch.station_names[i], t)
               for (i, j), t in zip(batch.pair_idx,
                                    batch.corrected_tdoa_samples)}
    for (i, j), t in zip(res.pair_idx, res.corrected_tdoa_samples):
        first, want = by_pair[frozenset((res.station_names[i],
                                         res.station_names[j]))]
        want = want if first == res.station_names[i] else -want
        assert abs(t - want) < 0.05, (res.station_names[i],
                                      res.station_names[j], t, want)
    assert _fix_error_m(res.fix) < 150.0
    assert np.all(res.tdoa_std_s > 0)


def test_overlapped_on_kernel_geometry_matches_batch(kernel_scene,
                                                     monkeypatch):
    """Four chunks of two kernel segments over the stacked 9 rows × 9
    pairs (kernel 1's plain version, single bank, DC sums) against the
    fused batch path: 0.05 sample (per-chunk against per-block DC removal
    and the interleaved slots are the differences), fix < 150 m."""
    monkeypatch.setattr(tingest, "DEFAULT_CHUNK_SEGS", 2)
    proc = _port(max_lag=512)
    res = proc.process_files_overlapped(kernel_scene["files"])
    assert proc.ingest_diag["chunk_segs"] == 2
    assert proc.ingest_diag["n_chunks"] == 4
    _against_batch(res, kernel_scene)


def test_tail_on_kernel_geometry_matches_batch(kernel_scene):
    proc = _port(max_lag=512)
    names = sorted(OMAHA["names"])
    views = _views(kernel_scene["paths"], names)
    bl = views[0].shape[0] // 3
    sess = proc.tail_session(names, bl, chunk_samples=2 * K_SEG)
    assert sess._dtype == torch.bfloat16 and sess.total_chunks == 12
    assert _grow(sess, views) >= sess.total_chunks - 2
    caps = {n: HostCapture(u16=v, block_len=bl) for n, v in zip(names, views)}
    _against_batch(proc.process_captures(caps, tail=sess), kernel_scene)


def test_truncated_window_streams_the_analyzed_part(kernel_scene):
    """``truncate_samples``: blocks sit at the files' own block length,
    the analysis covers the first samples of each; overlapped equals the
    batch path under the same truncation (0.05 sample), and the drift
    time base stays the original block length."""
    kw = dict(max_lag=512, truncate_samples=4 * K_SEG + 100)
    batch = _port(**kw).process_files(kernel_scene["files"])
    proc = _port(**kw)
    res = proc.process_files_overlapped(kernel_scene["files"])
    np.testing.assert_allclose(res.corrected_tdoa_samples,
                               batch.corrected_tdoa_samples, atol=0.05)
    np.testing.assert_allclose(res.clock_drift_ppm, batch.clock_drift_ppm,
                               atol=5e-3)
    sess = proc.tail_session(OMAHA["names"], 8 * K_SEG)
    assert sess.block_len == 4 * K_SEG + 100
    assert sess.capture_block_len == 8 * K_SEG


# ---- the command lines ------------------------------------------------

def test_processor_cli_overlap_ingest(small_scene, capsys):
    rc = port_cli.main([*map(str, FREQS), CSV, *small_scene["files"],
                        "--overlap-ingest", "--max-lag", "512", "--seg-len",
                        str(1 << 14), "--device", "cpu", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(
        out["tdoa_us"],
        small_scene["jax_overlapped"].tdoa_seconds * 1e6, atol=0.05 / 2.0)


def _epoch_dir(small_scene, root, epochs):
    root.mkdir()
    for ep in epochs:
        for n, p in small_scene["paths"].items():
            shutil.copy(p, root / f"{n}-{ep}.dat")
    return root


STREAM_ARGS = ["--max-lag", "512", "--seg-len", str(1 << 14), "--device",
               "cpu"]


def test_stream_cli_batch_scan_state_and_jsonl(small_scene, tmp_path, capsys):
    """Two epochs in a directory: one fix line per window, the track
    updated twice, a JSON record per window; a second run with the same
    ``--state`` resumes the track and reprocesses nothing; a third epoch
    then continues it."""
    d = _epoch_dir(small_scene, tmp_path / "caps", (1700000000, 1700000030))
    (d / "stranger-1700000000.dat").write_bytes(b"\x80" * 64)
    state, jsonl = tmp_path / "state.json", tmp_path / "fixes.jsonl"
    args = [*map(str, FREQS), CSV, str(d), *STREAM_ARGS, "--state",
            str(state), "--jsonl", str(jsonl)]
    assert port_stream.main(args) == 0
    io = capsys.readouterr()
    assert io.out.count("epoch 17000000") == 2 and "[2 updates]" in io.out
    assert "skipping stranger-1700000000.dat" in io.err
    recs = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["epoch"] for r in recs] == [1700000000, 1700000030]
    assert abs(recs[0]["fix"]["lat"] - OMAHA["tgt_tx_lla"][0]) < 2e-3
    assert recs[1]["track"]["n_updates"] == 2
    st = json.loads(state.read_text())
    assert st["version"] == 1 and st["processed"] == [1700000000, 1700000030]
    assert st["station_order"] == sorted(OMAHA["names"])
    assert st["tracks"]["target"]["n_updates"] == 2
    assert not list(tmp_path.glob("*.tmp"))  # atomic rewrite left nothing

    assert port_stream.main(args) == 0  # resumed: nothing new to process
    io = capsys.readouterr()
    assert "resumed 1 track(s) / 2 processed epoch(s)" in io.err
    assert "fix" not in io.out
    for n, p in small_scene["paths"].items():
        shutil.copy(p, d / f"{n}-1700000060.dat")
    assert port_stream.main(args + ["--overlap-ingest", "0.19"]) == 0
    io = capsys.readouterr()
    assert "epoch 1700000060" in io.out and "[3 updates]" in io.out
    assert json.loads(state.read_text())["processed"][-1] == 1700000060


def test_stream_cli_refuses_a_state_of_other_stations(small_scene, tmp_path,
                                                      capsys):
    d = _epoch_dir(small_scene, tmp_path / "caps", (1700000000,))
    state = tmp_path / "state.json"
    state.write_text(json.dumps({"version": 1, "station_order": ["zz9"],
                                 "tracks": {}}))
    assert port_stream.main([*map(str, FREQS), CSV, str(d), *STREAM_ARGS,
                             "--state", str(state)]) == 0
    io = capsys.readouterr()
    assert "could not resume --state" in io.err and "starting fresh" in io.err
    assert "[1 updates]" in io.out


def test_stream_cli_watch_tail_ingest(small_scene, tmp_path, capsys):
    """Collectors 'write' the window's files in eight slices while the
    ``--watch --overlap-ingest`` service polls: chunks stream before the
    files close (progress on stderr), the fix comes after, no fallback."""
    watch = tmp_path / "watch"
    watch.mkdir()
    paths, epoch = small_scene["paths"], 1700000000
    duration_s = 3 * (1 << 17) / 2e6

    def writer():
        srcs = {n: np.fromfile(p, dtype=np.uint8) for n, p in paths.items()}
        nbytes = len(next(iter(srcs.values())))
        edges = [nbytes * k // 8 for k in range(9)]
        for a, b in zip(edges, edges[1:]):
            for n in paths:
                with open(watch / f"{n}-{epoch}.dat", "ab") as fh:
                    fh.write(srcs[n][a:b].tobytes())
            time.sleep(0.2)

    t = threading.Thread(target=writer)
    t.start()
    try:
        rc = port_stream.main([
            *map(str, FREQS), CSV, str(watch), *STREAM_ARGS,
            # settle 4x the writer's gap: a mid-write window never looks
            # finished; tail progress keeps the idle clock from expiring
            "--watch", "0.1", "--settle", "0.8",
            "--overlap-ingest", str(duration_s), "--idle-exit", "3"])
    finally:
        t.join(timeout=60)
    assert not t.is_alive()
    io = capsys.readouterr()
    assert rc == 0
    assert "tail-ingest" in io.err and "fell back" not in io.err
    assert "fix" in io.out and "idle for" in io.out


def test_stream_cli_without_captures_or_card(tmp_path, capsys):
    assert port_stream.main(["1", "2", CSV, str(tmp_path), "--device",
                             "cpu"]) == 1
    assert "no usable captures" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        port_stream.main(["1", "2", CSV, str(tmp_path), "--overlap-ingest",
                          "0"])
    if not torch.cuda.is_available():
        (tmp_path / "kx0u-1700000000.dat").write_bytes(b"\x80" * 64)
        assert port_stream.main(["162400000", "2", CSV, str(tmp_path)]) == 2
        assert "no CUDA device" in capsys.readouterr().err


# ---- on the card ------------------------------------------------------

def _synthetic_files(out_dir, n_seg, seed=3):
    """u8 ``.dat`` files of 3 stations × 3 blocks of ``n_seg`` kernel
    segments (numpy only: the card's machine has no simulator): a shared
    wideband source per block, delayed per station, plus noise."""
    rng = np.random.default_rng(seed)
    n, pad = n_seg * K_SEG, 128
    delays = {"ref": [0, -62, 96], "tgt": [0, 40, -42]}
    blocks = {}
    for kind in ("ref1", "tgt", "ref2"):
        src = rng.standard_normal(n + 2 * pad) \
            + 1j * rng.standard_normal(n + 2 * pad)
        blocks[kind] = [src[pad - d:pad - d + n] for d in delays[kind[:3]]]
    files = []
    for s, name in enumerate(OMAHA["names"]):
        parts = []
        for kind in ("ref1", "tgt", "ref2"):
            z = 0.2 * blocks[kind][s] + 0.1 * (
                rng.standard_normal(n) + 1j * rng.standard_normal(n))
            iq = np.stack([z.real, z.imag], -1) * 127.5 + 127.5
            parts.append(np.clip(np.floor(iq + 0.5), 0, 255).astype(np.uint8))
        p = out_dir / f"{name}-1700000000.dat"
        p.write_bytes(np.concatenate(parts).tobytes())
        files.append(str(p))
    return files


@pytest.mark.cuda
def test_cuda_overlapped_matches_cpu_and_never_waits(cuda_sm90, tmp_path,
                                                     monkeypatch):
    """20 segments a block in chunks of 6 (the last one short) on the
    card — pinned buffers, copy stream, kernel 1 once per chunk — against
    the same path on the CPU: corrected TDOAs within 1e-3 samples, σ
    within 1e-3 relative. After that warm-up the streaming loop runs
    under ``set_sync_debug_mode("error")``: no chunk synchronises the
    host with the card, on kernel 1 and on the segmented accumulator
    (``accumulator="xla"``, whose pair list stays on the card)."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import accumulate_banks

    files = _synthetic_files(tmp_path, 20)
    monkeypatch.setattr(tingest, "DEFAULT_CHUNK_SEGS", 6)
    res = {}
    for dev in (cuda_sm90, torch.device("cpu")):
        proc = TDOAProcessor.from_csv(*FREQS, CSV, device=dev, max_lag=512)
        n0 = accumulate_banks.launches
        res[dev.type] = proc.process_files_overlapped(files)
        if dev.type == "cuda":
            assert accumulate_banks.launches == n0 + 4
            assert proc.ingest_diag["transfer_stream_s"] > 0
    np.testing.assert_allclose(res["cuda"].corrected_tdoa_samples,
                               res["cpu"].corrected_tdoa_samples, atol=1e-3)
    np.testing.assert_allclose(res["cuda"].tdoa_std_s, res["cpu"].tdoa_std_s,
                               rtol=1e-3, atol=1e-9)
    views = _views(dict(zip(OMAHA["names"], files)), OMAHA["names"])
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    states = {}
    for acc in ("auto", "xla"):
        # Warm-up outside the check: the pair list's first copy to the
        # card, cuFFT plans.
        tingest.accumulate_overlapped(views, pairs, block_len=20 * K_SEG,
                                      max_lag=512, accumulator=acc,
                                      device=cuda_sm90)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            states[acc], _, _ = tingest.accumulate_overlapped(
                views, pairs, block_len=20 * K_SEG, max_lag=512,
                accumulator=acc, device=cuda_sm90)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert (states["auto"].n_seg, states["auto"].n_chunks) == (20, 4)
    cpu, _, _ = tingest.accumulate_overlapped(
        views, pairs, block_len=20 * K_SEG, max_lag=512, accumulator="xla",
        device=torch.device("cpu"))
    got = states["xla"]
    assert (got.n_seg, got.n_chunks) == (cpu.n_seg, cpu.n_chunks)
    peak = float(cpu.cross.abs().max())
    assert float((got.cross.cpu() - cpu.cross).abs().max()) < 1e-4 * peak


@pytest.mark.cuda
def test_cuda_tail_session_matches_cpu(cuda_sm90, tmp_path):
    files = _synthetic_files(tmp_path, 20, seed=9)
    names = sorted(OMAHA["names"])
    views = _views(dict(zip(OMAHA["names"], files)), names)
    res = {}
    for dev in (cuda_sm90, torch.device("cpu")):
        proc = TDOAProcessor.from_csv(*FREQS, CSV, device=dev, max_lag=512)
        sess = proc.tail_session(names, 20 * K_SEG, chunk_samples=6 * K_SEG)
        assert _grow(sess, views) >= sess.total_chunks - 2
        caps = {n: HostCapture(u16=v, block_len=20 * K_SEG)
                for n, v in zip(names, views)}
        res[dev.type] = proc.process_captures(caps, tail=sess)
    np.testing.assert_allclose(res["cuda"].corrected_tdoa_samples,
                               res["cpu"].corrected_tdoa_samples, atol=1e-3)
    np.testing.assert_allclose(res["cuda"].tdoa_std_s, res["cpu"].tdoa_std_s,
                               rtol=1e-3, atol=1e-9)
