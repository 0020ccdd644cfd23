"""FM mode and the segmented correlator end to end: the port's
``process_blocks`` / ``TDOAProcessor`` against ``tdoa_tpu`` on the same
simulated scenes (the JAX simulator), CPU tensors on the port's side.

- FM ``process_blocks`` against a JAX composition of the reference's TPU
  branch (``processor.py:387-468``: the Pallas demod kernel in interpret
  mode per channel, mean removal, ``correlate_pairs_planar`` with plain
  weighting, ``clock_correct_blocks``): corrected TDOAs within 2e-3
  audio samples = 1.6e-2 IQ samples at D = 8, σ within 5 %.
- FM ``process_files``: on the CPU the JAX processor takes its XLA route
  (129 SAME taps, DC removed before the FIR) where the port runs kernel
  3 (causal 128 taps), so the two are held to the truth, within the
  bounds of ``tests/test_pipeline.py::test_e2e_fm_mode`` (16 samples,
  4 km), and to each other within 0.5 IQ sample (measured on this
  scene: 0.090, 0.004 and 0.085 samples on the three pairs, with both
  sides' 1σ at ~24 samples).
- Segmented IQ (``accumulator="xla"``, short blocks, long lags): port
  against JAX, both on the planar path, corrected TDOAs within 2e-3
  samples (f32 operands), σ within 5 %, the same warnings.
"""

import json

import numpy as np
import pytest
import torch

from _torch_port_helpers import cuda_sm90, fm_block, scene  # noqa: F401
from test_torch_pipeline import CSV, OMAHA

try:  # the card's machine has no JAX: there only the `cuda` tests run
    import jax.numpy as jnp
    from tdoa_tpu.ops import corr as jcorr
    from tdoa_tpu.ops.cplx import C
    from tdoa_tpu.ops.pallas.fm_demod import fm_demod_decimate_pallas
    from tdoa_tpu.pipeline import TDOAProcessor as JaxProcessor
    from tdoa_tpu.sim import NoiseProfile, simulate_scene, write_scene_captures
except ModuleNotFoundError:
    pass
from tdoa_tpu_torch.cli import processor as port_cli
from tdoa_tpu_torch.io.datfile import load_dat
from tdoa_tpu_torch.pipeline import TDOAProcessor, process_blocks

FS = 2e6
KEVO = np.array([41.30888549464701, -96.02619229605524, 356.0])
PAIRS = np.array([[0, 1], [0, 2], [1, 2]])
FM_BLOCK = 1 << 17


def _truth_tdoas(res, truth):
    tau = dict(zip(OMAHA["names"], truth.station_delays_samples[:, 1]))
    return np.array([tau[res.station_names[j]] - tau[res.station_names[i]]
                     for i, j in res.pair_idx])


def _fix_error_m(fix, lla):
    from tdoa_tpu_torch.geo import lla_to_enu

    return float(np.linalg.norm(lla_to_enu(
        np.array([fix.lat, fix.lon, lla[2]]), lla)[:2]))


def _fm_scene(block_len=FM_BLOCK):
    return scene({**OMAHA, "tgt_tx_lla": KEVO}, block_len, seed=31,
                 clock_offsets_s=np.array([8e-6, -4e-6, 15e-6]))


@pytest.fixture(scope="module")
def fm_blocks():
    """Three planar f32 blocks [2, 3, L] of the FM scene, the REF
    geometry term, and the JAX TPU branch's demeaned audio [9, L/8]."""
    caps, _ = simulate_scene(_fm_scene())
    blocks = []
    for b in range(3):
        z = np.stack([np.asarray(caps[n][b]) for n in OMAHA["names"]])
        blocks.append(np.stack([z.real, z.imag]).astype(np.float32))
    x = np.concatenate(blocks, axis=1)
    x = x - x.mean(-1, keepdims=True)
    audio = np.stack([
        np.asarray(fm_demod_decimate_pallas(
            C(jnp.asarray(x[0, k]), jnp.asarray(x[1, k])), FS, decim=8,
            interpret=True))
        for k in range(x.shape[1])])
    audio = audio - audio.mean(-1, keepdims=True)
    geo = np.random.default_rng(3).uniform(-40, 40, 3).astype(np.float32)
    return blocks, audio, geo


@pytest.mark.parametrize("seg_len", [None, 1 << 16, 1 << 14],
                         ids=["K0", "K2", "K4"])
def test_fm_process_blocks_matches_tpu_branch(fm_blocks, seg_len):
    blocks, audio, geo = fm_blocks
    max_lag, decim = 512, 8
    max_lag_c = max(max_lag // decim + 2, 16)
    seg_c = None if seg_len is None else max(seg_len // decim, 4 * max_lag_c)
    all_pairs = (PAIRS[None] + np.arange(3)[:, None, None] * 3).reshape(9, 2)
    res = jcorr.correlate_pairs_planar(
        C(jnp.asarray(audio), jnp.zeros_like(jnp.asarray(audio))),
        jnp.asarray(all_pairs, jnp.int32), max_lag=max_lag_c, seg_len=seg_c,
        weighting="none")
    want = jcorr.clock_correct_blocks(
        res.delay.reshape(3, 3) * decim, res.delay_std.reshape(3, 3) * decim,
        res.quality.reshape(3, 3), res.peak_value.reshape(3, 3),
        res.corr.reshape(3, 3, -1), res.corr_re.reshape(3, 3, -1),
        res.corr_im.reshape(3, 3, -1), jnp.asarray(geo), True)
    got = process_blocks(*(torch.from_numpy(b) for b in blocks), PAIRS,
                         torch.from_numpy(geo), max_lag=max_lag,
                         seg_len=seg_len, weighting="ht", mode="fm",
                         fm_decim=decim)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1.6e-2)  # corrected
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1.6e-2)  # REF delays
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                               rtol=0.05)  # corrected σ
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               rtol=1e-3)  # quality


def test_fm_mode_needs_decim_dividing_128(fm_blocks):
    blocks, _, geo = fm_blocks
    with pytest.raises(ValueError, match="divide"):
        process_blocks(*(torch.from_numpy(b) for b in blocks), PAIRS,
                       torch.from_numpy(geo), max_lag=512, mode="fm",
                       fm_decim=6)


def test_unknown_mode_raises(fm_blocks):
    blocks, _, geo = fm_blocks
    with pytest.raises(ValueError, match="unknown processing mode"):
        process_blocks(*(torch.from_numpy(b) for b in blocks), PAIRS,
                       torch.from_numpy(geo), max_lag=512, mode="am")


@pytest.fixture(scope="module")
def fm_files(tmp_path_factory):
    """(jax result, port result, truth, files) of process_files in FM
    mode on one simulated scene."""
    out = tmp_path_factory.mktemp("fm-scene")
    paths, truth = write_scene_captures(_fm_scene(), str(out))
    files = sorted(paths.values())
    kw = dict(max_lag=512, mode="fm", fm_decim=8)
    rj = JaxProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                               **kw).process_files(files)
    rt = TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                                device="cpu", **kw).process_files(files)
    return rj, rt, truth, files


def test_fm_files_within_truth_bounds(fm_files):
    rj, rt, truth, _ = fm_files
    for r in (rj, rt):
        np.testing.assert_allclose(r.corrected_tdoa_samples,
                                   _truth_tdoas(r, truth), atol=16.0)
        assert _fix_error_m(r.fix, KEVO) < 4000.0


def test_fm_files_port_near_jax(fm_files):
    """The XLA demod route (JAX on the CPU) against kernel 3 (the port):
    different FIRs, the same audio delays to within half an IQ sample;
    FM mode runs no lobe-shape or echo-σ accounting on either side."""
    rj, rt, _, _ = fm_files
    assert rt.station_names == rj.station_names
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=0.5)
    assert rt.multipath_flagged is None and rj.multipath_flagged is None
    assert rt.multipath_sigma_samples is None
    assert rj.multipath_sigma_samples is None


def test_cli_fm_json_matches_process_files(fm_files, capsys):
    _, rt, _, files = fm_files
    rc = port_cli.main([str(OMAHA["ref_freq"]), str(OMAHA["tgt_freq"]), CSV,
                        *files, "--max-lag", "512", "--mode", "fm",
                        "--fm-decim", "8", "--device", "cpu", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(out["tdoa_us"], rt.tdoa_seconds * 1e6,
                               atol=1e-9)
    np.testing.assert_allclose(out["raw_delay_samples"],
                               rt.tgt_delay_samples, atol=1e-9)


@pytest.fixture(scope="module")
def xla_files(tmp_path_factory):
    """(jax result, port result) of process_files with
    accumulator="xla" (segmented IQ, 8 segments → K = 4)."""
    prof = NoiseProfile(signal_amplitude=0.3, noise_amplitude=0.15)
    sc = scene({**OMAHA, "tgt_tx_lla": KEVO}, 1 << 18, seed=5,
               ref_profile=prof, tgt_profile=prof,
               clock_offsets_s=np.array([12e-6, -31e-6, 48e-6]))
    out = tmp_path_factory.mktemp("xla-scene")
    paths, truth = write_scene_captures(sc, str(out))
    files = sorted(paths.values())
    rj = JaxProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                               max_lag=512, accumulator="xla"
                               ).process_files(files)
    proc = TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                                  device="cpu", max_lag=512,
                                  accumulator="xla")
    caps = proc.load_files(files)
    rt = proc.process_captures(caps)
    return rj, rt, truth, caps


def _same_results(rt, rj):
    assert rt.station_names == rj.station_names
    np.testing.assert_allclose(rt.corrected_tdoa_samples,
                               rj.corrected_tdoa_samples, atol=2e-3)
    np.testing.assert_allclose(rt.tgt_delay_samples, rj.tgt_delay_samples,
                               atol=2e-3)
    np.testing.assert_allclose(rt.tdoa_std_s, rj.tdoa_std_s, rtol=0.05)
    assert len(rt.warnings) == len(rj.warnings)


def test_xla_accumulator_matches_jax(xla_files):
    rj, rt, truth, _ = xla_files
    _same_results(rt, rj)
    want = _truth_tdoas(rt, truth)
    assert np.all(np.abs(rt.corrected_tdoa_samples - want)
                  < 3 * rt.tdoa_std_s * FS + 0.05)


def test_load_files_decodes_f32_off_the_fused_path(xla_files):
    *_, caps = xla_files
    assert all(b.dtype == torch.float32 for blk in caps.values()
               for b in blk)


@pytest.mark.parametrize("block_len,max_lag", [(40_000, 512),
                                               (1 << 17, 21_000)],
                         ids=["short-blocks", "long-lag"])
def test_auto_routes_to_segmented_and_matches_jax(block_len, max_lag):
    """accumulator="auto" takes the segmented path for blocks shorter
    than one 45056-sample kernel segment and for max_lag beyond the
    kernel's alias-free 20480; both match the JAX planar path."""
    prof = NoiseProfile(signal_amplitude=0.3, noise_amplitude=0.1)
    sc = scene({**OMAHA, "tgt_tx_lla": KEVO}, block_len, seed=9,
               ref_profile=prof, tgt_profile=prof,
               clock_offsets_s=np.array([5e-6, -2e-6, 3e-6]))
    caps, _ = simulate_scene(sc)
    caps = {n: tuple(np.asarray(b) for b in caps[n]) for n in OMAHA["names"]}
    rj = JaxProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                               max_lag=max_lag).process_captures(caps)
    proc = TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV,
                                  device="cpu", max_lag=max_lag)
    assert not proc._fused_eligible(3, block_len)
    _same_results(proc.process_captures(caps), rj)


def test_no_card_means_an_error_unless_cpu_is_asked(monkeypatch, tmp_path,
                                                    capsys):
    """The entry points run on the card by default: with no CUDA device
    visible, construction and load_dat raise, naming device="cpu"."""
    path = tmp_path / "sim-kx0u-1.dat"
    path.write_bytes(np.full(6 * 64, 128, np.uint8).tobytes())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TDOAProcessor.from_csv(OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_dat(str(path))
    assert load_dat(str(path), device="cpu").tgt.device.type == "cpu"
    rc = port_cli.main(["1", "2", CSV, str(path), str(path), str(path)])
    assert rc == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("mode,accumulator", [("fm", "auto"), ("iq", "xla")])
def test_cuda_segmented_paths_match_cpu(cuda_sm90, mode, accumulator):
    """process_captures on the card against the same captures on CPU
    tensors: FM mode launches kernel 3 once (all 9 channels), the
    segmented IQ path launches kernel 2 once and kernel 1 never;
    corrected TDOAs within 1e-3 samples (FM: 1.6e-2), σ within 1e-3
    relative (FM: 1e-2)."""
    from tdoa_tpu_torch.ops.kernels.corr_accum import accumulate_banks
    from tdoa_tpu_torch.ops.kernels.fm_demod import fm_demod_decimate
    from tdoa_tpu_torch.ops.kernels.zoom_probe import loo_zoom_windows

    n = 12 * 45056
    delays = {"ref": [0.0, -62.3, 95.7], "tgt": [0.0, 40.4, -41.6]}
    blocks = [fm_block(3, n, delays[k], seed=s)
              for s, k in enumerate(("ref", "tgt", "ref"))]
    caps = {name: tuple((b[0, st] + 1j * b[1, st]).astype(np.complex64)
                        for b in blocks)
            for st, name in enumerate(OMAHA["names"])}
    res = {}
    counts = {"fm": fm_demod_decimate.launches,
              "zoom": loo_zoom_windows.launches,
              "accum": accumulate_banks.launches}
    for dev in (cuda_sm90, torch.device("cpu")):
        res[dev.type] = TDOAProcessor.from_csv(
            OMAHA["ref_freq"], OMAHA["tgt_freq"], CSV, device=dev,
            max_lag=512, mode=mode, accumulator=accumulator
        ).process_captures(caps)
    assert accumulate_banks.launches == counts["accum"]
    if mode == "fm":
        assert fm_demod_decimate.launches == counts["fm"] + 1
        atol, rtol = 1.6e-2, 1e-2
    else:
        assert fm_demod_decimate.launches == counts["fm"]
        assert loo_zoom_windows.launches == counts["zoom"] + 1
        atol, rtol = 1e-3, 1e-3
    np.testing.assert_allclose(res["cuda"].corrected_tdoa_samples,
                               res["cpu"].corrected_tdoa_samples, atol=atol)
    np.testing.assert_allclose(res["cuda"].tdoa_std_s, res["cpu"].tdoa_std_s,
                               rtol=rtol)


def test_convert_carries_fm_and_segment_settings():
    """seg_len and fm_decim are the port's own settings now: a JAX
    config carries across with them."""
    import dataclasses

    from tdoa_tpu.pipeline import ProcessorConfig as JaxConfig
    from tdoa_tpu_torch import convert

    jcfg = JaxConfig(ref_freq=1.0, tgt_freq=2.0, mode="fm", fm_decim=16,
                     seg_len=1 << 14, accumulator="xla")
    cfg = convert.config_from_fields(dataclasses.asdict(jcfg))
    assert (cfg.mode, cfg.fm_decim, cfg.seg_len, cfg.accumulator) == (
        "fm", 16, 1 << 14, "xla")
    assert not {"seg_len", "fm_decim"} & convert.REFERENCE_ONLY_FIELDS
