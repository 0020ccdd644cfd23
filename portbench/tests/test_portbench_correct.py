"""The check that decides ``correct``, shown to fail: the bfloat16
control in the program's place, and the timed path broken underneath a
run (an answer altered where it is produced, half of the segments left
out of the average, a streaming update that returns its state
unchanged). Each runs the harness's loop on the CPU at 400,000-sample
blocks with the cell's own limits, and ``judge`` must count every
window as failed. Run from the root: ``python -m pytest portbench/tests``.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, spec  # noqa: E402

BENCH = spec.benchmark()
# Each traffic's limits: its omaha3-30s cell's, else its first cell's
# (the overlapped traffic's cell is at 100 s); every run here is the
# omaha3-30s configuration at 400,000-sample blocks.
CELLS: dict = {}
for _w in sorted(BENCH["workloads"], key=lambda w: w["config"] != "omaha3-30s"):
    CELLS.setdefault(_w["traffic"], _w["name"])


def _run(tmp_path, traffic: str, seed: int = 2 ** 32 + 11):
    cfg = spec.config(BENCH, "omaha3-30s")
    cfg["block_samples"] = 400_000
    trf = spec.traffic(traffic)
    dev = torch.device("cpu")
    scenes = harness.make_scenes(cfg, trf, seed, str(tmp_path), dev)
    proc = harness.build_processor(cfg, trf, dev, str(tmp_path))
    _, answers = harness.measure(proc, trf, scenes, 0.0, dev, False,
                                 str(tmp_path), 0.0)
    refs = harness.reference_answers(cfg, trf, scenes, dev)
    limits = spec.limits(CELLS[traffic])["limits"]
    return answers, refs, cfg, scenes, trf, limits


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_control_fails(tmp_path, traffic):
    """The reference in bfloat16 in the program's place reads over the
    limits in every window."""
    _, refs, cfg, scenes, trf, limits = _run(tmp_path, traffic)
    ctl = harness.reference_answers(cfg, trf, scenes, torch.device("cpu"),
                                    "bf16")
    numbers, failed = harness.judge(list(enumerate(ctl)), refs, cfg, limits)
    assert failed == len(ctl), numbers


def _altered(original):
    """clock_correct_blocks with the first pair's corrected TDOA moved by
    0.05 sample: an answer altered where it is produced."""
    def wrapper(*args, **kwargs):
        out = original(*args, **kwargs)
        corrected = out[0].clone()
        corrected[0] += 0.05
        return (corrected,) + tuple(out[1:])
    return wrapper


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_altered_answer_fails(tmp_path, monkeypatch, traffic):
    from tdoa_tpu_torch.pipeline import ingest, processor

    for mod in (processor, ingest):
        monkeypatch.setattr(mod, "clock_correct_blocks",
                            _altered(mod.clock_correct_blocks))
    answers, refs, cfg, *_, limits = _run(tmp_path, traffic)
    _, failed = harness.judge(answers, refs, cfg, limits)
    assert failed == len(answers)


def _half_segments(original, seg: int):
    """The accumulation fed the first half of each block's segments
    twice: half of the average left out, the rest counted in its place."""
    def wrapper(x, *args, **kwargs):
        n_seg = int(x.shape[-1]) // seg
        half = n_seg // 2
        y = x.clone()
        y[..., half * seg:2 * half * seg] = x[..., :half * seg]
        return original(y, *args, **kwargs)
    return wrapper


@pytest.mark.parametrize("traffic", sorted(CELLS))
def test_half_of_the_segments_fails(tmp_path, monkeypatch, traffic):
    from tdoa_tpu_torch.ops import corr
    from tdoa_tpu_torch.ops.kernels import corr_accum

    monkeypatch.setattr(corr_accum, "accumulate_banks_plain", _half_segments(
        corr_accum.accumulate_banks_plain, corr_accum.SEG_LEN))
    if traffic == "fm":
        # The audio's segmented accumulation, per split bank.
        orig = corr._accumulate_cross_spectra

        def acc(x, pair_idx, seg_len, fft_len, scale=None):
            return _half_segments(orig, seg_len)(x, pair_idx, seg_len,
                                                 fft_len, scale)
        monkeypatch.setattr(corr, "_accumulate_cross_spectra", acc)
    answers, refs, cfg, *_, limits = _run(tmp_path, traffic)
    _, failed = harness.judge(answers, refs, cfg, limits)
    assert failed == len(answers)


def test_update_that_keeps_its_state_fails(tmp_path, monkeypatch):
    """The overlapped ingest's streaming accumulator: its first update of
    every window returns the state it was given."""
    from tdoa_tpu_torch.pipeline import ingest

    orig = ingest.acc_update

    def update(state, *args, **kwargs):
        if int(state.n_chunks) == 0:
            return state
        return orig(state, *args, **kwargs)

    monkeypatch.setattr(ingest, "acc_update", update)
    answers, refs, cfg, *_, limits = _run(tmp_path, "overlapped")
    _, failed = harness.judge(answers, refs, cfg, limits)
    assert failed == len(answers)
