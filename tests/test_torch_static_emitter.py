"""``chip_smoke.py`` phase 6's scene (b) (a 130 m/s mover and an
equal-power static interferer, made by the smoke's own synthesizer on
the CPU with 2^20-sample blocks) through both processors at phase 6's
checked settings (velocity + 2 emitters, max_lag 512, a CAF over 2^18
samples), at the smoke's seed and five more: on each input the two
packages find the same emitters, their TDOAs within 5e-3 samples and
their fixes within 1 m of each other, on the same side of phase 6's
1000 m bound on the static emitter.

The readings (each seed's static-emitter and mover fix errors in both
packages) print with ``pytest -s tests/test_torch_static_emitter.py
tests/test_torch_window_paths.py -k static_emitter``.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
STATIC_BOUND_M = 1000.0  # chip_smoke._check_joint's bound on the static fix


def static_readings(monkeypatch, tmp_path, seed_offset: int):
    """{"port" | "jax": (static emitter, its fix error m, the mover's fix
    error m)} for phase 6's scene (b) at ``chip_smoke.SEED +
    seed_offset`` on 2^20-sample blocks, after holding the two packages'
    emitters to each other."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from tdoa_tpu.pipeline import TDOAProcessor as JProcessor
    from tdoa_tpu_torch.pipeline import TDOAProcessor

    monkeypatch.setattr(cs, "SEED", cs.SEED + seed_offset)
    files, truth = cs._synthesize("cpu", tmp_path, prefix="m",
                                  mover_enu=cs.MOVER_ENU,
                                  interferer_lla=cs.INTERFERER_LLA,
                                  block=1 << 20)
    cfg = {**cs.VEL_ME, **cs.CHECKED, "accumulator": "xla"}
    csv = str(REPO / "lat-lon-table.csv")
    results = {
        "port": TDOAProcessor.from_csv(cs.REF_FREQ, cs.TGT_FREQ, csv,
                                       device="cpu",
                                       **cfg).process_files(files),
        "jax": JProcessor.from_csv(cs.REF_FREQ, cs.TGT_FREQ, csv,
                                   **cfg).process_files(files),
    }
    assert len(results["port"].emitters) == len(results["jax"].emitters) == 2
    out = {}
    for name, res in results.items():
        static = min(res.emitters,
                     key=lambda e: cs._fix_err_m(e.fix, truth["int_lla"]))
        mover = min(res.emitters,
                    key=lambda e: cs._fix_err_m(e.fix, truth["tgt_lla"]))
        out[name] = (static, cs._fix_err_m(static.fix, truth["int_lla"]),
                     cs._fix_err_m(mover.fix, truth["tgt_lla"]))
    np.testing.assert_allclose(out["port"][0].tdoa_samples,
                               out["jax"][0].tdoa_samples, atol=5e-3)
    assert abs(out["port"][1] - out["jax"][1]) < 1.0
    assert abs(out["port"][2] - out["jax"][2]) < 1.0
    print(f"\nphase 6 (b), seed {cs.SEED} (SEED + {seed_offset}), 2^20-sample "
          f"blocks: static emitter {out['port'][1]:.1f} m (port), "
          f"{out['jax'][1]:.1f} m (jax), bound {STATIC_BOUND_M:.0f} m; mover "
          f"{out['port'][2]:.1f} m (port), {out['jax'][2]:.1f} m (jax)")
    return out


@pytest.mark.parametrize("seed_offset", [0, 1, 3, 4, 5])
def test_phase6b_static_emitter_is_the_same_in_both_packages(
        monkeypatch, tmp_path, seed_offset):
    """The smoke's own seed (offset 0) and four more (offset 2 is
    ``test_torch_window_paths``' case): both packages give the same
    static and mover fixes to the metre, on the same side of the 1000 m
    bound."""
    out = static_readings(monkeypatch, tmp_path, seed_offset)
    assert (out["port"][1] > STATIC_BOUND_M) == (out["jax"][1]
                                                 > STATIC_BOUND_M)
