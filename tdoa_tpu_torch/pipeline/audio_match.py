"""Audio-pattern-matching TDOA: matched-filter each station against the
FM signal a KNOWN audio recording would generate.

Torch port of ``tdoa_tpu.pipeline.audio_match``, the reference's
documented innovation (docs/audio-pattern-matching.md): record the audio
program a transmitter is broadcasting, predict the RF pattern it
generates (``f_inst = f_carrier + k_f·audio``), and search each
station's capture for that pattern. Where the standard pipeline
cross-correlates stations *pairwise* (both sides noisy), the matched
filter correlates each station against a NOISELESS template, and each
station gets an absolute time-of-arrival of the audio content.

Two matching domains:

- ``mode="audio"``: FM-demodulate the station blocks and the template
  through one chain — the stacked ``[2, n_st + 1, L]`` channels go
  through kernel 3 (``ops/kernels/fm_demod.py``) in ONE call on every
  device, the reference's TPU route, then each channel's mean (a
  receiver LO offset) is removed, a robust click limiter clamps the
  audio, and the plain correlator matches each station against the
  template. The FIR's group delay is common to every channel and
  cancels; ``decim`` must divide 128, as for the kernel.
- ``mode="rf"``: correlate the predicted complex-baseband RF pattern
  directly on the CAF surface (``ops/caf.caf_pairs``), searching a
  ±``lo_span_hz`` window per station; the winning Doppler bin is the
  station's LO offset.
- ``mode="auto"`` (default): both, keeping whichever cross-validates
  better against the pairwise baseline (audio on ties), and naming an
  escalation in a warning.

Everything runs on the blocks' device. The template is built there too
(``dsp.filters.resample_fft`` and ``dsp.fm.fm_modulate``): the
reference pins it to the CPU only because its TPU had no FFT.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tdoa_tpu_torch.utils.constants import DEFAULT_SAMPLE_RATE


class TemplateMatch(NamedTuple):
    """Per-station matched-filter result against one template."""

    toa_samples: torch.Tensor  # [n_st] IQ samples the station lags the template
    toa_std: torch.Tensor  # [n_st] 1σ, IQ samples
    quality: torch.Tensor  # [n_st] peak-to-sidelobe ratio
    peak_value: torch.Tensor  # [n_st] normalized correlation peak
    lo_offset_hz: Optional[torch.Tensor] = None  # [n_st] rf mode only
    # rf mode: the LO span actually searched (may be below the request
    # when max_lag forces a segment longer than the span allows).
    lo_span_eff_hz: Optional[float] = None


def template_iq(
    audio: np.ndarray,
    audio_fs: float,
    n_samples: int,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    deviation_hz: float = 25_000.0,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, float]:
    """Predict the complex-baseband FM pattern of an audio recording,
    on the capture clock, exactly ``n_samples`` long: planar f32
    ``[2, n_samples]`` on ``device`` (default: the card).

    Returns ``(template, covered_fraction)`` — the fraction of the
    capture window the recording spans. A shorter recording zero-pads
    (a burst template: the dead tail contributes nothing to the matched
    filter); a longer one truncates to the window.
    """
    from tdoa_tpu_torch.dsp.filters import resample_fft
    from tdoa_tpu_torch.dsp.fm import fm_modulate
    from tdoa_tpu_torch.utils.platform import default_device

    dev = default_device() if device is None else torch.device(device)
    n_res = int(round(len(audio) * sample_rate / audio_fs))
    a = resample_fft(
        torch.as_tensor(np.asarray(audio, np.float32), device=dev), n_res)
    if n_res >= n_samples:
        a = a[:n_samples]
        covered = 1.0
    else:
        covered = n_res / n_samples
    tpl = fm_modulate(a, sample_rate, deviation_hz)
    if n_res < n_samples:
        tpl = torch.nn.functional.pad(tpl, (0, n_samples - n_res))
    return tpl, covered


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median along the last axis, keepdim, that averages the two middle
    values of an even-length row (``jnp.median``'s rule; ``torch.median``
    returns the lower one)."""
    n = int(x.shape[-1])
    lo = torch.kthvalue(x, (n + 1) // 2, dim=-1, keepdim=True).values
    if n % 2:
        return lo
    hi = torch.kthvalue(x, n // 2 + 1, dim=-1, keepdim=True).values
    return (lo + hi) * 0.5


def _with_template(tgt: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Stations ``[2, n_st, L]`` and the template ``[2, L]`` stacked to
    one f32 ``[2, n_st + 1, L]`` signal, each channel demeaned (capture
    DC: the u8 center)."""
    x = torch.cat([tgt, template[:, None]], dim=1).to(torch.float32)
    x -= x.mean(-1, keepdim=True)
    return x


def _template_pairs(n_st: int) -> np.ndarray:
    """Pairs (template, station): positive delay = the station lags the
    template = the station's TOA of the audio content."""
    return np.stack([np.full(n_st, n_st), np.arange(n_st)], axis=1)


def match_template_audio(
    tgt: torch.Tensor,  # [2, n_st, L] planar station blocks
    template: torch.Tensor,  # [2, L] planar predicted RF pattern
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    decim: int = 8,
    max_lag: int = 20000,
    seg_len: Optional[int] = None,
) -> TemplateMatch:
    """Audio-domain matched filter: demodulate stations AND template
    through one chain, correlate each station's audio against the
    template's. TOAs come back in IQ samples (sub-sample refined)."""
    from tdoa_tpu_torch.ops.corr import correlate_pairs_planar
    from tdoa_tpu_torch.ops.kernels.fm_demod import fm_demod_decimate

    n_st = int(tgt.shape[1])
    audio = fm_demod_decimate(_with_template(tgt, template), sample_rate,
                              decim=decim)
    # Receiver LO offset = constant discriminator bias; remove per
    # channel (the kernel leaves DC to the caller).
    audio -= audio.mean(-1, keepdim=True)

    # Robust click limiter: near the FM threshold the discriminator
    # emits impulsive clicks whose amplitude dwarfs the program; they
    # dominate the correlation's energy and drag the peak by samples.
    # Clamp each channel's excursions at 4×(1.4826·MAD) ≈ 4σ of its own
    # robust scale — program audio is untouched, the clean TEMPLATE
    # channel rides through as a no-op, only clicks compress.
    med = _median(audio)
    mad = _median((audio - med).abs())
    lim = 4.0 * 1.4826 * mad.clamp(min=1e-12)
    audio = med + torch.maximum(torch.minimum(audio - med, lim), -lim)
    audio = audio - audio.mean(-1, keepdim=True)

    max_lag_c = max(max_lag // decim + 2, 16)
    seg_c = None if seg_len is None else max(seg_len // decim, 4 * max_lag_c)
    # Plain (power-weighted) correlation, not GCC whitening: demodulated
    # audio occupies only the bottom of the decimated band, and whitening
    # hands the empty bins' common edge-leakage the vote.
    res = correlate_pairs_planar(
        torch.stack([audio, torch.zeros_like(audio)]), _template_pairs(n_st),
        max_lag=max_lag_c, seg_len=seg_c, weighting="none")
    s = float(decim)
    return TemplateMatch(
        toa_samples=res.delay * s,
        toa_std=res.delay_std * s,
        quality=res.quality,
        peak_value=res.peak_value,
    )


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def rf_segment(max_lag: int, lo_span_hz: float,
               sample_rate: float = DEFAULT_SAMPLE_RATE) -> Tuple[int, float]:
    """The rf domain's CAF segment and the LO span it can search:
    ``(seg_len, span_eff_hz)``.

    Slow-time Doppler steering is unambiguous over ±fs/(2·seg): the
    segment is sized so the requested span fits, within [2^10, 2^15] —
    but the CAF also needs seg_len > max_lag (the lag window must fit
    one segment), and the lag requirement wins: raw TOAs include the
    stations' clock offsets (up to ms ⇒ max_lag 20000 by default), while
    an LO span clipped below the request degrades gracefully (the caller
    warns; aliasing beyond the span only costs coherence)."""
    min_seg = 1 << 10
    while min_seg <= max_lag:
        min_seg <<= 1
    seg_len = max(
        min_seg,
        min(1 << 15,
            max(1 << 10,
                _pow2_at_most(int(sample_rate / (2.0 * lo_span_hz))))),
    )
    return seg_len, min(lo_span_hz, sample_rate / (2.0 * seg_len))


def match_template_rf(
    tgt: torch.Tensor,  # [2, n_st, L]
    template: torch.Tensor,  # [2, L]
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    max_lag: int = 20000,
    lo_span_hz: float = 200.0,
    n_doppler: int = 64,
    seg_len: Optional[int] = None,
) -> TemplateMatch:
    """RF-domain matched filter with per-station LO-offset search.

    A receiver LO error of Δf rotates the station against the template
    by 2πΔf·t — fatal to a coherent matched filter over seconds — so
    the match runs on the CAF surface over ±``lo_span_hz``. The winning
    Doppler bin IS the station's LO offset (sub-bin refined).
    """
    from tdoa_tpu_torch.ops.caf import caf_pairs

    n_st = int(tgt.shape[1])
    x = _with_template(tgt, template)
    if seg_len is None:
        seg_len, span_eff = rf_segment(max_lag, lo_span_hz, sample_rate)
    else:
        span_eff = min(lo_span_hz, sample_rate / (2.0 * seg_len))
    # weighting="none": the template side is noiseless, so the plain
    # cross-power IS the optimal matched filter.
    res = caf_pairs(
        x, _template_pairs(n_st), sample_rate=sample_rate,
        max_lag=max_lag, seg_len=seg_len, n_doppler=n_doppler,
        doppler_span_hz=span_eff, weighting="none",
    )
    del x
    # Peak-to-sidelobe quality on the winning Doppler row, peak
    # neighborhood excluded — same PSR convention as the GCC path.
    surf = res.surface  # [n_st, D, W]
    di = surf.amax(-1).argmax(-1)  # [n_st]
    row = surf[torch.arange(n_st, device=surf.device), di]  # [n_st, W]
    w = row.shape[-1]
    k = row.argmax(-1)
    lag_idx = torch.arange(w, device=row.device)[None, :]
    guard = (lag_idx - k[:, None]).abs() > 8
    side = torch.where(guard, row, torch.zeros_like(row))
    rms_side = torch.sqrt(
        (side ** 2).sum(-1) / guard.sum(-1).clamp(min=1).to(row.dtype))
    peak = row.amax(-1)
    quality = peak / rms_side.clamp(min=1e-30)
    # σ proxy: lag-bin / PSR (empirically conservative on the surface).
    toa_std = 1.0 / quality.clamp(min=1.0)
    return TemplateMatch(
        toa_samples=res.delay,
        toa_std=toa_std,
        quality=quality,
        peak_value=peak,
        lo_offset_hz=res.doppler_hz,
        lo_span_eff_hz=float(span_eff),
    )


@dataclasses.dataclass
class AudioMatchResult:
    """Template-matched TDOA result, with the standard pairwise result
    riding along for cross-validation."""

    station_names: List[str]
    pair_idx: np.ndarray  # [m, 2]
    toa_samples: np.ndarray  # [n] per-station template TOA, IQ samples
    toa_std_samples: np.ndarray  # [n]
    station_quality: np.ndarray  # [n] matched-filter PSR
    template_tdoa_samples: np.ndarray  # [m] raw TOA differences
    corrected_tdoa_samples: np.ndarray  # [m] after dual-REF clock removal
    tdoa_seconds: np.ndarray  # [m]
    tdoa_std_s: np.ndarray  # [m]
    fix: "FixResult"  # noqa: F821 — solve.multilateration.FixResult
    pairwise: "TDOAResult"  # noqa: F821 — the standard pipeline's result
    covered_fraction: float  # of the TGT window the recording spans
    lo_offset_hz: Optional[np.ndarray] = None  # [n] rf mode
    warnings: List[str] = dataclasses.field(default_factory=list)
    # The matching domain that produced this result ("audio"/"rf") —
    # informative under mode="auto", which may escalate.
    mode_used: str = "audio"


def cross_validation_warnings(
    corrected: np.ndarray,  # [m] template clock-corrected TDOAs, samples
    sigma: np.ndarray,  # [m] template per-pair 1σ, samples
    pairwise,  # TDOAResult — the standard pipeline's result
    fix,  # FixResult from the template TDOAs
    names: Sequence[str],
    pairs: np.ndarray,
    fs: float,
) -> List[str]:
    """Template-vs-pairwise cross-validation (the doc's validation
    ladder): disagreement is a warning, not an error — the operator
    decides which measurement to trust. Two rungs:

    1. Per-pair: |pairwise − template| against the COMBINED σ
       (template ⊕ pairwise). Gating on the template σ alone at a
       slack multiple let a 3.6σ disagreement — a 12-sample template
       error and a 2 km bad fix — pass silently (Monte Carlo seed
       21908). Floor 3.0 samples keeps clean captures quiet
       (agreement there is sub-sample).
    2. Fix separation: the two fixes must agree within 3σ of their
       combined error ellipses. Per-pair tails can each sit just under
       rung 1 while their joint effect moves the fix kilometers; the
       separation catches that accumulation directly. Floor 50 m.
    """
    return _cross_validation(
        corrected, sigma, pairwise, fix, names, pairs, fs
    )[0]


def _cross_validation(
    corrected: np.ndarray,
    sigma: np.ndarray,
    pairwise,
    fix,
    names: Sequence[str],
    pairs: np.ndarray,
    fs: float,
) -> Tuple[List[str], Tuple[float, int]]:
    """Cross-validation warnings plus a comparable badness score
    ``(worst_normalized_disagreement, rungs_fired)`` — mode="auto"
    ranks the audio- and rf-domain candidates by it (smaller wins,
    lexicographic). The continuous magnitude leads: a candidate whose
    worst pair sits 60x over the gate must lose to one 1.2x over it
    even if the latter trips a rung on more pairs."""
    out: List[str] = []
    pw = np.asarray(pairwise.corrected_tdoa_samples, np.float64)
    pw_sig = (
        np.asarray(pairwise.tdoa_std_s, np.float64) * fs
        if pairwise.tdoa_std_s is not None
        else np.zeros_like(pw)
    )
    disagree = np.abs(pw - corrected)
    comb = np.sqrt(np.asarray(sigma, np.float64) ** 2 + pw_sig**2)
    # Badness normalizes by a scale COMMON to every candidate — the
    # pairwise baseline's σ with the absolute floor, NOT the combined σ
    # the warning gate uses. Normalizing by each candidate's own σ
    # would let a sloppy candidate shrink its own score: the audio
    # domain's inflated σs under FM-threshold noise out-scored the
    # accurate rf match exactly when escalation mattered (seed 31308).
    worst_norm = float(
        np.max(disagree / np.maximum(3.0, 3.5 * pw_sig), initial=0.0)
    )
    bad = disagree > np.maximum(3.0, 3.5 * comb)
    if bad.any():
        worst = int(np.argmax(disagree / np.maximum(comb, 1e-9)))
        i, j = pairs[worst]
        out.append(
            f"template and pairwise TDOAs disagree on {int(bad.sum())} "
            f"pair(s); worst {names[i]}-{names[j]}: "
            f"{disagree[worst]:.2f} samples "
            f"({disagree[worst] / max(comb[worst], 1e-9):.1f}σ combined)"
        )

    if (
        fix.ellipse is not None
        and pairwise.fix.ellipse is not None
        and np.isfinite([fix.lat, fix.lon,
                         pairwise.fix.lat, pairwise.fix.lon]).all()
    ):
        from tdoa_tpu_torch.geo import lla_to_enu

        sep = float(np.linalg.norm(lla_to_enu(
            np.array([fix.lat, fix.lon, pairwise.fix.elev]),
            np.array([pairwise.fix.lat, pairwise.fix.lon,
                      pairwise.fix.elev]),
        )[:2]))
        allow = 3.0 * (fix.ellipse[0] + pairwise.fix.ellipse[0])
        # Score side: pairwise-only scale (common across candidates).
        worst_norm = max(
            worst_norm,
            sep / max(3.0 * pairwise.fix.ellipse[0], 50.0),
        )
        if sep > max(allow, 50.0):
            out.append(
                f"template fix and pairwise fix are {sep:.0f} m apart "
                f"(vs {allow:.0f} m at 3σ of the combined ellipses) — "
                "one of the two measurements is biased; compare "
                "per-pair TDOAs and the match quality before trusting "
                "either"
            )
    return out, (worst_norm, len(out))


def match_captures(
    processor,  # TDOAProcessor
    captures: Dict[str, Tuple],
    audio: np.ndarray,
    audio_fs: float,
    mode: str = "auto",
    deviation_hz: float = 25_000.0,
    decim: int = 8,
    lo_span_hz: float = 200.0,
    n_doppler: int = 64,
) -> AudioMatchResult:
    """Full audio-pattern-matching run on in-memory captures
    ({station: (ref1, tgt, ref2)}: planar ``[2, L]`` tensors of any
    float dtype, as ``load_files`` gives them, or complex arrays), on the
    processor's device.

    1. the standard pairwise pipeline runs first — its dual-REF clock
       offsets calibrate the template TOAs, and its fix is the
       cross-validation baseline;
    2. the recording becomes a predicted RF template on the capture
       clock (:func:`template_iq`);
    3. each station's TGT block is matched against the template
       (``mode="audio"``, ``"rf"``, or ``"auto"`` — both, ranked by
       validation);
    4. TOA differences − clock offsets → corrected TDOAs → fix.

    With a ``processor.timer``, the stages "pairwise", "template",
    "audio domain", "rf domain" and "assemble/solve" are timed.
    """
    from tdoa_tpu_torch.pipeline.processor import HostCapture, _planar
    from tdoa_tpu_torch.solve.multilateration import solve_fix

    if mode not in ("audio", "rf", "auto"):
        raise ValueError(
            f"mode must be 'audio', 'rf' or 'auto', got {mode!r}"
        )
    if any(isinstance(c, HostCapture) for c in captures.values()):
        raise ValueError(
            "audio matching needs the TGT blocks in memory; HostCapture "
            "handles (the overlapped ingest) are not accepted — load the "
            "files with load_files"
        )
    cfg = processor.config
    stage = (processor.timer.stage if processor.timer is not None
             else lambda name: contextlib.nullcontext())
    with stage("pairwise"):
        pairwise = processor.process_captures(captures)
    names = pairwise.station_names
    pairs = pairwise.pair_idx

    def prep(b) -> torch.Tensor:
        b = _planar(b, processor.device).to(torch.float32)
        if cfg.truncate_samples is not None:
            b = b[:, :cfg.truncate_samples]
        return b

    with stage("template"):
        tgt = torch.stack([prep(captures[n][1]) for n in names], dim=1)
        L = int(tgt.shape[-1])
        tpl, covered = template_iq(
            audio, audio_fs, L, sample_rate=cfg.sample_rate,
            deviation_hz=deviation_hz, device=processor.device,
        )

    base_warnings: List[str] = []
    if covered < 0.5:
        base_warnings.append(
            f"audio recording spans only {covered:.0%} of the target "
            "window — matched-filter SNR is reduced accordingly"
        )
    fs = cfg.sample_rate
    lla = processor.stations.lla_array(names)

    def run_domain(domain: str) -> Tuple[TemplateMatch, List[str]]:
        if domain == "audio":
            with stage("audio domain"):
                return match_template_audio(
                    tgt, tpl, sample_rate=fs, decim=decim,
                    max_lag=cfg.max_lag, seg_len=cfg.seg_len,
                ), []
        with stage("rf domain"):
            m = match_template_rf(
                tgt, tpl, sample_rate=fs, max_lag=cfg.max_lag,
                lo_span_hz=lo_span_hz, n_doppler=n_doppler,
            )
        extra: List[str] = []
        if (m.lo_span_eff_hz is not None
                and m.lo_span_eff_hz < 0.99 * lo_span_hz):
            extra.append(
                f"rf-mode LO search span clipped to "
                f"±{m.lo_span_eff_hz:.1f} Hz (requested "
                f"±{lo_span_hz:.1f}): max_lag {cfg.max_lag} forces a "
                f"segment longer than the span allows — an LO offset "
                f"beyond the clipped span aliases (costing coherence); "
                f"lower --max-lag if clocks permit, or use "
                f"--match-mode audio (LO-immune)"
            )
        return m, extra

    def host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
        return None if t is None else t.cpu().numpy().astype(np.float64)

    def assemble(
        domain: str, m: TemplateMatch, extra: List[str]
    ) -> Tuple[AudioMatchResult, Tuple[float, int], bool]:
        toa, toa_std, q = host(m.toa_samples), host(m.toa_std), host(m.quality)
        warnings = list(base_warnings) + list(extra)

        low_q = [names[i] for i in range(len(names)) if q[i] < 3.0]
        if low_q:
            warnings.append(
                "weak template match (peak-to-sidelobe < 3) at: "
                + ", ".join(low_q)
                + " — check the recording covers the capture window and "
                "the station actually received the target"
            )

        raw = toa[pairs[:, 1]] - toa[pairs[:, 0]]
        clock = np.asarray(pairwise.clock_offset_samples, np.float64)
        corrected = raw - clock
        # Matched-filter σ per pair; the dual-REF clock correction's REF
        # variance is not stored separately, so propagate the template
        # σs and let the solver's residual scale absorb the clock term.
        sigma = np.sqrt(
            toa_std[pairs[:, 0]] ** 2 + toa_std[pairs[:, 1]] ** 2
        )
        # Pair weight: limited by its weaker station, quadratic like
        # the pairwise solve's quality weighting.
        pq = np.minimum(q[pairs[:, 0]], q[pairs[:, 1]])
        wmax = max(pq.max(), 1e-9)
        weights = (pq / wmax) ** 2

        fix = solve_fix(
            lla, corrected / fs, weights=weights, pair_idx=pairs,
            solve_z=cfg.solve_z, tdoa_sigma_s=sigma / fs,
            device=processor.device,
        )
        val_warns, score = _cross_validation(
            corrected, sigma, pairwise, fix, names, pairs, fs
        )
        warnings.extend(val_warns)
        # Escalation trigger (auto mode): a validation rung fired, or
        # any station's match is shaky (PSR < 6: the measured
        # FM-threshold wrong-peaks scored 2.8-4.3, healthy matches 8+).
        trouble = score[1] > 0 or bool((q < 6.0).any())
        res = AudioMatchResult(
            station_names=names,
            pair_idx=pairs,
            toa_samples=toa,
            toa_std_samples=toa_std,
            station_quality=q,
            template_tdoa_samples=raw,
            corrected_tdoa_samples=corrected,
            tdoa_seconds=corrected / fs,
            tdoa_std_s=sigma / fs,
            fix=fix,
            pairwise=pairwise,
            covered_fraction=covered,
            lo_offset_hz=host(m.lo_offset_hz),
            warnings=warnings,
            mode_used=domain,
        )
        return res, score, trouble

    if mode in ("audio", "rf"):
        m, extra = run_domain(mode)
        with stage("assemble/solve"):
            return assemble(mode, m, extra)[0]

    # mode="auto": run BOTH domains and keep the better-validating one
    # (a near-threshold audio match can carry a multi-sample bias while
    # every gate stays green; the rf pass is cheap against the capture
    # cadence). Ties (both clean) keep the audio result — LO-immune and
    # the sharper estimator when healthy.
    m_a, ex_a = run_domain("audio")
    with stage("assemble/solve"):
        res_a, score_a, trouble = assemble("audio", m_a, ex_a)
    m_r, ex_r = run_domain("rf")
    with stage("assemble/solve"):
        res_r, score_r, _ = assemble("rf", m_r, ex_r)
    use_rf = (score_r < score_a if trouble else
              # Audio passed its gates: switch only on a decisive rf
              # advantage, so baseline-noise coin flips don't discard
              # the healthy audio match.
              score_r[0] < 0.5 * score_a[0] and score_a[0] > 0.5)
    chosen = res_r if use_rf else res_a

    def _desc(s: Tuple[float, int]) -> str:
        return f"{s[1]} validation rung(s), worst {s[0]:.2f}x gate"

    if use_rf or trouble:
        chosen.warnings.insert(
            0,
            "auto mode: "
            + ("the audio-domain match looked unreliable"
               if trouble else
               "the rf-domain match cross-validated decisively better")
            + f" ({_desc(score_a)}; min station PSR "
            f"{float(res_a.station_quality.min()):.1f}) — escalated to "
            f"the rf-domain matched filter ({_desc(score_r)}) and kept "
            f"the {'rf' if use_rf else 'audio'} result",
        )
    return chosen
