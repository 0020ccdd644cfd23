"""Structural validation of ``.dat`` captures — reader.go capability
(torch port of ``tdoa_tpu.quality.reader``).

Checks (reader.go:37-176 + collector.go:178-248):
- file size consistency with an expected duration/sample-rate;
- exact 3×n block pattern (size divisible by 3 blocks of whole samples);
- per-block power, REF-block power consistency (blocks 1 vs 3 within 2×,
  collector.go:229-248), TGT/REF contrast;
- DC bias and dead-receiver detection;
- dynamic range (min/max byte span).

The three blocks' samples go through the device pass together.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from tdoa_tpu_torch.quality.analyzer import BlockStats, _analyze_rows
from tdoa_tpu_torch.utils.constants import DEFAULT_SAMPLE_RATE, NUM_BLOCKS
from tdoa_tpu_torch.utils.platform import default_device


@dataclasses.dataclass
class StructuralReport:
    path: str
    size_bytes: int
    samples_total: int
    samples_per_block: int
    three_block_pattern_ok: bool
    duration_s: float
    expected_duration_ok: Optional[bool]
    block_stats: List[BlockStats]
    ref_power_consistent: bool  # REF blocks within 2× of each other
    problems: List[str]

    @property
    def ok(self) -> bool:
        return not self.problems


def validate_dat_structure(
    path: str,
    expected_duration_s: Optional[float] = None,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    max_samples_per_block: int = 1 << 20,
    device: Optional[torch.device] = None,
) -> StructuralReport:
    """Validate a capture's structure and per-block signal on ``device``
    (default: the card, an error without one)."""
    dev = default_device() if device is None else torch.device(device)
    problems: List[str] = []
    size = os.path.getsize(path)
    samples_total = size // 2
    per_block = samples_total // NUM_BLOCKS
    pattern_ok = size % (2 * NUM_BLOCKS) == 0 and per_block > 0
    if not pattern_ok:
        problems.append(
            f"size {size} B does not form 3 equal whole-sample blocks"
        )
    duration = samples_total / sample_rate
    dur_ok = None
    if expected_duration_s is not None:
        dur_ok = abs(duration - expected_duration_s) < 0.05 * expected_duration_s
        if not dur_ok:
            problems.append(
                f"duration {duration:.2f}s differs from expected "
                f"{expected_duration_s:.2f}s"
            )

    stats: List[BlockStats] = []
    if size > 0:
        raw = np.memmap(path, dtype=np.uint8, mode="r")
        bpb = per_block * 2  # bytes per block
        take = min(bpb, 2 * max_samples_per_block)
        if take >= 2:  # every block has the same whole-sample length
            stats = _analyze_rows(
                np.stack([raw[b * bpb: b * bpb + take]
                          for b in range(NUM_BLOCKS)]), 8192, dev)
    else:
        problems.append("file is empty")

    ref_ok = True
    if len(stats) == 3:
        p1, p3 = stats[0].power, stats[2].power
        hi, lo = max(p1, p3), max(min(p1, p3), 1e-30)
        ref_ok = hi / lo < 2.0  # collector.go:229-248 consistency heuristic
        if not ref_ok:
            problems.append(
                f"REF blocks power-inconsistent ({p1:.2e} vs {p3:.2e}): "
                f"possible retune glitch"
            )
        for i, s in enumerate(stats):
            if s.is_dead:
                problems.append(f"block {i+1}: dead receiver (no signal)")
            if abs(s.dc_offset_i) > 10 or abs(s.dc_offset_q) > 10:
                problems.append(
                    f"block {i+1}: heavy DC bias "
                    f"(I {s.dc_offset_i:+.1f}, Q {s.dc_offset_q:+.1f})"
                )
            if s.max_byte - s.min_byte < 10:
                problems.append(
                    f"block {i+1}: tiny dynamic range "
                    f"[{s.min_byte}, {s.max_byte}]"
                )

    return StructuralReport(
        path=path,
        size_bytes=size,
        samples_total=samples_total,
        samples_per_block=per_block,
        three_block_pattern_ok=pattern_ok,
        duration_s=duration,
        expected_duration_ok=dur_ok,
        block_stats=stats,
        ref_power_consistent=ref_ok,
        problems=problems,
    )
