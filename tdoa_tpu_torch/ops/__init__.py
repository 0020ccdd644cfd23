from tdoa_tpu_torch.ops.corr import (
    CorrResult,
    clock_correct_blocks,
    correlate_pairs,
    correlate_pairs_fused,
    correlate_pairs_planar,
    correlate_two,
)
from tdoa_tpu_torch.ops.peaks import parabolic_peak, peak_quality

__all__ = [
    "CorrResult",
    "clock_correct_blocks",
    "correlate_pairs",
    "correlate_pairs_fused",
    "correlate_pairs_planar",
    "correlate_two",
    "parabolic_peak",
    "peak_quality",
]
