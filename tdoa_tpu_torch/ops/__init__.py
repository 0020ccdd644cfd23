from tdoa_tpu_torch.ops.corr import (
    CorrResult,
    clock_correct_blocks,
    correlate_pairs_fused,
)
from tdoa_tpu_torch.ops.peaks import parabolic_peak, peak_quality

__all__ = [
    "CorrResult",
    "clock_correct_blocks",
    "correlate_pairs_fused",
    "parabolic_peak",
    "peak_quality",
]
