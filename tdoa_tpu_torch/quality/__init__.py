"""Capture quality: per-block signal metrics on the device, the
analyzer's verdicts (``analyzer.py``) and structural validation of
``.dat`` files (``reader.py``)."""

from tdoa_tpu_torch.quality.analyzer import (
    BlockStats,
    SignalAnalysis,
    analyze_block_bytes,
    analyze_capture,
    assess_tdoa_suitability,
    compare_signals,
    generate_recommendations,
)
from tdoa_tpu_torch.quality.reader import (
    StructuralReport,
    validate_dat_structure,
)

__all__ = [
    "BlockStats",
    "SignalAnalysis",
    "analyze_block_bytes",
    "analyze_capture",
    "assess_tdoa_suitability",
    "compare_signals",
    "generate_recommendations",
    "StructuralReport",
    "validate_dat_structure",
]
