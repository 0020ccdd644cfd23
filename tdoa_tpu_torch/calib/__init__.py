"""Closed-loop gain calibration against a capture backend (``gain.py``)."""

from tdoa_tpu_torch.calib.gain import (
    CalibrationConfig,
    CalibrationResult,
    CaptureBackend,
    SimCaptureBackend,
    calibrate,
    calibrate_frequency,
)

__all__ = [
    "CalibrationConfig",
    "CalibrationResult",
    "CaptureBackend",
    "SimCaptureBackend",
    "calibrate_frequency",
    "calibrate",
]
