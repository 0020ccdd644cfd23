from tdoa_tpu_torch.utils.constants import (
    DEFAULT_MAX_LAG,
    DEFAULT_SAMPLE_RATE,
    SPEED_OF_LIGHT,
)
from tdoa_tpu_torch.utils.platform import default_device, is_sm90, require_sm90

__all__ = [
    "DEFAULT_MAX_LAG",
    "DEFAULT_SAMPLE_RATE",
    "SPEED_OF_LIGHT",
    "default_device",
    "is_sm90",
    "require_sm90",
]
