from tdoa_tpu_torch.sim.delay import apply_channel, fractional_delay
from tdoa_tpu_torch.sim.source import bandlimited_noise, fm_source, tone_source
from tdoa_tpu_torch.sim.scene import (
    IDEAL_PROFILE,
    STRONG_TGT_PROFILE,
    WEAK_REF_PROFILE,
    NoiseProfile,
    SimScene,
    simulate_scene,
    write_scene_captures,
)

__all__ = [
    "fractional_delay",
    "apply_channel",
    "fm_source",
    "tone_source",
    "bandlimited_noise",
    "SimScene",
    "NoiseProfile",
    "simulate_scene",
    "write_scene_captures",
    "IDEAL_PROFILE",
    "WEAK_REF_PROFILE",
    "STRONG_TGT_PROFILE",
]
