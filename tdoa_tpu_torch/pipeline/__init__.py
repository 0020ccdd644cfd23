from tdoa_tpu_torch.pipeline.processor import (
    ProcessorConfig,
    TDOAProcessor,
    TDOAResult,
    process_blocks,
)
from tdoa_tpu_torch.pipeline.audio_match import (
    AudioMatchResult,
    TemplateMatch,
    match_captures,
    match_template_audio,
    match_template_rf,
    template_iq,
)

__all__ = [
    "ProcessorConfig",
    "TDOAProcessor",
    "TDOAResult",
    "process_blocks",
    "AudioMatchResult",
    "TemplateMatch",
    "match_captures",
    "match_template_audio",
    "match_template_rf",
    "template_iq",
]
