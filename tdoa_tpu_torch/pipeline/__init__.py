from tdoa_tpu_torch.pipeline.processor import (
    ProcessorConfig,
    TDOAProcessor,
    TDOAResult,
    process_blocks,
)

__all__ = ["ProcessorConfig", "TDOAProcessor", "TDOAResult", "process_blocks"]
