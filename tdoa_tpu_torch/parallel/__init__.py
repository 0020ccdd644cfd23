from tdoa_tpu_torch.parallel.mesh import (
    make_mesh,
    correlate_pairs_sharded,
    process_blocks_sharded,
)

__all__ = ["make_mesh", "correlate_pairs_sharded", "process_blocks_sharded"]
