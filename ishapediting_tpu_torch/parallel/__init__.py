from ishapediting_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
)
from ishapediting_tpu_torch.parallel.sampling import sample_sharded  # noqa: F401
from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded  # noqa: F401
