from ishapediting_tpu_torch.parallel.mesh import (  # noqa: F401
    gather_mesh,
    make_mesh,
    replicate,
    shard_batch,
)
from ishapediting_tpu_torch.parallel.tensor import shard_params_tp  # noqa: F401
from ishapediting_tpu_torch.parallel.sampling import sample_sharded  # noqa: F401
from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded  # noqa: F401
