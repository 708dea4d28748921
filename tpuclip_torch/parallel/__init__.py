from tpuclip_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    maybe_distributed_init,
)
from tpuclip_torch.parallel.sharded_ivf import shard_ivf, sharded_ivf_search  # noqa: F401
from tpuclip_torch.parallel.sharded_search import ShardedIndex, sharded_topk  # noqa: F401
from tpuclip_torch.parallel.sharding import param_shardings, shard_params  # noqa: F401
from tpuclip_torch.parallel.tensor_parallel import shard_layout, to_tensor_parallel  # noqa: F401
