from tpu_sandbox_torch.data.loader import (  # noqa: F401
    BatchLoader,
    PrefetchLoader,
    ShardedBatchLoader,
)
from tpu_sandbox_torch.data.mnist import (  # noqa: F401
    load_mnist,
    normalize,
    synthetic_mnist,
)
from tpu_sandbox_torch.data.sampler import DistributedSampler  # noqa: F401
