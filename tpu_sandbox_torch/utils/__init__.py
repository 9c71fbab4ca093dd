from tpu_sandbox_torch.utils.bridge import (  # noqa: F401
    params_from_flax,
    params_to_flax,
)
from tpu_sandbox_torch.utils.device import exact_fp32, resolve_device  # noqa: F401
