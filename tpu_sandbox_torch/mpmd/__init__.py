"""MPMD cross-mesh pipeline: per-stage programs, stage transport, 1F1B and
ZB-H1. Counterpart of ``tpu_sandbox/mpmd/``, with the same exports.

The SPMD pipeline in ``parallel/pipeline.py`` is one program over a mesh.
This package is the "many cooperating meshes" shape: each stage runs only
its own programs (``program.py``); activations and cotangents ship
between stages over a :class:`~tpu_sandbox_torch.mpmd.transport.Transport`;
a leader-published schedule (``schedule.py``) coordinates microbatch
dispatch; ``driver.py`` runs the stages as threads of one process and
``worker.py`` as processes under the cluster scheduler.
"""

from tpu_sandbox_torch.mpmd.transport import (  # noqa: F401
    KVTransport,
    LocalTransport,
    Transport,
    TransportStats,
    pack_arrays,
    unpack_arrays,
)
from tpu_sandbox_torch.mpmd.program import (  # noqa: F401
    StageProgram,
    merge_stage_params,
    stage_params,
)
from tpu_sandbox_torch.mpmd.schedule import (  # noqa: F401
    bubble_fraction,
    one_f_one_b,
)
from tpu_sandbox_torch.mpmd.driver import MPMDPipeline, StageWorker  # noqa: F401
