"""Process bootstrap, device meshes and the elastic plane on
``torch.distributed``: counterpart of ``tpu_sandbox/runtime/`` (bootstrap,
mesh, the KV store, heartbeats and the watchdog, fault injection, the
single-host supervisor, leader election, the per-host agents and the
cluster scheduler), exported as its ``__init__`` exports them."""

from tpu_sandbox_torch.runtime.bootstrap import (  # noqa: F401
    backend_name,
    cleanup,
    coordinator_address,
    find_free_port,
    init,
    is_initialized,
    process_count,
    process_index,
    topology,
    topology_summary,
)
from tpu_sandbox_torch.runtime.election import (  # noqa: F401
    LeaderInfo,
    LeaseElection,
)
from tpu_sandbox_torch.runtime.faults import (  # noqa: F401
    Fault,
    FaultInjector,
    FaultPlan,
)
from tpu_sandbox_torch.runtime.host_agent import (  # noqa: F401
    AgentConfig,
    AgentLauncher,
    HostAgent,
    ranks_for_agent,
)
from tpu_sandbox_torch.runtime.mesh import make_mesh, submesh  # noqa: F401
from tpu_sandbox_torch.runtime.supervisor import (  # noqa: F401
    PREEMPTED_EXIT_CODE,
    ElasticResult,
    GenerationReport,
    RankGroup,
    RestartBudgetExceeded,
    Supervisor,
)
from tpu_sandbox_torch.runtime.watchdog import (  # noqa: F401
    DeadRankError,
    Heartbeat,
    RendezvousTimeout,
    Watchdog,
    wait_for_world,
)
