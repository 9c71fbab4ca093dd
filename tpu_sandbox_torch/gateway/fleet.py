"""Multi-model tenancy: several model fleets behind one gateway. The
port's copy of ``tpu_sandbox/gateway/fleet.py`` (the fleet namespaces and
the fleet's replica jobs).

A *fleet* is one model configuration served by N replicas. Fleets share
one KV store and one host pool but never each other's keys: every fleet's
serve-protocol keys (queues, leases, verdicts, load reports) live under
``fleet/<name>/`` via the same :class:`NamespacedKV` mechanism that
isolates cluster jobs under ``job/<id>/``. The serve layer writes only
relative keys, so namespacing is free — a replica started with
``--fleet chat`` and a gateway routing fleet ``chat`` agree on the prefix
and everything below them is unchanged.

The host pool is divided by the scheduler's weighted fair share: each
fleet's replica jobs carry ``tenant=<fleet>`` and the fleet's ``share``,
so pool pressure between fleets resolves by accumulated normalized
service, not by who submitted first.

The default fleet (empty name) is the bare-prefix serve namespace —
single-fleet deployments keep the exact key schema the serve stack has
always had, bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpu_sandbox_torch.runtime.kvstore import KVClient, NamespacedKV
from tpu_sandbox_torch.runtime.scheduler import JobSpec

DEFAULT_FLEET = ""


def fleet_namespace(name: str) -> str:
    """Key prefix for one fleet: '' for the default, ``fleet/<name>/``
    otherwise. Same character discipline as job ids — '/' and whitespace
    are reserved so namespace sweeps can never cross fleets."""
    if not name:
        return ""
    if any(c in name for c in "/ \t\n\r"):
        raise ValueError(f"invalid fleet name {name!r}: '/' and whitespace "
                         "are reserved (namespace sweeps must stay scoped)")
    return f"fleet/{name}/"


def fleet_kv(kv: "KVClient | NamespacedKV", name: str):
    """A view of ``kv`` scoped to one fleet's serve namespace. The default
    fleet gets the client back unchanged; nesting views is a programming
    error (a fleet lives at the top of the store, not inside a job)."""
    ns = fleet_namespace(name)
    if not ns:
        return kv
    if isinstance(kv, NamespacedKV):
        raise ValueError("refusing to nest fleet namespaces: "
                         f"{kv.prefix!r} + {ns!r}")
    return NamespacedKV(kv, ns)


@dataclass(frozen=True)
class FleetSpec:
    """One model tier: its serve namespace, routing/admission calibration,
    and its claim on the shared host pool."""

    name: str = DEFAULT_FLEET
    #: allocator block size — the gateway must hash request chains with the
    #: SAME block size the fleet's replicas allocate with, or no digest
    #: entry can ever match
    block_size: int = 8
    #: calibrated per-replica service rate (requests/s) feeding the
    #: feasibility estimate; measure with a closed-loop run
    service_rate_rps: float = 10.0
    #: occupancy-mode door bound (requests known queued on the replica)
    occupancy_bound: int = 8
    #: scheduler weighted-fair-share weight for this fleet's replica jobs
    share: float = 1.0
    priority: int = 0
    #: extra CLI args appended to every replica's serve command (model
    #: size, batch/cache shape — whatever distinguishes this tier)
    replica_args: list[str] = field(default_factory=list)

    def __post_init__(self):
        fleet_namespace(self.name)  # validate eagerly, not at first use

    def replica_job_specs(self, *, replicas: int,
                          base_priority: int = 0) -> list[JobSpec]:
        """Scheduler jobs for this fleet's replica gang: one single-host
        job per replica (replicas are independent failure domains; a gang
        of one preempts and requeues without dragging siblings down).
        Job ids are ``serve-<fleet>-<n>``; the fleet namespace rides in
        the environment, not the argv, so the template stays uniform."""
        name = self.name or "default"
        env = {"TPU_SANDBOX_FLEET": self.name} if self.name else {}
        return [
            JobSpec(
                job_id=f"serve-{name}-{i}",
                hosts=1,
                world_size=1,
                agent_argv=[
                    "python", "-m", "tpu_sandbox_torch.serve.replica",
                    "--kv-port", "{kv_port}",
                    "--tag", f"{name}-{i}",
                    *self.replica_args,
                ],
                priority=base_priority + self.priority,
                env=env,
                tenant=f"fleet-{name}",
                share=self.share,
            )
            for i in range(replicas)
        ]
