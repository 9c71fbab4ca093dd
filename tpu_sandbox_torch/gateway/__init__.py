"""The serving gateway's fleets on the port: one model configuration
served by N replicas under its own KV namespace (``fleet.py``, a copy of
``tpu_sandbox/gateway/fleet.py``). The gateway server, its routing, the
network client and the wire framing are not ported yet."""

from tpu_sandbox_torch.gateway.fleet import (
    DEFAULT_FLEET,
    FleetSpec,
    fleet_kv,
    fleet_namespace,
)

__all__ = [
    "DEFAULT_FLEET",
    "FleetSpec",
    "fleet_kv",
    "fleet_namespace",
]
