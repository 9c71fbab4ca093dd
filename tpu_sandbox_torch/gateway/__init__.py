"""Network serving gateway of the port: the fleet's front door. Copies of
``tpu_sandbox/gateway/``'s modules, with its exports.

External clients connect here over TCP (``wire`` framing, shared-secret
hello) instead of holding KV-store credentials; the gateway routes each
request to the replica with the deepest resident prefix match
(``routing``), refuses requests that provably cannot make their deadline
(SLO-feasibility admission), and serves several model fleets from one
endpoint (``fleet`` namespacing). See gateway/server.py for the full
design narrative. ``python -m tpu_sandbox_torch.gateway`` runs one.
"""

from tpu_sandbox_torch.gateway.client import (GatewayAuthError,
                                              GatewayClient, GatewayError)
from tpu_sandbox_torch.gateway.fleet import (DEFAULT_FLEET, FleetSpec,
                                             fleet_kv, fleet_namespace)
from tpu_sandbox_torch.gateway.routing import (ReplicaView, admit, choose,
                                               feasible, fresh, match_depth,
                                               parse_report)
from tpu_sandbox_torch.gateway.server import (Gateway, GatewayStats,
                                              live_gateway_endpoints,
                                              live_gateways)
from tpu_sandbox_torch.gateway.wire import (make_client_ssl_context,
                                            make_server_ssl_context)

__all__ = [
    "DEFAULT_FLEET",
    "FleetSpec",
    "Gateway",
    "GatewayAuthError",
    "GatewayClient",
    "GatewayError",
    "GatewayStats",
    "ReplicaView",
    "admit",
    "choose",
    "feasible",
    "fleet_kv",
    "fleet_namespace",
    "fresh",
    "live_gateway_endpoints",
    "live_gateways",
    "make_client_ssl_context",
    "make_server_ssl_context",
    "match_depth",
    "parse_report",
]
