"""Inference serving on the port: the paged KV cache, bucketed prefill and
paged decode, continuous batching. Counterpart of ``tpu_sandbox/serve/``,
with the same exports.

Layers (bottom up):

- ``cache``   — host-side paged KV-cache allocator (JAX's, copied): fixed-
  size blocks, per-sequence block tables, free-list reuse, refcounted
  prefix sharing.
- ``decode``  — prefill padded to a bucket and the single-token decode
  step, plain PyTorch on the LM of ``models/transformer.py``, writing the
  device page buffers in place; replay-exact seeded sampling
  (``sample_token``).
- ``engine``  — continuous-batching engine and the static-batch baseline,
  with deadlines, the bounded queue, shedding and load reports.
- ``replica`` — replica processes behind the KV-backed request queue:
  claim-once entries, TTL leases, claim-once verdicts, SIGTERM drain,
  orphan scavenging, load reports.
- ``client``  — deadline submit, retry-on-shed, hedging.
- ``autoscale`` — leader-elected control loop sizing the replica gang from
  the load reports through the cluster scheduler (serve/train colocation).

Not ported: ``disagg`` (ROADMAP item 10).
"""

from tpu_sandbox_torch.serve.cache import CacheConfig, PagedKVCache
from tpu_sandbox_torch.serve.engine import (
    ContinuousEngine,
    Request,
    RequestResult,
    ServeConfig,
    ShedRecord,
    StaticEngine,
    live_engines,
)

__all__ = [
    "CacheConfig",
    "PagedKVCache",
    "ContinuousEngine",
    "Request",
    "RequestResult",
    "ServeConfig",
    "ShedRecord",
    "StaticEngine",
    "live_engines",
]
