"""The entry scripts' shared flag groups: the port's own copy of
``tpu_sandbox/utils/cli.py``'s ``add_checkpoint_cli`` (:22),
``add_grad_compress_cli`` and ``add_overlap_cli`` (:52-95) and
``add_elastic_cli`` (:97-146: the single-host supervisor's flags, the
cross-host agents' and the cluster pool's), with the same flags, choices,
defaults and help, so that a script of the port parses what its JAX
counterpart parses."""

from __future__ import annotations


def add_checkpoint_cli(parser) -> None:
    """Register the checkpoint flag group shared by the entry scripts.

    One definition site keeps the launcher and its respawned workers
    agreeing on spelling — the elastic passthrough re-parses these exact
    flags in the child process.
    """
    parser.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                        help="with --ckpt-dir: also save every N steps")
    parser.add_argument("--ckpt-dir", type=str, default=None,
                        help="checkpoint directory (npz/sharded)")
    parser.add_argument("--resume", action="store_true",
                        help="restore the newest step from --ckpt-dir first")
    parser.add_argument("--ckpt-sharded", action="store_true",
                        help="with --elastic: every rank writes its own "
                             "shard + SHA-256, rank 0 seals the step with a "
                             "manifest (two-phase commit). Implied by --zero, "
                             "whose optimizer shards rank 0 alone cannot see")
    parser.add_argument("--ckpt-verify-interval", type=float, default=0.0,
                        metavar="SEC",
                        help="with sharded checkpoints: rank 0 re-hashes "
                             "older sealed steps every SEC seconds in the "
                             "background (0 = off)")
    parser.add_argument("--ckpt-compress", action="store_true",
                        help="with --ckpt-sharded: zlib-deflate each shard "
                             "file (np.savez_compressed); manifests record "
                             "on-disk AND raw sizes, checksums stay over "
                             "the bytes on disk")


def add_grad_compress_cli(parser, error_feedback: bool = True) -> None:
    """Register the gradient-compression flag group (same single-site
    contract as the checkpoint group: launchers and their respawned
    workers re-parse these exact flags)."""
    parser.add_argument("--grad-compress", choices=["none", "bf16", "int8"],
                        default="none",
                        help="compress the data-parallel gradient sync: "
                             "bf16 cast (2x wire payload reduction) or "
                             "int8 block-scaled two-shot exchange (~4x); "
                             "'none' is bitwise-identical to the "
                             "uncompressed path")
    if error_feedback:
        parser.add_argument("--no-error-feedback", action="store_true",
                            help="with --grad-compress int8: drop the "
                                 "error-feedback residual (saves one "
                                 "param-sized fp32 buffer per rank, loses "
                                 "the fp32-tracking convergence guarantee)")


def add_overlap_cli(parser, prefetch: bool = True) -> None:
    """Register the overlapped-step-pipeline flag group (same single-site
    contract as the checkpoint group: launchers and their respawned
    workers re-parse these exact flags). ``prefetch=False`` for entry
    scripts with synthetic in-memory streams and no Trainer loop."""
    parser.add_argument("--overlap-grad-sync", action="store_true",
                        help="bucket the gradient sync (DDP's reducer): one "
                             "independent collective per ~--bucket-mb flat "
                             "buffer so XLA's latency-hiding scheduler can "
                             "overlap all-reduces with remaining backward "
                             "compute; composes with --grad-compress "
                             "(per-bucket quantization + error feedback) "
                             "and --zero")
    parser.add_argument("--bucket-mb", type=float, default=25.0,
                        metavar="MB",
                        help="with --overlap-grad-sync: bucket size target "
                             "(default 25, PyTorch DDP's bucket_cap_mb)")
    if prefetch:
        parser.add_argument("--prefetch", action="store_true",
                            help="double-buffered background batch "
                                 "prefetch: a daemon thread assembles "
                                 "batch N+1 while step N runs (same "
                                 "batches, same order — resume parity is "
                                 "unchanged under --elastic)")


def add_elastic_cli(parser) -> None:
    """Register the elastic/agent flag group (same single-site contract as
    the checkpoint group: launchers, agents, and their respawned workers
    all re-parse these exact flags)."""
    parser.add_argument("--elastic", action="store_true",
                        help="run the multiprocess topology under elastic "
                             "supervision: crashed/preempted generations "
                             "are relaunched and resume from the newest "
                             "checkpoint with exact data order")
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="with --elastic: charged restarts before "
                             "giving up (preemptions are free)")
    parser.add_argument("--agents", type=int, default=0, metavar="N",
                        help="with --elastic: cross-host mode — N per-host "
                             "agents (runtime/host_agent.py) coordinate "
                             "generations over the KV store with leader "
                             "election; 0 keeps the single-host supervisor. "
                             "World size need not divide by N (the leader "
                             "publishes a balanced rank-assignment table)")
    parser.add_argument("--job-id", type=str, default="", metavar="ID",
                        help="with --elastic: run under this job's KV "
                             "namespace (job/<ID>/...) so several jobs can "
                             "share one store without colliding; empty = "
                             "the bare default-job namespace")
    parser.add_argument("--priority", type=int, default=0,
                        help="with --pool: this job's scheduling priority "
                             "(higher wins; may preempt lower-priority "
                             "running jobs)")
    parser.add_argument("--pool", type=int, default=0, metavar="SLOTS",
                        help="with --elastic: multi-tenant cluster mode — "
                             "run runtime/scheduler.py over SLOTS host "
                             "slots and gang-schedule the demo job(s) "
                             "through its durable queue instead of "
                             "launching agents directly")
    parser.add_argument("--agent-id", type=int, default=None, metavar="ID",
                        help="run exactly ONE host agent (0..N-1) of an "
                             "--agents N job and exit with its verdict — "
                             "for launching each host's agent yourself; "
                             "needs --kv-port pointing at the job's store "
                             "(or --leader to host it here)")
    parser.add_argument("--leader", action="store_true",
                        help="with --agent-id: host the coordination KV "
                             "store inside this agent's process (start "
                             "this agent first; peers connect via "
                             "--kv-port). Binds loopback by default; pass "
                             "--kv-bind 0.0.0.0 (+ TPU_SANDBOX_KV_TOKEN) "
                             "for real cross-host deployment")
    parser.add_argument("--kv-bind", type=str, default="127.0.0.1",
                        metavar="ADDR",
                        help="with --leader: address the KV store listens "
                             "on (default loopback; 0.0.0.0 for cross-host "
                             "— set TPU_SANDBOX_KV_TOKEN on every host so "
                             "connections authenticate with the shared "
                             "secret)")
