"""The entry scripts' shared flag groups: the port's own copy of
``tpu_sandbox/utils/cli.py``'s ``add_grad_compress_cli`` and
``add_overlap_cli`` (:52-95), with the same flags, choices, defaults and
help, so that a script of the port parses what its JAX counterpart
parses."""

from __future__ import annotations


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
