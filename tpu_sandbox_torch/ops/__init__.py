"""The port's ops: CUDA kernels with their plain PyTorch versions.

``launch_counts`` and ``reset_launch_counts`` read and zero every
kernel's launch counter at once, so a run can show which kernels it went
through."""

from __future__ import annotations


def _counters():
    from tpu_sandbox_torch.ops import (
        bn_tail,
        bn_tail_t,
        ce,
        conv,
        conv1_tail_t,
        conv5_t,
        conv_t,
        fc_t,
        flash_attention,
    )

    return (conv_t.LAUNCHES, fc_t.LAUNCHES, bn_tail_t.LAUNCHES,
            conv5_t.LAUNCHES, conv1_tail_t.LAUNCHES, ce.LAUNCHES,
            flash_attention.LAUNCHES, conv.LAUNCHES, bn_tail.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, keyed by kernel, kind and
    shape (e.g. ``"conv3x3_t fwd C16 CO256"``, ``"fc_dgrad_t"``,
    ``"bn_tail_t bwd_apply C256 CO16"``, ``"conv1_tail_t wgrad CO256"``,
    ``"conv3x3_stats C16 CO256"``, ``"bn_tail fwd C128 CO32"``,
    ``"flash_fwd"``, ``"flash_bwd_dkv"``, ``"flash_bwd_dq"``, ``"ce_fwd"``)."""
    return {k: v for counter in _counters() for k, v in counter.items()}


def reset_launch_counts() -> None:
    for counter in _counters():
        counter.clear()
