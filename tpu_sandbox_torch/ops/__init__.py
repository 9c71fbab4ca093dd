"""The port's ops: CUDA kernels with their plain PyTorch versions.

``launch_counts`` and ``reset_launch_counts`` read and zero every
kernel's launch counter at once, so a run can show which kernels it went
through."""

from __future__ import annotations


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, keyed by kernel, kind and
    shape (e.g. ``"conv3x3_t fwd C16 CO256"``, ``"fc_dgrad_t"``)."""
    from tpu_sandbox_torch.ops import conv_t, fc_t

    return {**conv_t.LAUNCHES, **fc_t.LAUNCHES}


def reset_launch_counts() -> None:
    from tpu_sandbox_torch.ops import conv_t, fc_t

    conv_t.LAUNCHES.clear()
    fc_t.LAUNCHES.clear()
