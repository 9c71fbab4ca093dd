"""Device choice for the port's entry points: the card unless the caller
asks for the CPU. A missing card is an error, never a silent CPU run."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``. Raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --force-cpu) to "
            "run the port's plain PyTorch path on the CPU"
        )
    return dev


def rank_device(local_rank: int, force_cpu: bool = False) -> torch.device:
    """The device of a data-parallel rank: the CPU with ``force_cpu``, else
    GPU ``local_rank``, which must exist. NCCL will not put two ranks on
    one GPU, so there is no fallback: too few cards is an error."""
    if force_cpu:
        return torch.device("cpu")
    resolve_device("cuda")
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise SystemExit(
            f"{local_rank + 1} GPU ranks asked for on a machine with {n} "
            f"GPU(s): NCCL needs one GPU a rank; pass --force-cpu for gloo "
            f"ranks on the CPU")
    return torch.device("cuda", local_rank)


def exact_fp32() -> None:
    """Full-fp32 matmuls and convolutions on the card (no TF32). Set
    wherever a plain PyTorch version is the reference for a kernel or the
    card is held against the CPU: TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
