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


def exact_fp32() -> None:
    """Full-fp32 matmuls and convolutions on the card (no TF32). Set
    wherever a plain PyTorch version is the reference for a kernel or the
    card is held against the CPU: TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
