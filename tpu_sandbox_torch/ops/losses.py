"""Loss ops: counterpart of ``tpu_sandbox/ops/losses.py:19-40``.

Mean softmax cross-entropy with integer labels over f32 logits. At the
ConvNet's 10 classes the JAX package takes its plain path (the fused CE
kernel engages only from 4096 classes), and so does this one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; logits [N, C], labels [N] int."""
    return F.cross_entropy(logits.float(), labels.long())
