"""Loss ops: counterpart of ``tpu_sandbox/ops/losses.py:19-40``.

Mean softmax cross-entropy with integer labels. At LM-scale class counts
(C >= 4096) on a device with the kernels (a CUDA tensor) it runs the fused
CE of ``ops/ce.py``, whose forward is a kernel; on the CPU, and below 4096
classes (the ConvNet's 10), it is the plain loss over f32 logits, the same
function, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_sandbox_torch.ops import ce

#: engage the fused CE kernel only at LM-scale vocabularies
FUSED_CE_MIN_CLASSES = 4096


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; logits [N, C], labels [N] int."""
    if (logits.ndim == 2 and logits.shape[-1] >= FUSED_CE_MIN_CLASSES
            and logits.device.type != "cpu"):
        return ce.cross_entropy(logits, labels)
    return F.cross_entropy(logits.float(), labels.long())
