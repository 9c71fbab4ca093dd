"""Collectives, rank launch, data, sequence and pipeline parallelism, the
compiler-driven engine and the MoE on ``torch.distributed``: counterpart
of ``tpu_sandbox/parallel/`` (the names of its ``__init__`` that are
ported)."""

from tpu_sandbox_torch.parallel.collectives import CollectiveGroup  # noqa: F401
from tpu_sandbox_torch.parallel.data_parallel import DataParallel  # noqa: F401
from tpu_sandbox_torch.parallel.expert import MoeMlp  # noqa: F401
from tpu_sandbox_torch.parallel.pipeline import PipelineParallel  # noqa: F401
from tpu_sandbox_torch.parallel.pjit_engine import PjitEngine, megatron_rules  # noqa: F401
from tpu_sandbox_torch.parallel.ring_attention import make_ring_attention, ring_attention  # noqa: F401
from tpu_sandbox_torch.parallel.seq_parallel import SeqParallel  # noqa: F401
from tpu_sandbox_torch.parallel.ulysses import make_ulysses_attention, ulysses_attention  # noqa: F401
from tpu_sandbox_torch.parallel.flash_ring import (  # noqa: F401
    flash_ring_attention,
    make_flash_ring_attention,
)
