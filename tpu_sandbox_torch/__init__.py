"""PyTorch/CUDA port of ``tpu_sandbox`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``tpu_sandbox`` is the reference this package is held
against (tests/test_torch_*.py). Module names mirror it: ``data/``,
``models/``, ``ops/``, ``train/``, ``utils/``. Every TPU kernel on the
ported path has a hand-written CUDA counterpart under ``csrc/``, built by
``ops/build.py`` at first use and bound through ctypes.

This package imports ``torch`` and numpy only: never ``jax`` and nothing
of ``tpu_sandbox`` (whose ``__init__`` imports jax).

Ported so far: the single-device 3000x3000 MNIST trainer
(``python -m tpu_sandbox_torch.mnist_onegpu``) on all three ConvNet plans
(the transposed and the NHWC space-to-depth plans with all of their
options, and the plain NHWC ConvNet), with or without BN, gradient
accumulation, the C++ prefetching loader and profiler traces. On the
card it runs the JAX package's whole chip plan: the sparse-tap conv1, the
BN/ReLU/pool tails fused into kernels, and conv1's backward fused with
bn1's tail (plain PyTorch tails on the CPU, or on request). And the
transformer LM's
single-device training (``python -m tpu_sandbox_torch.lm_train``), with
flash attention (forward, dk/dv, dq) and the fused cross-entropy forward
as kernels; and its sequence-parallel training (``lm_train --parallelism
sp``: ring, Ulysses and flash-ring attention over ranks of
``torch.distributed``, the flash-ring's hops on the flash kernels).
ROADMAP.md lists what is still to port.
"""
