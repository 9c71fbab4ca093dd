"""PyTorch/CUDA port of ``tpu_sandbox`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``tpu_sandbox`` is the reference this package is held
against (tests/test_torch_*.py). Module names mirror it: ``data/``,
``models/``, ``ops/``, ``train/``, ``utils/``. Every TPU kernel on the
ported path has a hand-written CUDA counterpart under ``csrc/``, built by
``ops/build.py`` at first use and bound through ctypes.

This package imports ``torch`` and numpy only: never ``jax`` and nothing
of ``tpu_sandbox`` (whose ``__init__`` imports jax).

Ported so far: the single-device 3000x3000 MNIST trainer
(``python -m tpu_sandbox_torch.mnist_onegpu``) on the transposed
space-to-depth plan with unfused BN tails and the scattered-3x3 conv1.
ROADMAP.md lists what is still to port.
"""
