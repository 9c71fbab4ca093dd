"""Collectives, rank launch and data parallelism on ``torch.distributed``:
counterpart of ``tpu_sandbox/parallel/{collectives,data_parallel}.py``."""
