"""Process bootstrap and device meshes on ``torch.distributed``:
counterpart of ``tpu_sandbox/runtime/{bootstrap,mesh}.py``."""
