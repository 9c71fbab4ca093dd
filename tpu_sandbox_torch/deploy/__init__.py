"""Deployment plane of the port: durable model registry + leader-elected
rollout control (see :mod:`tpu_sandbox_torch.deploy.registry` and
:mod:`tpu_sandbox_torch.deploy.controller`), copies of
``tpu_sandbox/deploy/``'s with the same keys."""
