"""The port's command-line tools over the trace analytics and the health
plane, copies of the repo's ``tools/{tracecat,tracediff,fleetop}.py``, run
as modules: ``python -m tpu_sandbox_torch.tools.tracecat LOGDIR``,
``python -m tpu_sandbox_torch.tools.tracediff A B`` and ``python -m
tpu_sandbox_torch.tools.fleetop --port P``."""
