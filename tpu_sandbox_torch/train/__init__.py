from tpu_sandbox_torch.train.state import TrainState  # noqa: F401
from tpu_sandbox_torch.train.trainer import (  # noqa: F401
    PREEMPTED_EXIT_CODE,
    AbortOnAnomaly,
    ElasticEnv,
    Preempted,
    PreemptionHandler,
    ResumableReport,
    Trainer,
    build_elastic_checkpoint,
    make_eval_step,
    make_train_step,
    train_resumable,
)
from tpu_sandbox_torch.train.optim import SGD, Adam, AdamW  # noqa: F401
