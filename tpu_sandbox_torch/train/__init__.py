from tpu_sandbox_torch.train.state import TrainState  # noqa: F401
from tpu_sandbox_torch.train.trainer import (  # noqa: F401
    Trainer,
    make_eval_step,
    make_train_step,
)
