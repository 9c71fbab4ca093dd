from tpu_sandbox_torch.train.state import TrainState  # noqa: F401
from tpu_sandbox_torch.train.trainer import (  # noqa: F401
    Trainer,
    make_eval_step,
    make_train_step,
)
from tpu_sandbox_torch.train.optim import SGD, Adam, AdamW  # noqa: F401
