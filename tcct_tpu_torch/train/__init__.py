"""Training (JAX counterpart ``tcct_tpu/train``): mixed precision,
learning-rate schedules, the AdamW + clip optimizer (and Task 2's Adam
with coupled L2), the train and eval steps, the train state and its
checkpoints, and the engine."""

from tcct_tpu_torch.train.engine import Trainer
from tcct_tpu_torch.train.schedule import cyclic_lr, make_stepwise
from tcct_tpu_torch.train.state import (
    Adam,
    AdamW,
    TrainState,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    trainable_parameters,
)
from tcct_tpu_torch.train.step import (
    TrainConfig,
    build_eval_epoch,
    build_eval_step,
    build_loss_fn,
    build_predict,
    build_train_epoch,
    build_train_step,
)
