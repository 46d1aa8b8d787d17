"""The train step (JAX counterpart ``tcct_tpu/train``): mixed precision,
learning-rate schedules, the AdamW + clip optimizer and the step itself.
The augmentation graph, the engine, the eval step and checkpoints are not
ported yet."""

from tcct_tpu_torch.train.schedule import cyclic_lr, make_stepwise
from tcct_tpu_torch.train.state import AdamW, make_optimizer, trainable_parameters
from tcct_tpu_torch.train.step import TrainConfig, build_loss_fn, build_train_step
