"""Task 2 (JAX counterpart ``tcct_tpu/task2``): the GOALS glaucoma
classifier, a ResNet-18/34/50 with per-stage dropout, its data and
augmentation, trainer, TTA ensemble and metrics.  CLIs:
``python -m tcct_tpu_torch.task2.train`` and
``python -m tcct_tpu_torch.task2.ensemble`` (``--device``, default cuda)."""

from tcct_tpu_torch.task2.metrics import accuracy, f1_score, roc_auc
from tcct_tpu_torch.task2.model import ClsModel, load_resnet_checkpoint
