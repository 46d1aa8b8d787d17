"""Training losses and validation scores (JAX counterpart ``tcct_tpu/losses``):
deep-supervision Dice, boundary regression, feature polarization, and the
Dice/IoU scores.  NHWC tensors, the class axis last, as in the JAX package."""

from tcct_tpu_torch.losses.boundary import boundary_regression_loss, sampling_softmax
from tcct_tpu_torch.losses.polar import (
    cosinesim_loss,
    feature_polarization_loss,
    points_selection_bins,
)
from tcct_tpu_torch.losses.seg import (
    MultiLoss,
    deep_supervision_loss,
    get_loss,
    mdice_score,
    mdice_scorem,
    mdice_scores,
    miou_score,
    miou_scorem,
)
