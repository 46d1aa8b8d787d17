"""Training losses and validation scores (JAX counterpart ``tcct_tpu/losses``):
deep-supervision Dice, boundary regression, feature polarization, the
Dice/IoU/MDice/cross-entropy losses, and the Dice/IoU scores.  NHWC
tensors, the class axis last, as in the JAX package."""

from tcct_tpu_torch.losses.boundary import (
    boundary_regression_loss,
    sampling_softmax,
    soft_argmax,
)
from tcct_tpu_torch.losses.polar import (
    cosinesim_loss,
    feature_polarization_loss,
    optimize_prototypes,
    points_selection_bins,
    polar_prototypes,
    refine_prototypes,
)
from tcct_tpu_torch.losses.seg import (
    CrossEntropyLoss,
    DiceLoss,
    IouLoss,
    MDiceLoss,
    MultiLoss,
    deep_supervision_loss,
    dice2_coef,
    dice_coef,
    get_loss,
    get_mloss,
    iou_coef,
    mdice_score,
    mdice_scorem,
    mdice_scores,
    miou_score,
    miou_scorem,
)
