"""Segmentation losses and validation scores (JAX counterpart
``tcct_tpu/losses/seg.py``; reference task1/kite/losses/loss.py,
lossm.py, loopback.py:62-73 and miou.py).

Tensors are NHWC with the class axis last (``[B, H, W, C]``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Per-class coefficients (reference loss.py:21-37, 51-56)
# ---------------------------------------------------------------------------

def dice_coef(pr, gt, smooth: float = 1.0):
    """Soft Dice over the flattened tensors: ``(s + 2|A.B|) / (s + |A| + |B|)``."""
    pr, gt = pr.reshape(-1), gt.reshape(-1)
    return (smooth + 2.0 * torch.sum(pr * gt)) / (smooth + torch.sum(pr) + torch.sum(gt))


def dice2_coef(pr, gt, smooth: float = 1.0):
    """Dice with a squared denominator (reference loss.py:22-26)."""
    pr, gt = pr.reshape(-1), gt.reshape(-1)
    return (smooth + 2.0 * torch.sum(pr * gt)) / (smooth + torch.sum(pr ** 2) + torch.sum(gt ** 2))


def iou_coef(pr, gt, smooth: float = 1e-12):
    pr, gt = pr.reshape(-1), gt.reshape(-1)
    inter = torch.sum(pr * gt)
    return (inter + smooth) / (torch.sum(pr) + torch.sum(gt) - inter + smooth)


@dataclasses.dataclass(frozen=True)
class DiceLoss:
    """``1 - dice`` of one class map (``bi``: the squared-denominator
    form), reference loss.py:9-32."""

    bi: bool = False

    def __call__(self, pr, gt):
        return 1.0 - (dice2_coef if self.bi else dice_coef)(pr, gt)


@dataclasses.dataclass(frozen=True)
class IouLoss:
    """``1 - iou`` of one class map (reference loss.py:41-56)."""

    def __call__(self, pr, gt):
        return 1.0 - iou_coef(pr, gt)


@dataclasses.dataclass(frozen=True)
class MultiLoss:
    """Softmax over classes, then a per-class loss summed over classes
    (reference loss.py:70-99, unit class weights).  ``base`` ``'dice'``
    (``1 - dice``) and ``'mse'`` run the JAX package's one-pass per-class
    form; a callable base (:class:`DiceLoss`, :class:`IouLoss`) runs once per
    class map.  ``pr`` is raw logits [B, H, W, C]; ``gt`` one-hot
    [B, H, W, C] or integer labels [B, H, W]."""

    base: Union[str, Callable] = "dice"

    def __call__(self, pr, gt):
        nc = pr.shape[-1]
        pr = torch.softmax(pr, dim=-1)
        if gt.dim() == pr.dim() - 1 or gt.shape[-1] != nc:
            gt = F.one_hot(gt.long(), nc).to(pr.dtype)
        axes = tuple(range(pr.dim() - 1))
        if self.base == "dice":
            inter = torch.sum(pr * gt, dim=axes)
            union = torch.sum(pr, dim=axes) + torch.sum(gt, dim=axes)
            return torch.sum(1.0 - (1.0 + 2.0 * inter) / (1.0 + union))
        if self.base == "mse":
            return torch.sum(torch.mean((pr - gt) ** 2, dim=axes))
        return sum(self.base(pr[..., i], gt[..., i]) for i in range(nc))


def get_loss(name: str = "di") -> MultiLoss:
    """'di'/'dice' -> Dice, anything else -> MSE (reference loss.py:101-110)."""
    return MultiLoss("dice" if name in ("dice", "di") else "mse")


def deep_supervision_loss(outs, true, criterion, ds: bool = True, coff_ds: float = 0.5):
    """Full weight on ``outs[0]``, ``coff_ds`` on each other head, summed
    from the last head down (reference loopback.py:62-73)."""
    total = 0.0
    if ds:
        for i in range(len(outs) - 1, 0, -1):
            total = total + criterion(outs[i], true) * coff_ds
    return total + criterion(outs[0], true)


@dataclasses.dataclass(frozen=True)
class MDiceLoss:
    """Soft multi-class Dice training loss (reference miou.py:64-117):
    softmax over classes, the Dice of each (sample, class) with smooth
    1e-6, ``1 -`` their mean; ``bi`` adds the same of the complements."""

    bi: bool = False

    def __call__(self, pr, gt):
        B, nc = pr.shape[0], pr.shape[-1]
        if gt.dim() == pr.dim() - 1 or gt.shape[-1] != nc:
            gt = F.one_hot(gt.long(), nc).float()
        pr = torch.softmax(pr, dim=-1)
        prf = pr.reshape(B, -1, nc).transpose(1, 2)
        gtf = gt.reshape(B, -1, nc).transpose(1, 2)

        def dice(p, g, smooth=1e-6):
            inter = torch.sum(p * g, -1) + smooth
            union = torch.sum(p, -1) + torch.sum(g, -1) + smooth
            return 1.0 - torch.sum(2.0 * inter / union) / (B * nc)

        if self.bi:
            return dice(prf, gtf) + dice(1 - prf, 1 - gtf)
        return dice(prf, gtf)


@dataclasses.dataclass(frozen=True)
class CrossEntropyLoss:
    """``nn.CrossEntropyLoss`` over the class axis (mean, optional class
    weights); ``gt`` integer labels or one-hot."""

    weight: Optional[Sequence[float]] = None

    def __call__(self, pr, gt):
        if gt.dim() == pr.dim():  # one-hot -> indices
            gt = torch.argmax(gt, -1)
        nll = -torch.gather(torch.log_softmax(pr, dim=-1), -1, gt.long()[..., None])[..., 0]
        if self.weight is None:
            return torch.mean(nll)
        w = torch.as_tensor(self.weight, dtype=nll.dtype, device=nll.device)[gt.long()]
        return torch.sum(nll * w) / torch.sum(w)


def get_mloss(name: str = "di", weight=None):
    """Reference kite/losses/lossm.py:8-21: 'di' -> soft MDice, 'd2' -> the
    bi-Dice, anything else -> cross-entropy."""
    if name == "di":
        return MDiceLoss(bi=False)
    if name == "d2":
        return MDiceLoss(bi=True)
    return CrossEntropyLoss(weight=weight)


# ---------------------------------------------------------------------------
# Validation scores (reference miou.py:22-117): per-sample, batch-averaged.
# Plain tensor functions that stay on the tensors' device.
# ---------------------------------------------------------------------------

def mdice_score(pr, gt, smooth: float = 1.0):
    """Dice of one class channel per batch sample, averaged over the batch
    (reference miou.py:69-80).  pr/gt: [B, ...]."""
    B = pr.shape[0]
    pr = pr.reshape(B, -1)
    gt = gt.reshape(B, -1)
    inter = torch.sum(pr * gt, dim=-1)
    union = torch.sum(pr, dim=-1) + torch.sum(gt, dim=-1) + smooth
    return torch.mean((2.0 * inter + smooth) / union)


def _dice_by_class(pr, gt, smooth: float = 1.0):
    """Per-class dice of each sample in one pass over [B, ..., C] tensors,
    batch-averaged -> [C]."""
    B, nc = pr.shape[0], pr.shape[-1]
    prf = pr.reshape(B, -1, nc)
    gtf = gt.reshape(B, -1, nc)
    inter = torch.sum(prf * gtf, dim=1)
    union = torch.sum(prf, dim=1) + torch.sum(gtf, dim=1) + smooth
    return torch.mean((2.0 * inter + smooth) / union, dim=0)


def mdice_scorem(pr, gt, start_idx: int = 0):
    """Mean per-class dice over classes >= start_idx (miou.py:87-91);
    pr/gt: [B, H, W, C] one-hot."""
    return torch.mean(_dice_by_class(pr, gt)[start_idx:])


def mdice_scores(pr, gt):
    """Per-class dice vector (miou.py:82-85)."""
    return _dice_by_class(pr, gt)


def miou_score(pr, gt, smooth: float = 1.0):
    """IoU of one class channel per batch sample, batch mean (miou.py:28-38)."""
    B = pr.shape[0]
    pr = pr.reshape(B, -1)
    gt = gt.reshape(B, -1)
    inter = torch.sum(pr * gt, dim=-1)
    union = torch.sum(pr, dim=-1) + torch.sum(gt, dim=-1) - inter + smooth
    return torch.mean((inter + smooth) / union)


def miou_scorem(pr, gt, start_idx: int = 0):
    """Mean per-class IoU over classes >= start_idx; pr/gt: [B, H, W, C]."""
    B, nc = pr.shape[0], pr.shape[-1]
    prf = pr.reshape(B, -1, nc)
    gtf = gt.reshape(B, -1, nc)
    inter = torch.sum(prf * gtf, dim=1)
    union = torch.sum(prf, dim=1) + torch.sum(gtf, dim=1) - inter + 1.0
    iou = torch.mean((inter + 1.0) / union, dim=0)
    return torch.mean(iou[start_idx:])
