"""Segmentation losses and validation scores (JAX counterpart
``tcct_tpu/losses/seg.py``; reference task1/kite/losses/loss.py,
loopback.py:62-73 and miou.py).

Tensors are NHWC with the class axis last (``[B, H, W, C]``)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MultiLoss:
    """Softmax over classes, then ``1 - dice`` (``base='dice'``) or the MSE
    (``base='mse'``) of each class, summed over classes (reference
    loss.py:70-99, unit class weights), in the JAX package's one-pass
    per-class form.  ``pr`` is raw logits [B, H, W, C]; ``gt`` one-hot
    [B, H, W, C] or integer labels [B, H, W]."""

    base: str = "dice"

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
        return torch.sum(torch.mean((pr - gt) ** 2, dim=axes))


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
