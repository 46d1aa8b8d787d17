"""Segmentation losses (JAX counterpart ``tcct_tpu/losses/seg.py``;
reference task1/kite/losses/loss.py and loopback.py:62-73).

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
