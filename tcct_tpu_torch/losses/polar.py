"""Feature-polarization prototype loss (reference task1/nets/fcp.py,
fcs.py, reg.py:86-105; JAX counterpart ``tcct_tpu/losses/polar.py``).

The reference's ``points_selection_bins`` boolean-masks a class's pixels,
ranks them by predicted confidence, splits the ranking into 32 bins and
mean-pools each bin.  As in the JAX package the ranking is a full-length
stable sort (pixels outside the class pushed to the tail with -inf keys),
an inverse-permutation rank and a segment sum, here in a fixed order
without float atomics, so that a train step repeats bit for bit on the
card.  The sort must be stable: ``jnp.argsort`` is, and bf16
probabilities tie often.  The prototypes are the model's frozen
``fcp.buf_grad`` buffer.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matrix products in full f32 (no TF32) inside the block, whatever
    the caller's setting."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _BinSum(torch.autograd.Function):
    """``onehot^T @ x``: the rows of f32 ``x`` summed per bin, with
    ``onehot`` [P, bins] f32 (one 1 in a row, or none); its adjoint
    ``onehot @ g``.  Both are one f32 matrix product in a fixed order (no
    atomics), in full f32."""

    @staticmethod
    def forward(ctx, x, onehot):
        ctx.save_for_backward(onehot)
        with _full_f32_matmul():
            return onehot.T @ x

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (onehot,) = ctx.saved_tensors
        with _full_f32_matmul():
            return onehot @ g, None


def points_selection_bins(feat: torch.Tensor, prob: torch.Tensor, true: torch.Tensor,
                          bins: int = 32) -> torch.Tensor:
    """feat [P, L]; prob, true [P] -> [bins, L] f32: the mean embedding of
    each confidence-ranked bin of the class pixels (true > 0.5).  With n
    class pixels, bin i holds ranks [i*(n//bins), (i+1)*(n//bins)); the
    lowest-confidence remainder is dropped.

    The JAX package's ``segment_sum`` over the bins, as one f32 product of
    the pixels' one-hot bin matrix and the features: a fixed order, no
    atomics, and no value on the device read on the host."""
    P, L = feat.shape
    dev = feat.device
    mask = true > 0.5
    nper = torch.clamp(mask.sum() // bins, min=1)
    key = torch.where(mask, prob, torch.full((), float("-inf"), dtype=prob.dtype, device=dev))
    order = torch.argsort(-key, stable=True)  # descending, class pixels first
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(P, device=dev))
    valid = (rank < nper * bins) & mask
    bin_id = torch.where(valid, rank // nper, torch.full_like(rank, bins))  # bins: dropped
    onehot = (bin_id[:, None] == torch.arange(bins, device=dev)).float()
    return _BinSum.apply(feat.float(), onehot) / nper.float()


def cosinesim_loss(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """- mean(q @ k^T) / L (reference fcs.py:63-67), in q's promoted type."""
    dt = torch.promote_types(q.dtype, k.dtype)
    return -torch.mean(q.to(dt) @ k.to(dt).T) / q.shape[-1]


def feature_polarization_loss(feats: Sequence[torch.Tensor], pred: torch.Tensor,
                              true: torch.Tensor, prototypes: torch.Tensor, con: str = "cos",
                              bins: int = 32) -> torch.Tensor:
    """feats: [B, H, W, L] embedding maps; pred: raw logits [B, H, W, C];
    true: one-hot [B, H, W, C]; prototypes: [C, L] unit rows.

    Per scale and class, the bin-pooled embeddings against the class
    prototype (cosine, or MSE with ``con != 'cos'``); plus, reproducing the
    reference's loop-variable leak, an MSE between the last class's pooled
    embeddings and its prototype."""
    prob = torch.softmax(pred.detach(), dim=-1)
    nc = true.shape[-1]
    total = 0.0
    for feat in feats:
        f2 = feat.reshape(-1, feat.shape[-1])
        los = 0.0
        for i in range(nc):
            pro = points_selection_bins(f2, prob[..., i].reshape(-1),
                                        true[..., i].reshape(-1).float(), bins)
            tgt = prototypes[i:i + 1].expand(bins, -1)
            if con == "cos":
                los = los + cosinesim_loss(pro, tgt)
            else:
                los = los + torch.mean((pro - tgt.to(pro.dtype)) ** 2)
        total = total + los + torch.mean((pro - tgt.to(pro.dtype)) ** 2)
    return total
