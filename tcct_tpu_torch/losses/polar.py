"""Feature-polarization prototype loss (reference task1/nets/fcp.py,
fcs.py, reg.py:86-105; JAX counterpart ``tcct_tpu/losses/polar.py``).

The reference's ``points_selection_bins`` boolean-masks a class's pixels,
ranks them by predicted confidence, splits the ranking into 32 bins and
mean-pools each bin.  As in the JAX package the ranking is a full-length
stable sort (pixels outside the class pushed to the tail with -inf keys),
an inverse-permutation rank and a fixed 33-segment sum.  The sort must be
stable: ``jnp.argsort`` is, and bf16 probabilities tie often.  The
prototypes are the model's frozen ``fcp.buf_grad`` buffer.
"""

from __future__ import annotations

from typing import Sequence

import torch


def points_selection_bins(feat: torch.Tensor, prob: torch.Tensor, true: torch.Tensor,
                          bins: int = 32) -> torch.Tensor:
    """feat [P, L]; prob, true [P] -> [bins, L]: the mean embedding of each
    confidence-ranked bin of the class pixels (true > 0.5).  With n class
    pixels, bin i holds ranks [i*(n//bins), (i+1)*(n//bins)); the
    lowest-confidence remainder is dropped."""
    P, L = feat.shape
    mask = true > 0.5
    nper = torch.clamp(mask.sum() // bins, min=1)
    key = torch.where(mask, prob, torch.full((), float("-inf"), dtype=prob.dtype, device=prob.device))
    order = torch.argsort(-key, stable=True)  # descending, class pixels first
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(P, device=feat.device))
    valid = (rank < nper * bins) & mask
    bin_id = torch.where(valid, rank // nper, torch.full_like(rank, bins))  # overflow bucket
    w = valid.float()
    sums = torch.zeros((bins + 1, L), dtype=torch.float32, device=feat.device).index_add(
        0, bin_id, feat.float() * w[:, None])[:bins]
    return sums / nper.float()


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
