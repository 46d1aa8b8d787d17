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
``fcp.buf_grad`` buffer, drawn by :func:`polar_prototypes` or
self-optimized by :func:`optimize_prototypes`.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

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


def polar_prototypes(num_cls: int, num_emb: int, generator: torch.Generator) -> torch.Tensor:
    """Frozen prototypes, U[0, 1) rows L2-normalised: the ``init=False``
    path the reference uses (reg.py:57, fcp.py:60-61), drawn from
    ``generator`` (the JAX package draws them with ``jax.random``)."""
    vec = torch.rand((num_cls, num_emb), generator=generator)
    return vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)


def _uniformity_loss(vec: torch.Tensor) -> torch.Tensor:
    v = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    return torch.mean(torch.log(torch.mean(torch.exp(v @ v.T), dim=-1)))


def refine_prototypes(vec0: torch.Tensor, steps: int = 333, lr: float = 1e-2,
                      weight_decay: float = 2e-4) -> torch.Tensor:
    """The reference's ``init=True`` self-optimization (fcp.py:36-57) from
    the rows ``vec0``: Adam on the log-mean-exp uniformity loss with decay
    ``weight_decay * vec`` added to the gradient and a reduce-on-plateau
    learning rate (factor 0.7, patience 2, cooldown 2, relative threshold
    1e-4, floor 1e-5), for a fixed number of steps, then the rows
    L2-normalised (JAX ``tcct_tpu/losses/polar.py::optimize_prototypes``).
    The plateau state stays in 0-d tensors, so no step reads the device."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    vec = vec0.float().clone()
    m, v = torch.zeros_like(vec), torch.zeros_like(vec)
    dev = vec.device
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    best = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    bad = torch.zeros((), dtype=torch.int32, device=dev)
    cool = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(steps):
        with torch.enable_grad():
            x = vec.detach().requires_grad_(True)
            loss = _uniformity_loss(x)
            (g,) = torch.autograd.grad(loss, x)
        loss = loss.detach()
        g = g + weight_decay * vec
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        t = i + 1
        vec = vec - lr_t * (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + eps)
        improved = loss < best * (1 - 1e-4)
        best = torch.where(improved, loss, best)
        bad = torch.where(improved | (cool > 0), 0, bad + 1)
        cool = torch.clamp(cool - 1, min=0)
        reduce = (bad > 2) & (cool == 0)
        lr_t = torch.where(reduce, torch.clamp(lr_t * 0.7, min=1e-5), lr_t)
        bad = torch.where(reduce, 0, bad)
        cool = torch.where(reduce, 2, cool)
    return vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)


def optimize_prototypes(num_cls: int, num_emb: int = 32,
                        generator: Optional[torch.Generator] = None, steps: int = 333,
                        lr: float = 1e-2, weight_decay: float = 2e-4) -> torch.Tensor:
    """Self-optimized prototypes: U[0, 1) rows drawn from ``generator`` (on
    the device the result lives on), refined by :func:`refine_prototypes`
    (the JAX package draws the rows with ``jax.random``)."""
    device = generator.device if generator is not None else None
    vec0 = torch.rand((num_cls, num_emb), generator=generator, device=device)
    return refine_prototypes(vec0, steps, lr, weight_decay)


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
