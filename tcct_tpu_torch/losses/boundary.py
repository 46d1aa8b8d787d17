"""Boundary-regression loss (reference task1/nets/reg.py:109-156; JAX
counterpart ``tcct_tpu/losses/boundary.py``).

Drops the background channel, derives a GT boundary map from row-wise
one-hot differences, pushes predicted and true layer maps through the
learned grouped-conv Laplacian, applies a Gumbel-noise column softmax over
the height axis, and penalises (a) the symmetric MSE between the noisy
soft-argmax edge positions and (b) the MSE between boundary maps.

NHWC tensors; the height axis is dim 1.  The noise is drawn from a
``torch.Generator``; ``generator=None`` pins every uniform to 0.5, the
deterministic mode of the cross-framework parity tests.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def _uniform_like(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    if generator is None:
        return torch.full(shape, 0.5, dtype=torch.float32, device=device)
    return torch.rand(shape, generator=generator, device=device)


def soft_argmax(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """Differentiable argmax over the class (last) axis (reference
    nets/reg.py:27-35): the expected class index under ``softmax(x *
    beta)``, [B, H, W, 1]."""
    soft = torch.clamp(torch.softmax(x * beta, dim=-1), 0.0, 1.0)
    idx = torch.arange(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.sum(soft * idx, dim=-1, keepdim=True)


def sampling_softmax(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                     eps_floor: float = 1e-20) -> torch.Tensor:
    """Gumbel-perturbed softmax over height, renormalised (reference
    reg.py:118-126)."""
    u = _uniform_like(generator, x.shape, x.device)
    g = x - torch.log(-torch.log(torch.clamp(u, min=eps_floor))) / 2.0
    g = torch.softmax(g, dim=1)
    return g / (1e-6 + torch.sum(g, dim=1, keepdim=True))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with the JAX package's derivative at 0, 1 (``jnp.abs``), where
    ``torch.abs`` has 0.  The Laplacian of a one-hot map is exactly 0 wherever
    a class is absent from the window while its biases are 0, as they are at
    init, so the two differ there."""
    return torch.where(x >= 0, x, -x)


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def boundary_regression_loss(pred: torch.Tensor, true: torch.Tensor, lap_reg: Callable,
                             lap_map: Callable,
                             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """pred: raw logits [B, H, W, C]; true: one-hot [B, H, W, C]."""
    pred = pred[..., 1:]
    true = true[..., 1:].float()
    H = pred.shape[1]

    # GT boundary map: row-wise |diff| of the one-hot, top row zero,
    # summed over classes, clamped to <= 1 (reg.py:113-114)
    d = torch.abs(true[:, 1:] - true[:, :-1])
    d = torch.cat([torch.zeros_like(d[:, :1]), d], dim=1)
    prob_true = torch.clamp(torch.sum(d, dim=-1, keepdim=True), max=1.0)

    pseu_pred = _abs(lap_reg(pred))
    pseu_true = _abs(lap_reg(true))
    pseu_pred = lap_map(torch.sum(sampling_softmax(pseu_pred, generator), dim=-1, keepdim=True))
    pseu_true = lap_map(torch.sum(sampling_softmax(pseu_true, generator), dim=-1, keepdim=True))

    # noisy soft-argmax over height: one (1, H, 1, 1) noise vector shared
    # over batch and width, as torch's rand_like on the index tensor
    idx = torch.arange(H, dtype=torch.float32, device=pred.device).reshape(1, H, 1, 1)
    idxt = idx + _uniform_like(generator, idx.shape, idx.device) - 0.5
    idxp = idx + _uniform_like(generator, idx.shape, idx.device) - 0.5
    edge_true = torch.sum(pseu_true * idxt, dim=1) / H
    edge_pred = torch.sum(pseu_pred * idxp, dim=1) / H

    los_edge = _mse(edge_pred, edge_true.detach()) + _mse(edge_pred.detach(), edge_true)
    los_prob = (_mse(prob_true, torch.softmax(pseu_true, dim=1))
                + _mse(prob_true, torch.softmax(pseu_pred, dim=1)))
    return los_edge + los_prob
