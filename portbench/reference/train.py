"""The plain reference train step: the reference's losses and optimizer on
:class:`model.RegNet`, in f32 (reference task1/kite/loopback.py,
task1/kite/losses/loss.py, task1/nets/reg.py, task1/nets/fcp.py).

- Deep supervision: the multi-class soft Dice (softmax over classes, per
  class ``1 - (1 + 2 I) / (1 + U)`` summed over classes) of the main head,
  plus 0.5 times that of each other head.
- Feature polarization (``udh``, weight 1): per class, the pixels of the
  class ranked by the predicted probability (a stable sort), cut into 32
  bins of ``n // 32`` pixels, each bin's mean feat against the class's
  prototype by cosine; plus the reference's leaked MSE of the last class.
- Boundary regression (``reg``, weight 0.1): the learned Laplacian of the
  logits and of the one-hot target, a Gumbel-perturbed softmax over height,
  the smoothing head, and two MSEs (reg.py:109-156).
- AdamW with optax's arithmetic: clip the global norm at 12, Adam's moments
  with f32 bias corrections, decoupled weight decay, a constant rate.

The random draws (DropPath masks, the Gumbel uniforms, the soft-argmax
offsets) come from the generator the caller passes, in the order the
forward makes them: the masks block by block, then the two Gumbel draws,
then the two offset draws.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .model import Ctx, RegNet, run_seq, trained_parameters


def dice_loss(pr, gt):
    pr = torch.softmax(pr, dim=-1)
    axes = tuple(range(pr.dim() - 1))
    inter = torch.sum(pr * gt, dim=axes)
    union = torch.sum(pr, dim=axes) + torch.sum(gt, dim=axes)
    return torch.sum(1.0 - (1.0 + 2.0 * inter) / (1.0 + union))


def deep_supervision(outs, true, coff=0.5):
    total = 0.0
    for i in range(len(outs) - 1, 0, -1):
        total = total + dice_loss(outs[i], true) * coff
    return total + dice_loss(outs[0], true)


def selection_bins(feat, prob, true, bins=32):
    """[bins, L]: the mean feat of each confidence-ranked bin of the pixels
    of a class (the lowest-ranked remainder dropped)."""
    P = feat.shape[0]
    mask = true > 0.5
    nper = torch.clamp(mask.sum() // bins, min=1)
    key = torch.where(mask, prob, torch.full((), float("-inf"), device=prob.device))
    order = torch.argsort(-key, stable=True)
    rank = torch.empty_like(order).scatter_(0, order, torch.arange(P, device=feat.device))
    bin_id = torch.where((rank < nper * bins) & mask, rank // nper, torch.full_like(rank, bins))
    onehot = (bin_id[:, None] == torch.arange(bins, device=feat.device)).float()
    return onehot.T @ feat.float() / nper.float()


def polarization_loss(feat, pred, true, prototypes, bins=32):
    """feat [B, H, W, L], pred logits [B, H, W, C], true one-hot."""
    prob = torch.softmax(pred.detach(), dim=-1)
    nc = true.shape[-1]
    f2 = feat.reshape(-1, feat.shape[-1])
    los = 0.0
    for i in range(nc):
        pro = selection_bins(f2, prob[..., i].reshape(-1), true[..., i].reshape(-1), bins)
        tgt = prototypes[i:i + 1].float().expand(bins, -1)
        los = los - torch.mean(pro @ tgt.T) / pro.shape[-1]
    return los + torch.mean((pro - tgt) ** 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def boundary_loss(model: RegNet, pred, true, ctx: Ctx):
    """pred logits, true one-hot, both [B, H, W, C]."""
    pred = pred[..., 1:]
    true = true[..., 1:]
    H = pred.shape[1]
    gen = ctx.generator
    d = torch.abs(true[:, 1:] - true[:, :-1])
    d = torch.cat([torch.zeros_like(d[:, :1]), d], dim=1)
    prob_true = torch.clamp(torch.sum(d, dim=-1, keepdim=True), max=1.0)

    def lap_reg(x):
        return _nhwc(run_seq(model.lap_reg, _nchw(x), ctx))

    def lap_map(x):
        return torch.sigmoid(_nhwc(run_seq(model.lap_map, _nchw(x), ctx)))

    def sampling_softmax(x):
        u = torch.rand(x.shape, generator=gen, device=x.device)
        g = torch.softmax(x - torch.log(-torch.log(torch.clamp(u, min=1e-20))) / 2.0, dim=1)
        return g / (1e-6 + torch.sum(g, dim=1, keepdim=True))

    def absolute(x):  # derivative 1 at 0
        return torch.where(x >= 0, x, -x)

    pseu_pred = absolute(lap_reg(pred))
    pseu_true = absolute(lap_reg(true))
    pseu_pred = lap_map(torch.sum(sampling_softmax(pseu_pred), dim=-1, keepdim=True))
    pseu_true = lap_map(torch.sum(sampling_softmax(pseu_true), dim=-1, keepdim=True))
    idx = torch.arange(H, dtype=torch.float32, device=pred.device).reshape(1, H, 1, 1)
    idxt = idx + torch.rand(idx.shape, generator=gen, device=idx.device) - 0.5
    idxp = idx + torch.rand(idx.shape, generator=gen, device=idx.device) - 0.5
    edge_true = torch.sum(pseu_true * idxt, dim=1) / H
    edge_pred = torch.sum(pseu_pred * idxp, dim=1) / H

    def mse(a, b):
        return torch.mean((a - b) ** 2)

    los_edge = mse(edge_pred, edge_true.detach()) + mse(edge_pred.detach(), edge_true)
    los_prob = (mse(prob_true, torch.softmax(pseu_true, dim=1))
                + mse(prob_true, torch.softmax(pseu_pred, dim=1)))
    return los_edge + los_prob


def train_loss(model: RegNet, img, true, ctx: Ctx):
    """NHWC image and one-hot -> the total loss: Dice with deep supervision
    + polarization + 0.1 boundary regression."""
    outs, feat = model.base.run(_nchw(img), ctx, with_feats=True)
    outs = [_nhwc(o) for o in outs]
    udh = polarization_loss(_nhwc(feat), outs[0], true, model.fcp.buf_grad).float()
    reg = boundary_loss(model, outs[0], true, ctx).float()
    los = deep_supervision([o.float() for o in outs], true)
    return los + udh * 1.0 + reg * 0.1


class AdamW:
    """optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay=wd))."""

    def __init__(self, params: List[torch.Tensor], lr=1e-4, weight_decay=2e-4, clip=12.0):
        self.params = params
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """One step in place."""
        b1, b2, eps = 0.9, 0.999, 1e-8
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if norm >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(self.count))
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + self.wd * p
            p.add_(-self.lr * u)


class Trainer:
    """The reference's train state: the model's f32 parameters and BN
    statistics, AdamW's moments, stepped on whole batches.  With ``dtype``
    other than f32 each step computes on a copy of the model in that type
    (the image too), its gradients and statistics going back to the f32
    state: the control's mixed precision.  ``trained`` gives the parameters
    a step moves (the model's reference module's ``trained_parameters``)."""

    def __init__(self, model: RegNet, lr=1e-4, weight_decay=2e-4, clip=12.0, quant=None,
                 quant_grad=None, dtype=torch.float32, trained=trained_parameters):
        self.model = model
        self.quant, self.quant_grad, self.dtype = quant, quant_grad, dtype
        self.trained = trained
        self.params = trained(model)
        self.names = list(self.params)
        self.opt = AdamW([self.params[k] for k in self.names], lr, weight_decay, clip)

    def step(self, img, true, generator: Optional[torch.Generator]) -> Dict[str, object]:
        """One step on NHWC f32 ``img`` and one-hot ``true``; returns the
        total loss and the gradients by name as the optimizer takes them
        (before its clip)."""
        ctx = Ctx(self.quant, train=True, generator=generator, quant_grad=self.quant_grad)
        work = self.model
        if self.dtype != torch.float32:
            work = copy.deepcopy(self.model).to(self.dtype)
        params = self.trained(work)
        total = train_loss(work, img.to(self.dtype), true, ctx)
        grads = torch.autograd.grad(total, [params[k] for k in self.names], allow_unused=True)
        grads = [torch.zeros_like(self.params[k]) if g is None else g.float()
                 for k, g in zip(self.names, grads)]
        self.opt.update(grads)
        names = {m: n for n, m in work.named_modules()}
        with torch.no_grad():
            for m, (mean, var) in ctx.new_stats.items():
                own = self.model.get_submodule(names[m])
                own.running_mean.copy_(mean)
                own.running_var.copy_(var)
        return {"total": float(total.detach()), "grads": dict(zip(self.names, grads))}
