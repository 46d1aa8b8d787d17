"""The train step (JAX counterpart ``tcct_tpu/train/step.py``).

One step: uint8 batch -> one-hot -> train-mode forward of the base model
with the auxiliary losses (compute copies of the weights in ``cfg.dtype``)
-> deep-supervision Dice + the enabled auxiliary losses -> gradients into
the f32 masters -> clip 12 + AdamW -> the new BN running statistics,
f32, updated from the compute-dtype forward.  PyTorch runs it eagerly; on
the card every MetaPool mixer, depthwise 3x3 and train BatchNorm, forward
and backward, goes through the port's hand-written kernels.

The on-device augmentation graph (``augment=True`` in the JAX package,
ROADMAP A8) is not ported: the batch is used as it comes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from tcct_tpu_torch.losses.seg import deep_supervision_loss, get_loss
from tcct_tpu_torch.models.layers import BatchNorm2d, train_pass
from tcct_tpu_torch.train.precision import cast_floating
from tcct_tpu_torch.train.state import AdamW, trainable_parameters


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Loss and step knobs (the JAX package's ``TrainConfig``, reference
    task1/kite/main.py:18-49).  ``augment`` stays False until the
    augmentation graph is ported; ``pinned_reg_noise`` pins the boundary
    loss's noise (uniforms 0.5) for cross-framework parity."""

    loss: str = "di"
    ds: bool = True
    coff_ds: float = 0.5
    udh: bool = False
    coff_udh: float = 1.0
    reg: bool = False
    coff_reg: float = 0.1
    epl: bool = False
    coff_epl: float = 0.1
    crop_hw: Tuple[int, int] = (256, 256)
    n_class: int = 5
    augment: bool = False
    dtype: torch.dtype = torch.float32
    pinned_reg_noise: bool = False


def build_loss_fn(model: torch.nn.Module, cfg: TrainConfig) -> Callable:
    """The training loss as a function of the f32 parameters:
    ``loss_fn(params, buffers, img, true_oh, generator) -> (loss,
    (new BN statistics, metrics))``.  ``params`` and ``buffers`` map
    state-dict names to tensors; compute copies in ``cfg.dtype`` go into
    ``model`` (a ``RegNet``, in train mode) through ``functional_call``.
    ``generator`` draws the DropPath masks and, unless pinned, the boundary
    loss's noise."""
    criterion = get_loss(cfg.loss)
    bn_names = {m: name for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}

    def loss_fn(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                img: torch.Tensor, true_oh: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        variables = cast_floating({**params, **buffers}, cfg.dtype)
        kw = dict(generator=None if cfg.pinned_reg_noise else generator,
                  use_udh=cfg.udh, use_reg=cfg.reg, use_epl=cfg.epl)
        with train_pass(model, generator) as new_stats:
            pyr, _, aux = functional_call(model, variables, (img, true_oh), kw)
        pyr = [p.float() for p in pyr]
        los = deep_supervision_loss(pyr, true_oh, criterion, ds=cfg.ds, coff_ds=cfg.coff_ds)
        metrics = {"los": los}
        for name, coff in (("udh", cfg.coff_udh), ("reg", cfg.coff_reg), ("epl", cfg.coff_epl)):
            if name in aux:
                metrics[name] = aux[name].float()
                los = los + metrics[name] * coff
        metrics["total"] = los
        new_bs = {}
        for m, (mean, var) in new_stats.items():
            new_bs[bn_names[m] + ".running_mean"] = mean
            new_bs[bn_names[m] + ".running_var"] = var
        return los, (new_bs, metrics)

    return loss_fn


def build_train_step(model: torch.nn.Module, optimizer: AdamW, cfg: TrainConfig,
                     device="cuda", generator: Optional[torch.Generator] = None) -> Callable:
    """``step(imgs_u8 [B,H,W,3], labs_u8 [B,H,W]) -> (metrics, new BN
    statistics)``: one train step of ``model`` (a ``RegNet``, moved to
    ``device`` in channels_last), updating its parameters and BN running
    statistics in place.  The inputs are uint8 numpy arrays or tensors.
    ``generator`` (on ``device``) draws the DropPath masks and the
    boundary loss's noise; it may be None only when neither needs one.
    The metrics are 0-d f32 tensors on ``device`` (no host sync)."""
    if cfg.augment:
        raise NotImplementedError("the augmentation graph is not ported yet (ROADMAP A8)")
    device = torch.device(device)
    model.to(device=device, memory_format=torch.channels_last).train()
    loss_fn = build_loss_fn(model, cfg)
    params = trainable_parameters(model)
    names = list(params)

    def train_step(imgs_u8, labs_u8):
        imgs = torch.as_tensor(imgs_u8).to(device)
        labs = torch.as_tensor(labs_u8).to(device)
        img = (imgs.float() / 255.0).to(cfg.dtype)
        true_oh = F.one_hot(labs.long(), cfg.n_class).float()
        buffers = dict(model.named_buffers())
        loss, (new_bs, metrics) = loss_fn(params, buffers, img, true_oh, generator)
        grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
        grads = [torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, grads)]
        metrics["grad_norm"] = optimizer.update([params[k] for k in names], grads)
        with torch.no_grad():
            for k, v in new_bs.items():
                buffers[k].copy_(v)
        return {k: v.detach() for k, v in metrics.items()}, new_bs

    return train_step
