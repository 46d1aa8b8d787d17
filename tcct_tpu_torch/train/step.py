"""The train and eval steps (JAX counterpart ``tcct_tpu/train/step.py``).

One train step: uint8 batch -> on-device augmentation (``cfg.augment``:
crop, flips, colour; ``data/augment.py``) -> one-hot -> train-mode forward
of the base model with the auxiliary losses (compute copies of the weights
in ``cfg.dtype``) -> deep-supervision Dice + the enabled auxiliary losses
-> gradients into the f32 masters -> clip 12 + AdamW -> the new BN running
statistics, f32, updated from the compute-dtype forward.  The step's
generator draws, in this order (the JAX step's key order), the
augmentation, a gated model's alpha maps, the DropPath masks and the
boundary loss's noise; each draw has a fixed shape, so a step repeats, and
resumes, bit for bit.  PyTorch runs it eagerly; on the card every
MetaPool mixer, depthwise 3x3 and train BatchNorm, forward and backward,
goes through the port's hand-written kernels.

The eval step is the eval-mode model in ``cfg.dtype`` on the val chain's
images (``apply_val``), argmax one-hots and the Dice/IoU scores.  The
epoch functions loop over an epoch on the device and return their metrics
as device tensors, without a host sync, as the JAX package's scans do.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from tcct_tpu_torch.data.augment import apply_train, apply_val, draw_train
from tcct_tpu_torch.losses.seg import (
    deep_supervision_loss,
    get_loss,
    mdice_scorem,
    mdice_scores,
    miou_scorem,
)
from tcct_tpu_torch.models.ftc import pinned_gate
from tcct_tpu_torch.models.layers import BatchNorm2d, train_pass
from tcct_tpu_torch.train.precision import cast_floating
from tcct_tpu_torch.train.state import AdamW, trainable_parameters


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Loss and step knobs (the JAX package's ``TrainConfig``, reference
    task1/kite/main.py:18-49).  ``pinned_reg_noise`` pins the boundary
    loss's noise (uniforms 0.5) and ``pinned_gate_noise`` a gated model's
    alpha maps (``models/ftc.py::pinned_alpha_nchw``) for cross-framework
    parity."""

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
    augment: bool = True
    dtype: torch.dtype = torch.float32
    pinned_reg_noise: bool = False
    pinned_gate_noise: bool = False


def _call(model: torch.nn.Module, variables: Dict[str, torch.Tensor], args, kwargs=None):
    """``functional_call`` with ``tie_weights=False``.  The model's shared
    modules (each MPViT stage's ConvPosEnc, reached by two paths) are then
    swapped once, under the one name ``variables`` holds, and restored
    once.  With ties on, ``functional_call`` swaps such a module under each
    of its names and restores the second name from the first swap, which
    leaves the compute copy (bf16) in the model in place of the f32 master.
    No two distinct modules of the port share a parameter."""
    return functional_call(model, variables, args, kwargs, tie_weights=False)


def build_loss_fn(model: torch.nn.Module, cfg: TrainConfig) -> Callable:
    """The training loss as a function of the f32 parameters:
    ``loss_fn(params, buffers, img, true_oh, generator) -> (loss,
    (new BN statistics, metrics))``.  ``params`` and ``buffers`` map
    state-dict names to tensors; compute copies in ``cfg.dtype`` go into
    ``model`` (a ``RegNet``, in train mode) through ``functional_call``.
    ``generator`` draws, unless pinned, a gated model's alpha maps, then the
    DropPath masks and, unless pinned, the boundary loss's noise."""
    criterion = get_loss(cfg.loss)
    bn_names = {m: name for name, m in model.named_modules() if isinstance(m, BatchNorm2d)}

    def loss_fn(params: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
                img: torch.Tensor, true_oh: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        variables = cast_floating({**params, **buffers}, cfg.dtype)
        kw = dict(generator=None if cfg.pinned_reg_noise else generator,
                  use_udh=cfg.udh, use_reg=cfg.reg, use_epl=cfg.epl)
        with train_pass(model, generator) as new_stats, pinned_gate(cfg.pinned_gate_noise):
            pyr, _, aux = _call(model, variables, (img, true_oh), kw)
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
    ``generator`` (on ``device``) draws the augmentation, a gated model's
    alpha maps, the DropPath masks and the boundary loss's noise; it may be
    None only when none of them needs one.  The metrics are 0-d f32 tensors on ``device`` (no host
    sync)."""
    if cfg.augment and generator is None:
        raise ValueError("augment=True draws from the step's generator; none was given")
    device = torch.device(device)
    model.to(device=device, memory_format=torch.channels_last).train()
    loss_fn = build_loss_fn(model, cfg)
    params = trainable_parameters(model)
    names = list(params)

    def train_step(imgs_u8, labs_u8):
        imgs = torch.as_tensor(imgs_u8).to(device)
        labs = torch.as_tensor(labs_u8).to(device)
        if cfg.augment:
            img, lab = apply_train(imgs, labs, draw_train(labs, generator, cfg.crop_hw),
                                   cfg.crop_hw)
        else:
            img, lab = imgs.float() / 255.0, labs.long()
        img = img.to(cfg.dtype)
        true_oh = F.one_hot(lab, cfg.n_class).float()
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


def build_train_epoch(model: torch.nn.Module, optimizer: AdamW, cfg: TrainConfig, device="cuda",
                      generator: Optional[torch.Generator] = None) -> Callable:
    """``train_epoch(imgs_u8, labs_u8, idx_plan) -> metrics``: one train
    step per row of the [steps, bs] index plan, each batch gathered from
    the device-resident split with ``index_select`` on the device.  The
    metrics come back stacked, [steps] f32 tensors on the device, with no
    host sync (what the JAX package's epoch scan returns)."""
    step = build_train_step(model, optimizer, cfg, device=device, generator=generator)

    def train_epoch(imgs_u8: torch.Tensor, labs_u8: torch.Tensor,
                    idx_plan: torch.Tensor) -> Dict[str, torch.Tensor]:
        series: Dict[str, list] = {}
        for bi in idx_plan:
            metrics, _ = step(imgs_u8.index_select(0, bi), labs_u8.index_select(0, bi))
            for k, v in metrics.items():
                series.setdefault(k, []).append(v)
        return {k: torch.stack(v) for k, v in series.items()}

    return train_epoch


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """The model in eval mode inside the block, its own mode restored after."""
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def _eval_variables(model: torch.nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Compute copies of every parameter and buffer in ``dtype``, as the JAX
    eval step casts its variables."""
    return cast_floating({**dict(model.named_parameters()), **dict(model.named_buffers())},
                         dtype)


def _scores(model: torch.nn.Module, variables, img: torch.Tensor, lab: torch.Tensor,
            n_class: int) -> Dict[str, torch.Tensor]:
    pyr = _call(model, variables, (img,))
    logits = (pyr[0] if isinstance(pyr, (list, tuple)) else pyr).float()
    pred_oh = F.one_hot(torch.argmax(torch.softmax(logits, -1), -1), n_class).float()
    true_oh = F.one_hot(lab, n_class).float()
    return {"val_f1s": mdice_scorem(pred_oh, true_oh, start_idx=1),
            "val_iou": miou_scorem(pred_oh, true_oh, start_idx=1),
            "scores": mdice_scores(pred_oh, true_oh)}


def build_eval_step(model: torch.nn.Module, cfg: TrainConfig, stochastic_val: bool = True,
                    device="cuda") -> Callable:
    """``eval_step(imgs_u8, labs_u8, flip_v) -> metrics``: the val chain
    (``apply_val``: with ``stochastic_val`` the reference's HFlip and the
    VFlips where ``flip_v``), the eval-mode ``model`` in ``cfg.dtype``
    without autograd, argmax one-hots, and ``val_f1s`` / ``val_iou`` (mean
    Dice / IoU of the classes past the background) and the per-class Dice
    ``scores``, each averaged over the batch, as tensors on ``device``."""
    device = torch.device(device)

    @torch.no_grad()
    def eval_step(imgs_u8, labs_u8, flip_v: torch.Tensor) -> Dict[str, torch.Tensor]:
        imgs = torch.as_tensor(imgs_u8).to(device)
        labs = torch.as_tensor(labs_u8).to(device)
        img, lab = apply_val(imgs, labs, flip_v.to(device), stochastic=stochastic_val)
        with eval_mode(model):
            return _scores(model, _eval_variables(model, cfg.dtype), img.to(cfg.dtype), lab,
                           cfg.n_class)

    return eval_step


def build_eval_epoch(model: torch.nn.Module, cfg: TrainConfig, stochastic_val: bool = True,
                     device="cuda") -> Callable:
    """``eval_epoch(imgs_u8, labs_u8, flip_v) -> metrics``: the whole val
    split at batch size 1, each scan as :func:`build_eval_step` computes it,
    the weights cast once; the sums stay on the device and the means come
    back as device tensors, for one host read at the end."""
    device = torch.device(device)

    @torch.no_grad()
    def eval_epoch(imgs_u8: torch.Tensor, labs_u8: torch.Tensor,
                   flip_v: torch.Tensor) -> Dict[str, torch.Tensor]:
        flip_v = flip_v.to(device)
        sums: Dict[str, torch.Tensor] = {}
        with eval_mode(model):
            variables = _eval_variables(model, cfg.dtype)
            n = imgs_u8.shape[0]
            for i in range(n):
                img, lab = apply_val(imgs_u8[i:i + 1], labs_u8[i:i + 1], flip_v[i:i + 1],
                                     stochastic=stochastic_val)
                for k, v in _scores(model, variables, img.to(cfg.dtype), lab,
                                    cfg.n_class).items():
                    sums[k] = sums[k] + v if k in sums else v
        return {k: v / n for k, v in sums.items()}

    return eval_epoch


def build_predict(model: torch.nn.Module, n_class: int) -> Callable:
    """``predict(img) -> one-hot``: the eval-mode model on an NHWC float
    image, its weights cast to the image's dtype, then softmax -> argmax ->
    one-hot (reference loop_seg.py:21-33)."""

    @torch.no_grad()
    def predict(img: torch.Tensor) -> torch.Tensor:
        with eval_mode(model):
            pyr = _call(model, _eval_variables(model, img.dtype), (img,))
        logits = pyr[0] if isinstance(pyr, (list, tuple)) else pyr
        return F.one_hot(torch.argmax(torch.softmax(logits, -1), -1), n_class)

    return predict
