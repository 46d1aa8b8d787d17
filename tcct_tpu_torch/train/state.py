"""The train state, its checkpoints and the optimizer (JAX counterpart
``tcct_tpu/train/state.py``).

The optimizer is AdamW with the semantics of
``optax.chain(clip_by_global_norm(12), adamw(...))``, the reference recipe
(task1/kite/loopback.py:126-128, loop_seg.py:128).

It follows optax's arithmetic, not ``torch.optim.AdamW`` +
``clip_grad_norm_``:

- clip: when the global norm ``n`` of the gradients reaches ``clip_norm``,
  each gradient becomes ``g / n * clip_norm`` (``clip_grad_norm_`` divides
  by ``n + 1e-6`` instead);
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, bias
  corrections ``1 - b^t`` in f32, ``u = mu_hat / (sqrt(nu_hat) + eps)``;
- decoupled weight decay ``u + wd * p`` on every parameter, then
  ``p - lr * u``; the learning rate of step ``t`` (from 0) is ``lr(t)``.

Unlike optax it updates the parameters in place, to hold one copy of them.

A checkpoint holds the whole :class:`TrainState`: step and epoch, the f32
master parameters and BN statistics, AdamW's moments and count (the cyclic
learning rate reads the count), and the generator's state, so a resume
continues bit for bit (the reference's checkpoints keep only
{epoch, loss, lr}, task1/kite/loopback.py:105-121).  One directory per
name, as orbax lays them out, holding one ``torch.save`` file.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from tcct_tpu_torch.models.ftc import never_run, unused_prefixes
from tcct_tpu_torch.train.schedule import cyclic_lr, make_stepwise

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def trainable_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters the train step updates, by state-dict name: every
    parameter of the JAX model's tree (shared ones once).  That is all but
    the modules the model's flags switch off (:func:`unused_prefixes`,
    ``fuse`` among them) and those no forward runs (:func:`never_run`: the
    classifier, and the CRPE convs unless the mixer runs them), which the
    JAX model never creates and so has no gradient or optimizer state
    for."""
    unused, dead = unused_prefixes(model), never_run(model)
    return {k: p for k, p in model.named_parameters()
            if not k.startswith(unused) and not any(part in dead for part in k.split("."))}


class _Adam:
    """Adam's moments, count and learning rate, with optax's arithmetic."""

    def __init__(self, lr: Union[float, Callable[[int], float]], weight_decay: float):
        self.lr = lr
        self.weight_decay = weight_decay
        self.count = 0
        self.mu: Optional[List[torch.Tensor]] = None
        self.nu: Optional[List[torch.Tensor]] = None

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: Dict[str, Any], device=None) -> None:
        """Restore the count and the moments (moved to ``device``)."""
        self.count = int(state["count"])
        self.mu = None if state["mu"] is None else [t.to(device) for t in state["mu"]]
        self.nu = None if state["nu"] is None else [t.to(device) for t in state["nu"]]

    def _lr(self) -> float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    def _direction(self, params: List[torch.Tensor], grads: List[torch.Tensor]):
        """Advance the count and the moments by ``grads``; return the
        bias-corrected ``mu_hat / (sqrt(nu_hat) + eps)`` of each tensor."""
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        self.count += 1
        # bias corrections in f32, as optax forms them from its int32 count
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(self.count))
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1),
                                     torch._foreach_mul(self.mu, B1))
        self.nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2),
                                     torch._foreach_mul(self.nu, B2))
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        return torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS))


class AdamW(_Adam):
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr,
    weight_decay=weight_decay))``, stepping a list of f32 parameters in
    place."""

    def __init__(self, lr: Union[float, Callable[[int], float]], weight_decay: float = 2e-4,
                 clip_norm: float = 12.0):
        super().__init__(lr, weight_decay)
        self.clip_norm = clip_norm

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> torch.Tensor:
        """One step: clip ``grads`` by their global norm, then the AdamW
        update of ``params`` in place.  Returns the global norm (before
        clipping) as a 0-d tensor, without a host sync."""
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
        # optax: select(norm < clip_norm, g, g / norm * clip_norm)
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm), self.clip_norm)
        keep = norm < self.clip_norm
        grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        lr = self._lr()
        u = self._direction(params, grads)
        u = torch._foreach_add(u, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(u, -lr))
        return norm


class Adam(_Adam):
    """``optax.chain(add_decayed_weights(weight_decay), adam(lr))``: Adam with
    *coupled* L2 (``g + wd * p`` enters the moments; paddle's
    ``Adam(weight_decay=...)`` of the Task-2 reference, t2_train.py:172),
    not AdamW, and no clipping; steps a list of f32 parameters in place."""

    def __init__(self, lr: Union[float, Callable[[int], float]] = 1e-5,
                 weight_decay: float = 5e-4):
        super().__init__(lr, weight_decay)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        """One step of ``params`` in place, without a host sync."""
        lr = self._lr()
        grads = torch._foreach_add(grads, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(self._direction(params, grads), -lr))


def make_optimizer(steps_per_epoch: int, lr: Optional[float] = None, weight_decay: float = 2e-4,
                   clip_norm: float = 12.0, base_lr: float = 1e-6,
                   max_lr: float = 1e-4) -> AdamW:
    """AdamW + the per-epoch cyclic learning rate + clip 12 (the reference
    recipe); ``lr`` replaces the schedule with a constant."""
    sched = lr if lr is not None else make_stepwise(
        lambda e: cyclic_lr(e, base_lr, max_lr), steps_per_epoch)
    return AdamW(sched, weight_decay=weight_decay, clip_norm=clip_norm)


@dataclasses.dataclass
class TrainState:
    """What a train run carries from step to step: the model (its f32
    master parameters and BN statistics, updated in place), the optimizer
    (moments and count; ``step`` is its count), the generator of the
    augmentation, DropPath and boundary noise, and the epoch."""

    model: nn.Module
    optimizer: AdamW
    generator: torch.Generator
    epoch: int = 0

    @property
    def step(self) -> int:
        return self.optimizer.count

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "epoch": self.epoch,
                "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy a checkpoint's tensors into this state's (on their devices)."""
        device = next(self.model.parameters()).device
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"], device)
        self.generator.set_state(state["generator"])
        self.epoch = int(state["epoch"])
        if self.step != int(state["step"]):
            raise ValueError(f"checkpoint step {state['step']} != its optimizer count {self.step}")


CHECKPOINT_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, state: TrainState, name: str = "last") -> str:
    """Write ``state`` to ``<ckpt_dir>/<name>/state.pt``: into a temporary
    directory first, then renamed over the old one.  Returns the path."""
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state.state_dict(), os.path.join(tmp, CHECKPOINT_FILE))
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old)
    return path


def restore_checkpoint(ckpt_dir: str, state: TrainState, name: str = "last"
                       ) -> Optional[TrainState]:
    """Load ``<ckpt_dir>/<name>`` into ``state`` and return it, or None
    when that checkpoint does not exist."""
    path = os.path.join(os.path.abspath(os.path.join(ckpt_dir, name)), CHECKPOINT_FILE)
    if not os.path.isfile(path):
        return None
    state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return state
