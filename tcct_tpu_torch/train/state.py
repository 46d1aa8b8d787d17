"""The optimizer (JAX counterpart ``tcct_tpu/train/state.py``): AdamW with
the semantics of ``optax.chain(clip_by_global_norm(12), adamw(...))``, the
reference recipe (task1/kite/loopback.py:126-128, loop_seg.py:128).

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
Checkpointing waits for the engine.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from tcct_tpu_torch.models.ftc import unused_prefixes
from tcct_tpu_torch.train.schedule import cyclic_lr, make_stepwise

# modules no forward runs, so the JAX model never creates them: they have
# no gradient and no optimizer state (the CRPE convs and the classification
# head of the MetaPool MPViT)
_NEVER_RUN = ("crpe", "cls_head")
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


def trainable_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """The parameters the train step updates, by state-dict name: every
    parameter of the JAX model's tree (shared ones once).  That is all but
    the modules the model's flags switch off (:func:`unused_prefixes`,
    ``fuse`` among them) and those no forward runs."""
    unused = unused_prefixes(model)
    return {k: p for k, p in model.named_parameters()
            if not k.startswith(unused) and not any(part in _NEVER_RUN for part in k.split("."))}


class AdamW:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr,
    weight_decay=weight_decay))``, stepping a list of f32 parameters in
    place."""

    def __init__(self, lr: Union[float, Callable[[int], float]], weight_decay: float = 2e-4,
                 clip_norm: float = 12.0):
        self.lr = lr
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.count = 0
        self.mu: Optional[List[torch.Tensor]] = None
        self.nu: Optional[List[torch.Tensor]] = None

    def _lr(self) -> float:
        return self.lr(self.count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor]) -> torch.Tensor:
        """One step: clip ``grads`` by their global norm, then the AdamW
        update of ``params`` in place.  Returns the global norm (before
        clipping) as a 0-d tensor, without a host sync."""
        if self.mu is None:
            self.mu = [torch.zeros_like(p) for p in params]
            self.nu = [torch.zeros_like(p) for p in params]
        norm = torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())
        # optax: select(norm < clip_norm, g, g / norm * clip_norm)
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm), self.clip_norm)
        keep = norm < self.clip_norm
        grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

        lr = self._lr()
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
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS))
        u = torch._foreach_add(u, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(u, -lr))
        return norm


def make_optimizer(steps_per_epoch: int, lr: Optional[float] = None, weight_decay: float = 2e-4,
                   clip_norm: float = 12.0, base_lr: float = 1e-6,
                   max_lr: float = 1e-4) -> AdamW:
    """AdamW + the per-epoch cyclic learning rate + clip 12 (the reference
    recipe); ``lr`` replaces the schedule with a constant."""
    sched = lr if lr is not None else make_stepwise(
        lambda e: cyclic_lr(e, base_lr, max_lr), steps_per_epoch)
    return AdamW(sched, weight_decay=weight_decay, clip_norm=clip_norm)
