"""RegNet wrapper: base model + the paper's auxiliary losses (reference
task1/nets/reg.py; JAX counterpart ``tcct_tpu/models/regnet.py``).

``forward(x)`` is the base model's.  ``forward(x, true, ...)`` is
:meth:`RegNet.forward_with_losses`, the train step's forward: the base
model with its polarization feats, then the auxiliary losses on the main
head.  The wrapper owns:

- ``lap_reg`` — the learned grouped-conv Laplacian of the boundary loss;
  its depthwise 3x3 convs (``C = n_class - 1``) run the depthwise kernel;
- ``lap_map`` — the 1-channel smoothing head with the reference's
  ``nn.BatchNorm2d(1, 1)``, i.e. eps 1.0; its 1-channel 3x3 convs are
  depthwise too and run the same kernel;
- ``lap_epl`` — the edge-pixel head (``use_epl``);
- ``fcp.buf_grad`` — the frozen per-class prototypes of the polarization
  loss (``vec_grad`` and ``cos_dist`` are the reference's unused buffers);
- ``tau`` — a learnable scalar, kept for parity.

``con`` picks the polarization loss's distance to the prototypes:
``'cos'`` (the reference's default) or ``'mse'`` (``--type_udh=mse``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from tcct_tpu_torch.losses.boundary import boundary_regression_loss
from tcct_tpu_torch.losses.polar import feature_polarization_loss
from tcct_tpu_torch.models.layers import BatchNorm2d, conv2d


class _Prototypes(nn.Module):
    """The reference's ``fcp`` module: per-class prototype buffers."""

    def __init__(self, n_class: int, num_emb: int):
        super().__init__()
        self.register_buffer("vec_grad", torch.zeros(n_class, num_emb))
        self.register_buffer("cos_dist", torch.zeros(n_class * (n_class - 1) // 2))
        self.register_buffer("buf_grad", torch.zeros(n_class, num_emb))


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class RegNet(nn.Module):
    def __init__(self, base: nn.Module, out_channels: int = 5, num_emb: int = 32,
                 lap_reg_depth: int = 2, con: str = "cos"):
        super().__init__()
        nc = out_channels
        self.base = base
        self.con = con
        self.tau = nn.Parameter(torch.full((1,), 100.0))
        self.fcp = _Prototypes(nc, num_emb)
        self.lap_epl = nn.Sequential(conv2d(nc, 1, 3, 1, 1), conv2d(1, 1, 3, 1, 1))
        self.lap_reg = nn.Sequential(
            *(conv2d(nc - 1, nc - 1, 3, 1, 1, groups=nc - 1) for _ in range(lap_reg_depth))
        )
        # the reference's nn.BatchNorm2d(1, 1): eps = 1.0
        self.lap_map = nn.Sequential(
            conv2d(1, 1, 3, 1, 1), BatchNorm2d(1, eps=1.0), conv2d(1, 1, 3, 1, 1)
        )

    def forward(self, x, true: Optional[torch.Tensor] = None, cnn_feats=None, **loss_kw):
        """``forward(x)``: the base model's logit maps (``cnn_feats``: an
        FTC base's CNN pyramid computed outside).  With the one-hot ``true``:
        :meth:`forward_with_losses` (so ``torch.func.functional_call``
        reaches it)."""
        if true is None:
            return self.base(x) if cnn_feats is None else self.base(x, cnn_feats=cnn_feats)
        return self.forward_with_losses(x, true, **loss_kw)

    # -- the loss heads, on NHWC tensors ---------------------------------------

    def _lap_reg(self, x):
        return _nhwc(self.lap_reg(_nchw(x)))

    def _lap_map(self, x):
        return torch.sigmoid(_nhwc(self.lap_map(_nchw(x))))

    def _lap_epl(self, x):
        return torch.sigmoid(_nhwc(self.lap_epl(_nchw(x))))

    # -- auxiliary losses ------------------------------------------------------

    def regular_reg(self, pred, true, generator: Optional[torch.Generator] = None):
        """Boundary-regression loss (reference reg.py:109-156);
        ``generator=None`` pins its noise."""
        return boundary_regression_loss(pred, true, self._lap_reg, self._lap_map, generator)

    def regular_udh(self, feats, pred, true):
        """Feature-polarization loss (reference reg.py:86-105)."""
        return feature_polarization_loss(feats, pred, true, self.fcp.buf_grad, con=self.con)

    def regular_epl(self, pred, true):
        """Edge-pixel loss: lap_epl(softmax(pred)) against the GT boundary
        map (the JAX package's working form of the reference's ``--epl``)."""
        edge_pred = self._lap_epl(torch.softmax(pred, dim=-1))
        t = true.float()[..., 1:]
        d = torch.abs(t[:, 1:] - t[:, :-1])
        d = torch.cat([torch.zeros_like(d[:, :1]), d], dim=1)
        edge_true = torch.clamp(torch.sum(d, dim=-1, keepdim=True), 0.0, 1.0)
        return torch.mean((edge_pred - edge_true) ** 2)

    def forward_with_losses(self, x, true, generator: Optional[torch.Generator] = None,
                            use_udh: bool = False, use_reg: bool = False,
                            use_epl: bool = False):
        """NHWC image and one-hot ``true`` -> ``(logit maps, feats, aux)``:
        the base model (train variant for ``use_udh``) and the enabled
        auxiliary losses on the main head, in one forward.  ``generator``
        draws the boundary loss's noise (``None`` pins it)."""
        if use_udh:
            pyr, feats = self.base(x, with_feats=True)
        else:
            pyr, feats = self.base(x), None
        p0 = pyr[0]
        aux = {}
        if use_udh:
            aux["udh"] = self.regular_udh(feats, p0, true)
        if use_reg:
            aux["reg"] = self.regular_reg(p0, true, generator)
        if use_epl:
            aux["epl"] = self.regular_epl(p0, true)
        return pyr, feats, aux
