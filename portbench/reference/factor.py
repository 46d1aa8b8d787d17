"""The plain reference with MPViT's own token mixer: ``model.py``'s network
with each MHCA block's MetaPool replaced by factorized attention and the
convolutional relative position encoding (CRPE).

Lee et al., "MPViT: Multi-Path Vision Transformer for Dense Prediction",
CVPR 2022 (arXiv:2112.11010, github.com/youngwanLEE/MPViT): the MHCA block's
mixer is CoaT's factorized attention (Xu et al., ICCV 2021), which TCCT
ships as ``FactorAtt_ConvRelPosEnc`` (github.com/tyb311/TCCT,
task1/nets/tcct.py:289-341).  For a block of C channels, h heads of
d = C / h channels and N tokens on an (H, W) grid:

- ``q, k, v`` = the heads of ``qkv(x)`` (one linear layer, C to 3C, with
  bias), each [B, h, N, d];
- ``kv = softmax_N(k)^T v`` (the softmax over the tokens), [B, h, d, d];
- ``att = d ** -0.5 * (q kv) + q * crpe(v)``, where ``crpe`` runs a
  depthwise convolution of window w over v on the token grid, per group of
  heads: {3: 2, 5: 3, 7: 3} heads at 8 (the first 2 heads' channels take
  the 3x3, the next 3 the 5x5, the last 3 the 7x7), zero-padded to keep
  the grid;
- the output is ``proj`` (C to C, with bias) of the heads merged back.

The CRPE convolutions are the encoder's, shared by its blocks, the ones
``model.py`` builds and keeps out of training (``FROZEN_PARTS``); here they
are run, and trained.  Every state-dict name is the program's
(``MHCA_layers.<i>.att.qkv``, ``.att.proj``; the CRPE's
``crpe.conv_list.<j>``).

Departures from ``tcct.py:289-341``, none of which changes the function:

- the attention's and the projection's dropouts are left out (their rate
  is 0, and the check runs in eval mode);
- the CRPE's head split is taken from the configuration's heads as the
  reference's {3: 2, 5: 3, 7: 3} table, which needs no refit at 8 heads;
  any other head count raises;
- layouts are NCHW for the convolutions and [B, h, N, d] for the heads, and
  the products are written as batched matrix products instead of
  ``einsum``; everything runs in the input's type (f32 for the check);
- every linear layer and convolution goes through ``model.py``'s ``run``,
  so the control's fp8 roundings reach the attention's ``qkv``, ``proj``
  and the CRPE as they reach every other layer; the softmax and the two
  products stay in the control's bf16.

:func:`calibrate` gives the attention the weight it has in a trained
network before it sets the BatchNorm statistics.  At the benchmark's seeded
scale (``scans.fill_weights``: linear layers N(0, 0.02), depthwise
convolutions He-normal over fan-out) each mixer's output is about 0.2 % of
the residual stream it is added to, under bf16's rounding, so a check of the
served maps would not see the attention at all.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from . import model
from .model import Ctx, drop_path

# the reference's CRPE split, (window, heads), for 8 heads
CRPE_WINDOW = ((3, 2), (5, 3), (7, 3))
# the modules no forward of the model runs: the reference's dead `fuse` and
# MPViT's classifier
FROZEN_PARTS = ("fuse", "cls_head")


class FactorAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = model.Linear(dim, 3 * dim)
        self.proj = model.Linear(dim, dim)

    def run(self, x, size, crpe: model.ConvRelPosEnc, ctx: Ctx):
        B, N, C = x.shape
        h, d = self.heads, C // self.heads
        q, k, v = self.qkv.run(x, ctx).reshape(B, N, 3, h, d).permute(2, 0, 3, 1, 4)
        kv = torch.softmax(k, dim=2).transpose(2, 3) @ v  # [B, h, d, d]
        att = d ** -0.5 * (q @ kv) + q * conv_rel_pos(crpe, v, size, ctx)
        return self.proj.run(att.transpose(1, 2).reshape(B, N, C), ctx)

    def match(self, out, residual):
        """Scale ``proj`` (weight and bias) so that ``out``, this mixer's
        output, has the root mean square of ``residual``; the scaled output."""
        s = residual.pow(2).mean().sqrt() / out.pow(2).mean().sqrt()
        self.proj.weight.mul_(s)
        self.proj.bias.mul_(s)
        return out * s


def conv_rel_pos(crpe: model.ConvRelPosEnc, v, size, ctx: Ctx):
    """The CRPE's convolutions of ``v`` [B, h, N, d] on the token grid,
    each over its group of heads' channels, in the heads' layout."""
    B, h, N, d = v.shape
    img = v.transpose(2, 3).reshape(B, h * d, size[0], size[1])
    outs, off = [], 0
    for conv in crpe.conv_list:
        outs.append(conv.run(img[:, off:off + conv.in_channels], ctx))
        off += conv.in_channels
    return torch.cat(outs, dim=1).reshape(B, h, d, N).transpose(2, 3)


class MHCABlock(model.MHCABlock):
    """``model.py``'s block with factorized attention as its mixer."""

    def __init__(self, dim, mlp_ratio, cpe, crpe, rate, heads):
        super().__init__(dim, mlp_ratio, cpe, crpe, rate)
        self.att = FactorAttention(dim, heads)

    def run(self, x, size, ctx):
        B, N, C = x.shape
        img = x.reshape(B, size[0], size[1], C).permute(0, 3, 1, 2)
        x = x + self.cpe.proj.run(img, ctx).permute(0, 2, 3, 1).reshape(B, N, C)
        a = self.att.run(self.norm1(x), size, self.crpe, ctx)
        if isinstance(ctx, _Matching):
            a = self.att.match(a, x)
        x = x + drop_path(a, self.rate, ctx)
        return x + drop_path(self.mlp.run(self.norm2(x), ctx), self.rate, ctx)


class RegNet(model.RegNet):
    """``model.py``'s ``RegNet`` whose MHCA blocks attend."""

    def __init__(self, cfg: dict, n_class: int, variant: str):
        super().__init__(cfg, n_class, variant)
        v = cfg["mpvit"]
        for i, stage in enumerate(self.base.base_vit.mhca_stages):
            heads = v["num_heads"][i]
            if sum(hs for _, hs in CRPE_WINDOW) != heads:
                raise ValueError(f"the CRPE's split {CRPE_WINDOW} is for 8 heads; stage {i} "
                                 f"has {heads}")
            for enc in stage.mhca_blks:
                enc.MHCA_layers = nn.ModuleList(
                    MHCABlock(v["embed_dims"][i], v["mlp_ratios"][i], enc.cpe, enc.crpe,
                              blk.rate, heads)
                    for blk in enc.MHCA_layers)


class _Matching(Ctx):
    """A train-mode forward (BatchNorm on the batch's statistics) in which
    each block's attention is scaled as it runs (:meth:`FactorAttention.match`)."""

    def __init__(self):
        super().__init__(train=True)


@torch.no_grad()
def calibrate(model_: RegNet, x: torch.Tensor) -> None:
    """Give the attention a trained network's scale on the NCHW image batch
    ``x``, then set every BatchNorm's running statistics (``model.py``'s
    ``calibrate``).  ``qkv`` is rescaled to a standard deviation of
    C ** -0.5 (its fan-in), each CRPE convolution to 1 / w (its w x w taps),
    and then, block by block in one train-mode forward, ``proj`` so that
    each mixer's output has the root mean square of the residual stream it
    is added to."""
    for m in model_.modules():
        if isinstance(m, FactorAttention):
            _rescale(m.qkv.weight, m.qkv.in_features ** -0.5)
        elif isinstance(m, model.ConvRelPosEnc):
            for conv in m.conv_list:
                _rescale(conv.weight, 1.0 / conv.kernel_size[0])
    model_.base.run(x, _Matching())
    model.calibrate(model_, x)


def _rescale(w: torch.Tensor, std: float) -> None:
    w.mul_(std / w.std())


def trained_parameters(model_: RegNet) -> Dict[str, nn.Parameter]:
    """The parameters a train step updates, by state-dict name (a shared
    module's once): all but :data:`FROZEN_PARTS`, the CRPE's included."""
    return {k: p for k, p in model_.named_parameters()
            if not any(part in FROZEN_PARTS for part in k.split("."))}
