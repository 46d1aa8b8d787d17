"""MPViT multi-path transformer branch with the MetaPool token mixer
(reference task1/nets/tcct.py:29-800; JAX counterpart
``tcct_tpu/models/mpvit.py``).

Only the ``metapool`` mixer is ported: the 3x3 average pool over the
*(token, channel)* axes of the [B, N, C] tokens minus identity, which is
what the shipped checkpoints were trained with.  It runs the MetaPool
kernel (``ops/kernels/metapool.py``); an eval block with no gradient wanted
runs its whole token pass around the mixer (``norm1``, the mixer, the
residual add, ``norm2``) as one launch of it (``metapool_block``).  Every
depthwise 3x3 of the branch runs the depthwise kernel through
``layers.Conv2d``.

The CRPE convs and the classification head exist for state-dict
compatibility with the reference and are never run.  In train mode the
blocks' DropPath rates rise linearly from 0 to ``drop_path_rate``
(:func:`dpr_schedule`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcct_tpu_torch.models.layers import (
    ConvBN,
    DropPath,
    DWConvBN,
    Mlp,
    ResBlock,
    conv2d,
    layer_norm,
)
from tcct_tpu_torch.ops.kernels.metapool import metapool_block, metapool_tokens


@dataclasses.dataclass(frozen=True)
class MPViTConfig:
    """MPViT hyperparameters (reference factories tcct.py:766-800); the
    defaults are MPViT-tiny's."""

    num_stages: int = 4
    num_path: Tuple[int, ...] = (1, 1, 1, 1)
    num_layers: Tuple[int, ...] = (1, 1, 1, 1)
    embed_dims: Tuple[int, ...] = (64, 96, 128, 160)
    mlp_ratios: Tuple[int, ...] = (1, 1, 1, 1)
    num_heads: Tuple[int, ...] = (4, 4, 4, 4)
    drop_path_rate: float = 0.1
    # reference crpe head-split table (tcct.py:482-486): {window: heads}
    crpe_window: Tuple[Tuple[int, int], ...] = ((3, 2), (5, 3), (7, 3))


def mpvit_tiny_config(**kw) -> MPViTConfig:
    return MPViTConfig(**kw)


def mpvit_small_config(**kw) -> MPViTConfig:
    return MPViTConfig(num_path=(2, 3, 3, 3), num_layers=(1, 3, 6, 3),
                       embed_dims=(64, 128, 216, 288), mlp_ratios=(4, 4, 4, 4),
                       num_heads=(8, 8, 8, 8), **kw)


def mpvit_base_config(**kw) -> MPViTConfig:
    return MPViTConfig(num_path=(2, 3, 3, 3), num_layers=(1, 3, 8, 3),
                       embed_dims=(128, 224, 368, 480), mlp_ratios=(4, 4, 4, 4),
                       num_heads=(8, 8, 8, 8), **kw)


def dpr_schedule(drop_path_rate: float, num_layers: Sequence[int]) -> List[List[float]]:
    """Linear drop-path rates over all blocks, split per stage (reference
    tcct.py:635-647; JAX ``tcct_tpu/models/mpvit.py::dpr_schedule``)."""
    total = sum(num_layers)
    flat = [drop_path_rate * i / (total - 1) for i in range(total)] if total > 1 else [0.0] * total
    out, cur = [], 0
    for n in num_layers:
        out.append(flat[cur:cur + n])
        cur += n
    return out


def tokens_to_image(x: torch.Tensor, size) -> torch.Tensor:
    """[B, N, C] tokens -> NCHW view in the channels_last format."""
    B, _, C = x.shape
    return x.reshape(B, size[0], size[1], C).permute(0, 3, 1, 2)


def image_to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W, C] tokens (a view when x is channels_last)."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


class ConvPosEnc(nn.Module):
    """Depthwise 3x3 conv positional encoding + residual, on tokens
    (reference tcct.py:197-217)."""

    def __init__(self, dim: int, k: int = 3):
        super().__init__()
        self.proj = conv2d(dim, dim, k, 1, k // 2, groups=dim)

    def forward(self, x, size):
        feat = tokens_to_image(x, size)
        return image_to_tokens(self.proj.plus_input(feat))


class ConvRelPosEnc(nn.Module):
    """CRPE parameters (reference tcct.py:219-287).  The MetaPool mixer
    never applies them; they exist so the state dict matches the
    reference's."""

    def __init__(self, ch_per_head: int, window):
        super().__init__()
        self.conv_list = nn.ModuleList(
            conv2d(hs * ch_per_head, hs * ch_per_head, win, 1, win // 2, groups=hs * ch_per_head)
            for win, hs in window
        )


class MHCABlock(nn.Module):
    """Pre-norm MetaPool mixer + MLP block with the encoder's shared
    CPE/CRPE (reference tcct.py:417-469)."""

    def __init__(self, dim, mlp_ratio, cpe, crpe, drop_path: float = 0.0):
        super().__init__()
        self.cpe = cpe
        self.crpe = crpe
        self.norm1 = layer_norm(dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, size):
        x = self.cpe(x, size)
        if not self.training and not torch.is_grad_enabled():  # serving: one launch
            x, n2 = metapool_block(x, self.norm1.weight, self.norm1.bias, self.norm2.weight,
                                   self.norm2.bias, self.norm1.eps)
            return x + self.drop_path(self.mlp(n2))
        x = x + self.drop_path(metapool_tokens(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class MHCAEncoder(nn.Module):
    """Stack of MHCA blocks sharing one CPE and one CRPE
    (reference tcct.py:471-516).  A shared module appears in the state dict
    under both the encoder and every block, as in the reference."""

    def __init__(self, dim, num_layers, num_heads, mlp_ratio, crpe_window, drop_paths):
        super().__init__()
        self.cpe = ConvPosEnc(dim, k=3)
        self.crpe = ConvRelPosEnc(dim // num_heads, crpe_window)
        self.MHCA_layers = nn.ModuleList(
            MHCABlock(dim, mlp_ratio, self.cpe, self.crpe, drop_paths[i]) for i in range(num_layers)
        )

    def forward(self, x, size):
        for layer in self.MHCA_layers:
            x = layer(x, size)
        return tokens_to_image(x, size)


class DWCPatchEmbed(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.patch_conv = DWConvBN(cin, cout, kernel_size=3, stride=stride, act=F.hardswish)

    def forward(self, x):
        return self.patch_conv(x)


class PatchEmbedStage(nn.Module):
    """Chained depthwise-conv patch embeds; the first is stride 2 on
    pooling stages (reference tcct.py:149-195)."""

    def __init__(self, embed_dim, num_path, is_pool):
        super().__init__()
        self.patch_embeds = nn.ModuleList(
            DWCPatchEmbed(embed_dim, embed_dim, 2 if is_pool and i == 0 else 1)
            for i in range(num_path)
        )

    def forward(self, x):
        outs = []
        for pe in self.patch_embeds:
            x = pe(x)
            outs.append(x)
        return outs


class MHCAStage(nn.Module):
    """Parallel path encoders + local ResBlock, concat, 1x1 aggregate
    (reference tcct.py:574-616)."""

    def __init__(self, embed_dim, out_embed_dim, num_layers, num_heads, mlp_ratio, num_path,
                 crpe_window, drop_paths):
        super().__init__()
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(embed_dim, num_layers, num_heads, mlp_ratio, crpe_window, drop_paths)
            for _ in range(num_path)
        )
        self.InvRes = ResBlock(embed_dim)
        self.aggregate = ConvBN(embed_dim * (num_path + 1), out_embed_dim, act=F.hardswish)

    def forward(self, inputs):
        outs = [self.InvRes(inputs[0])]
        for x, enc in zip(inputs, self.mhca_blks):
            outs.append(enc(image_to_tokens(x), x.shape[2:]))
        cat = torch.cat(outs, dim=1).contiguous(memory_format=torch.channels_last)
        return self.aggregate(cat)


class ClsHead(nn.Module):
    def __init__(self, dim, n_out=1000):
        super().__init__()
        self.cls = nn.Linear(dim, n_out)


class MPViT(nn.Module):
    """Multi-path ViT backbone (reference tcct.py:649-753).  Only
    :meth:`forward_features` is ported; ``cls_head`` is kept for the state
    dict and never run."""

    def __init__(self, cfg: MPViTConfig = MPViTConfig()):
        super().__init__()
        c = cfg
        self.stem = nn.Sequential(
            ConvBN(3, c.embed_dims[0] // 2, 3, 2, 1, act=F.hardswish),
            ConvBN(c.embed_dims[0] // 2, c.embed_dims[0], 3, 1, 1, act=F.hardswish),
        )
        self.patch_embed_stages = nn.ModuleList(
            PatchEmbedStage(c.embed_dims[i], c.num_path[i], is_pool=i != 0)
            for i in range(c.num_stages)
        )
        dpr = dpr_schedule(c.drop_path_rate, c.num_layers)
        self.mhca_stages = nn.ModuleList(
            MHCAStage(
                c.embed_dims[i],
                c.embed_dims[i + 1] if i + 1 != c.num_stages else c.embed_dims[i],
                c.num_layers[i],
                c.num_heads[i],
                c.mlp_ratios[i],
                c.num_path[i],
                c.crpe_window,
                dpr[i],
            )
            for i in range(c.num_stages)
        )
        self.cls_head = ClsHead(c.embed_dims[-1])

    def forward_features(self, x):
        x = self.stem(x)
        xs = []
        for pe, st in zip(self.patch_embed_stages, self.mhca_stages):
            x = st(pe(x))
            xs.append(x)
        return xs
