"""MPViT multi-path transformer branch (reference task1/nets/tcct.py:29-800;
JAX counterpart ``tcct_tpu/models/mpvit.py``).

The token mixer is ``MPViTConfig.mixer``, as in the JAX package:

- ``metapool`` (alias ``metapool_pallas``) — the 3x3 average pool over the
  *(token, channel)* axes of the [B, N, C] tokens minus identity, which is
  what the shipped checkpoints were trained with.  It runs the MetaPool
  kernel (``ops/kernels/metapool.py``); an eval block with no gradient
  wanted runs its whole token pass around the mixer (``norm1``, the mixer,
  the residual add, ``norm2``) as one launch of it (``metapool_block``).
- ``metapool2d`` — the PoolFormer spatial pool the reference meant
  (``ops/pool.py::metapool_spatial``); not checkpoint compatible.
- ``factor`` — factorized attention, softmax(K)^T V then Q (K^T V), plus
  the convolutional relative position encoding (CRPE).
- ``hydra`` — hydra attention on cosine-normalised Q and K, plus the CRPE.

With ``factor`` and ``hydra`` the CRPE's head split (the reference's
{3: 2, 5: 3, 7: 3} for 8 heads) is refit to the stage's head count
(:func:`_fit_crpe_window`), as the JAX package does; its window-3 convs are
depthwise 3x3 and run the depthwise kernel, its 5x5 and 7x7 convs cuDNN.
The einsums and softmaxes run in the compute dtype, as JAX's do.  Every
depthwise 3x3 of the branch runs the depthwise kernel through
``layers.Conv2d``.

Off a width shard, each call of an attention mixer (with its CRPE) is a
``mixer.attention`` span (``utils/tracing.py``); the MetaPool mixers record
none.

With the MetaPool mixers the CRPE convs (at the reference's split) and
with every mixer the classification head exist for state-dict
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
from tcct_tpu_torch.ops.kernels.metapool import (
    metapool_block,
    metapool_block_shard,
    metapool_tokens,
)
from tcct_tpu_torch.ops.pool import metapool_spatial, metapool_spatial_shard
from tcct_tpu_torch.utils.tracing import span

MIXERS = ("metapool", "metapool_pallas", "metapool2d", "factor", "hydra")
CRPE_MIXERS = ("factor", "hydra")  # the mixers that run the CRPE
_METAPOOL = ("metapool", "metapool_pallas")  # the MetaPool kernel's mixer, by both names


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
    mixer: str = "metapool"  # one of MIXERS
    # reference crpe head-split table (tcct.py:482-486): {window: heads}
    crpe_window: Tuple[Tuple[int, int], ...] = ((3, 2), (5, 3), (7, 3))

    def __post_init__(self):
        if self.mixer not in MIXERS:
            raise ValueError(f"unknown mixer {self.mixer!r}; have {MIXERS}")


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


def _fit_crpe_window(window, num_heads: int):
    """Rescale a ((window, heads), ...) split so the heads sum to
    ``num_heads``: proportionally, floored, the remainder to the largest
    fractional parts (JAX ``tcct_tpu/models/mpvit.py::_fit_crpe_window``)."""
    total = sum(hs for _, hs in window)
    if total == num_heads:
        return window
    raw = [(w, hs * num_heads / total) for w, hs in window]
    out = [[w, max(int(f), 0)] for w, f in raw]
    rem = num_heads - sum(hs for _, hs in out)
    order = sorted(range(len(raw)), key=lambda i: raw[i][1] - int(raw[i][1]), reverse=True)
    for i in range(rem):
        out[order[i % len(out)]][1] += 1
    return tuple((w, hs) for w, hs in out if hs > 0)


class ConvRelPosEnc(nn.Module):
    """Convolutional relative position encoding (reference tcct.py:219-287):
    per head group a depthwise conv of V (window 3, 5 or 7), gating Q.  The
    MetaPool mixers never apply it; it then exists so the state dict
    matches the reference's."""

    def __init__(self, ch_per_head: int, window):
        super().__init__()
        self.conv_list = nn.ModuleList(
            conv2d(hs * ch_per_head, hs * ch_per_head, win, 1, win // 2, groups=hs * ch_per_head)
            for win, hs in window
        )

    def forward(self, q, v, size):
        """q, v: [B, heads, N, Ch] -> ``q * conv(v)``, the same shape."""
        B, h, N, Ch = q.shape
        v_img = tokens_to_image(v.transpose(1, 2).reshape(B, N, h * Ch), size)
        outs, off = [], 0
        for conv in self.conv_list:
            outs.append(conv(v_img[:, off:off + conv.in_channels]))
            off += conv.in_channels
        conv_v = image_to_tokens(torch.cat(outs, dim=1)).reshape(B, N, h, Ch).transpose(1, 2)
        return q * conv_v


def _heads(qkv: torch.Tensor, num_heads: int):
    """[B, N, 3C] -> q, k, v, each [B, heads, N, C // heads]."""
    B, N, C3 = qkv.shape
    return qkv.reshape(B, N, 3, num_heads, C3 // (3 * num_heads)).permute(2, 0, 3, 1, 4)


def _merge_heads(att: torch.Tensor) -> torch.Tensor:
    B, h, N, ch = att.shape
    return att.transpose(1, 2).reshape(B, N, h * ch)


def _factor_kv_shard(k: torch.Tensor, v: torch.Tensor, shard) -> torch.Tensor:
    """Factor's ``softmax(K)^T V`` over all tokens of a width shard's
    [B, heads, n, ch] ``k`` and ``v``: the softmax's per-(B, head, channel)
    max and sum of exponentials, then the partial ``k^T v`` [B, heads, ch,
    ch], each all-reduced over the ``'model'`` group (three reductions).
    The partials are f32; the softmax output and ``kv`` are rounded to k's
    dtype, where the one-process path rounds them."""
    m = torch.amax(k.float(), dim=2, keepdim=True)
    shard.all_reduce_(m, "max")
    e = torch.exp(k.float() - m)
    s = shard.all_reduce_(e.sum(dim=2, keepdim=True))
    p = (e / s).to(k.dtype)
    kv = shard.all_reduce_(torch.einsum("bhnk,bhnv->bhkv", p.float(), v.float()))
    return kv.to(k.dtype)


class FactorAttention(nn.Module):
    """Factorized attention: softmax over tokens of K, ``kv = K^T V``,
    ``Q kv`` scaled, plus the CRPE (reference tcct.py:289-341).  Under a
    width shard the reductions over the tokens are all-reduces
    (:func:`_factor_kv_shard`)."""

    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, size, crpe: ConvRelPosEnc):
        q, k, v = _heads(self.qkv(x), self.num_heads)
        if self.width_shard is not None:
            kv = _factor_kv_shard(k, v, self.width_shard)
        else:
            kv = torch.einsum("bhnk,bhnv->bhkv", torch.softmax(k, dim=2), v)
        att = torch.einsum("bhnk,bhkv->bhnv", q, kv)
        att = q.shape[-1] ** -0.5 * att + crpe(q, v, size)
        return self.proj(_merge_heads(att))


class HydraAttention(nn.Module):
    """Hydra attention: Q and K normalised to unit rows, ``kv = sum_n k *
    v``, ``q * kv`` scaled, plus the CRPE on the normalised Q (reference
    tcct.py:343-403).  Under a width shard the f32 partial sum of ``k * v``
    is all-reduced over the ``'model'`` group and rounded to x's dtype."""

    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, size, crpe: ConvRelPosEnc):
        q, k, v = _heads(self.qkv(x), self.num_heads)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        if self.width_shard is not None:
            kv = self.width_shard.all_reduce_((k * v).float().sum(dim=-2, keepdim=True))
            kv = kv.to(k.dtype)
        else:
            kv = torch.sum(k * v, dim=-2, keepdim=True)
        att = q.shape[-1] ** -0.5 * (q * kv) + crpe(q, v, size)
        return self.proj(_merge_heads(att))


class MHCABlock(nn.Module):
    """Pre-norm mixer + MLP block with the encoder's shared CPE/CRPE
    (reference tcct.py:417-469).  ``att`` exists for the attention mixers
    only.  Under a width shard (serving) the MetaPool site runs on the
    rank's columns with the wrapped halo tokens of the ranks beside it
    (``ops/kernels/metapool.py::metapool_block_shard``); ``metapool2d``
    takes a one-column halo of the ``norm1`` tokens a side
    (``ops/pool.py::metapool_spatial_shard``), and the attention mixers
    all-reduce over the tokens."""

    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, dim, mlp_ratio, cpe, crpe, drop_path: float = 0.0,
                 mixer: str = "metapool", num_heads: int = 4):
        super().__init__()
        self.mixer = mixer
        self.cpe = cpe
        self.crpe = crpe
        if mixer in CRPE_MIXERS:
            self.att = (FactorAttention if mixer == "factor" else HydraAttention)(dim, num_heads)
        self.norm1 = layer_norm(dim)
        self.norm2 = layer_norm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim)
        self.drop_path = DropPath(drop_path)

    def _mix(self, x, size):
        if self.mixer in _METAPOOL:
            return metapool_tokens(x)
        if self.mixer == "metapool2d":
            shard = self.width_shard
            if shard is None:
                return metapool_spatial(x, size)
            B, _, C = x.shape
            lh, rh = shard.halos(x.reshape(B, size[0], size[1], C), 1, 1)
            return metapool_spatial_shard(x, size, lh, rh, *shard.level(size[1]))
        if self.width_shard is not None:
            return self.att(x, size, self.crpe)
        with span("mixer.attention", tokens=x.shape[1], dim=x.shape[2],
                  heads=self.att.num_heads):
            return self.att(x, size, self.crpe)

    def _site_shard(self, x, size):
        """The serving site on a width shard: (y, n2) of the rank's tokens."""
        shard = self.width_shard
        if self.training or torch.is_grad_enabled():
            raise NotImplementedError("a width shard serves the MetaPool mixer in eval mode "
                                      f"without a gradient; training={self.training}")
        B, _, C = x.shape
        lh, rh = shard.halos(x.reshape(B, size[0], size[1], C), 1, 1, wrap=True)
        return metapool_block_shard(x, lh[:, :, 0], rh[:, :, 0], shard.rank == 0,
                                    shard.rank == shard.size - 1, self.norm1.weight,
                                    self.norm1.bias, self.norm2.weight, self.norm2.bias,
                                    self.norm1.eps)

    def forward(self, x, size):
        x = self.cpe(x, size)
        if self.mixer in _METAPOOL and self.width_shard is not None:
            x, n2 = self._site_shard(x, size)
            return x + self.drop_path(self.mlp(n2))
        if self.mixer in _METAPOOL and not self.training and not torch.is_grad_enabled():
            # serving: one launch
            x, n2 = metapool_block(x, self.norm1.weight, self.norm1.bias, self.norm2.weight,
                                   self.norm2.bias, self.norm1.eps)
            return x + self.drop_path(self.mlp(n2))
        x = x + self.drop_path(self._mix(self.norm1(x), size))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class MHCAEncoder(nn.Module):
    """Stack of MHCA blocks sharing one CPE and one CRPE
    (reference tcct.py:471-516).  A shared module appears in the state dict
    under both the encoder and every block, as in the reference."""

    def __init__(self, dim, num_layers, num_heads, mlp_ratio, crpe_window, drop_paths,
                 mixer: str = "metapool"):
        super().__init__()
        self.cpe = ConvPosEnc(dim, k=3)
        if mixer in CRPE_MIXERS:
            crpe_window = _fit_crpe_window(crpe_window, num_heads)
        self.crpe = ConvRelPosEnc(dim // num_heads, crpe_window)
        self.MHCA_layers = nn.ModuleList(
            MHCABlock(dim, mlp_ratio, self.cpe, self.crpe, drop_paths[i], mixer, num_heads)
            for i in range(num_layers)
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
                 crpe_window, drop_paths, mixer: str = "metapool"):
        super().__init__()
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(embed_dim, num_layers, num_heads, mlp_ratio, crpe_window, drop_paths,
                        mixer)
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
                c.mixer,
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
