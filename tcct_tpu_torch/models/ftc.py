"""FTC fusion + decoder (reference task1/nets/tcct.py:944-1046 and
task1/onnx/tcct_goals.py; JAX counterpart ``tcct_tpu/models/ftc.py``).

Two variants, as in the JAX package:

- ``variant='infer'`` — the architecture of the shipped checkpoints: the
  aux heads act on the raw skips and ``dec4`` takes ``c1``.  The forward
  returns the four logit maps (main head first); the predictor never
  reads the polarization feats, so they are not formed.
- ``variant='train'`` — the training architecture of the goldens: 1x1
  projections ``t321``-``t324`` of skip + decoder output feed the aux
  heads and the polarization feats ``norm_add([y0, y1p, y2p])``
  (``forward(x, with_feats=True)``).  Only the JAX package's unpacked
  branch is ported.

Fusion of a pyramid level, after the 1x1 conv + BN projections of the ViT
and the CNN features: their sum (simple fusion, ``stc_*``) or, with
``flag_gate`` (``gtc_*``), ``x1 * alpha + x2 * (1 - alpha)`` with alpha 0.5
in eval mode.  The random alpha map of gated fusion in train mode is not
ported yet (ROADMAP A.6) and raises.

``flag_vit=False`` (``cnnu``, ``pnnu``) decodes the CNN pyramid alone and
skips the ViT branch; ``flag_cnn=False`` (``vitu``) decodes the projected
ViT features with the CNN's level 0 as the last skip.  Every module exists
under every flag, as in the reference, so the state-dict names do not
depend on them.

``forward(x, cnn_feats=...)`` takes the CNN pyramid from outside (five NHWC
maps): the way the fused block kernel's branch
(``models/crosscnn.py::cross_resnet_fused``) enters.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tcct_tpu_torch.models.crosscnn import CrossResNet
from tcct_tpu_torch.models.layers import BatchNorm2d, conv2d, leaky_relu
from tcct_tpu_torch.models.mpvit import MPViT, MPViTConfig
from tcct_tpu_torch.ops.resize import resize_bilinear



def unused_prefixes(model: nn.Module) -> Tuple[str, ...]:
    """State-dict prefixes, in ``model`` (an :class:`FTC`, or a module that
    holds one as ``base``), of the modules its forward never runs under the
    FTC's flags (:meth:`FTC.unused_prefixes`)."""
    base = getattr(model, "base", model)
    prefix = "base." if base is not model else ""
    return tuple(prefix + p for p in getattr(base, "unused_prefixes", tuple)())

class MPUpBlock(nn.Module):
    """conv3-BN-LReLU -> 2x bilinear up (align_corners=True) -> +skip ->
    1x1 conv (reference tcct.py:887-914)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.prep = nn.Sequential(conv2d(cin, cout, 3, 1, 1), BatchNorm2d(cout))
        self.post = nn.Sequential(conv2d(cout, cout, 1, 1, 0))

    def forward(self, x1, x2=None):
        x1 = leaky_relu(self.prep(x1))
        x1 = resize_bilinear(x1, (x1.shape[2] * 2, x1.shape[3] * 2), align_corners=True)
        if x2 is not None:
            x1 = x1 + x2
        return self.post(x1)


def simple_fusion(x1, x2):
    return x1 + x2


def gate_fusion(x1, x2, train: bool = False):
    """Alpha-map gating (reference tcct.py:916-932) in eval mode: alpha 0.5.
    Train mode draws a random low-resolution alpha map and upsamples it
    bicubically; that waits for ``resize_bicubic`` and the gated goldens."""
    if train:
        raise NotImplementedError(
            "gated fusion in train mode (random alpha map, bicubic upsample, pinned_gate) is "
            "not ported yet: ROADMAP A.6")
    alpha = 0.5
    return x1 * alpha + x2 * (1.0 - alpha)


def norm_add(xs: List[torch.Tensor]) -> torch.Tensor:
    """L2-normalise each NCHW map over channels (floor 1e-12), resize to
    the first's size (bilinear, align_corners=False) and average
    (reference tcct.py:937-942)."""
    xs = [x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
          for x in xs]
    size = xs[0].shape[2:]
    xs = [resize_bilinear(x, size, align_corners=False) for x in xs]
    return sum(xs) / len(xs)


def _tran(cin, cout):
    return nn.Sequential(conv2d(cin, cout, 1, 1, 0), BatchNorm2d(cout))


class FTC(nn.Module):
    """Dual-branch fusion + U-decoder (reference tcct.py:944-1046 /
    onnx/tcct_goals.py for the ``infer`` variant)."""

    def __init__(self, vit_cfg: MPViTConfig = MPViTConfig(), cnn_tiny: bool = True,
                 out_channels: int = 5, filters: int = 32, variant: str = "infer",
                 cnn_plain: bool = False, flag_gate: bool = False, flag_cnn: bool = True,
                 flag_vit: bool = True):
        super().__init__()
        if variant not in ("infer", "train"):
            raise ValueError(f"FTC: variant must be 'infer' or 'train', got {variant!r}")
        self.variant = variant
        self.vit_cfg = vit_cfg
        self.flag_gate, self.flag_cnn, self.flag_vit = flag_gate, flag_cnn, flag_vit
        self.base_vit = MPViT(vit_cfg)
        self.base_cnn = CrossResNet(tiny=cnn_tiny, plain=cnn_plain)
        ld = self.base_cnn.layer_dims
        ed = vit_cfg.embed_dims
        vit_out = tuple(ed[1:]) + (ed[-1],)  # each stage's aggregate width
        for i, l in enumerate(ld[1:]):
            setattr(self, f"tran_vit{i}", _tran(vit_out[i], l))
            setattr(self, f"tran_cnn{i}", _tran(ld[i + 1], l))
        self.head = nn.Sequential(conv2d(ld[-1], ld[-1], 3, 1, 1), BatchNorm2d(ld[-1]))
        # `fuse` exists in the reference state dict but is unused (tcct.py:982)
        self.fuse = conv2d(filters, filters, 1, 1, 0)
        self.dec1 = MPUpBlock(ld[-1], ld[-2])
        self.dec2 = MPUpBlock(ld[-2], ld[-3])
        self.dec3 = MPUpBlock(ld[-3], ld[-4])
        self.dec4 = MPUpBlock(ld[-4], filters)
        if variant == "train":
            self.t321 = conv2d(ld[-2], filters, 1, 1, 0)
            self.t322 = conv2d(ld[-3], filters, 1, 1, 0)
            self.t323 = conv2d(ld[-4], filters, 1, 1, 0)
            self.t324 = conv2d(filters, filters, 1, 1, 0)
            aux_in = (filters, filters, filters, filters)
        else:
            aux_in = (filters, ld[-4], ld[-3], ld[-2])
        self.aux0 = conv2d(aux_in[0], out_channels, 1, 1, 0)
        self.aux1 = conv2d(aux_in[1], out_channels, 1, 1, 0)
        self.aux2 = conv2d(aux_in[2], out_channels, 1, 1, 0)
        self.aux4 = conv2d(aux_in[3], out_channels, 1, 1, 0)

    def unused_prefixes(self) -> Tuple[str, ...]:
        """State-dict prefixes of the modules this model's forward never
        runs under its flags (``fuse`` is dead in the reference too)."""
        unused = ["fuse."]
        if not self.flag_vit:
            unused += ["base_vit.", "tran_vit", "tran_cnn"]
        elif not self.flag_cnn:
            unused += ["tran_cnn"]
        return tuple(unused)

    def forward(self, x: torch.Tensor, with_feats: bool = False,
                cnn_feats: Optional[Sequence[torch.Tensor]] = None):
        """NHWC image [B,H,W,3] -> four NHWC logit maps [B,H,W,n_class];
        with ``with_feats`` (train variant only) -> ``(maps, [feat])``
        with the NHWC polarization feat [B,H,W,filters].  ``cnn_feats``: the
        CNN branch's five NHWC maps computed outside, instead of
        ``base_cnn``'s."""
        if with_feats and self.variant != "train":
            raise ValueError("FTC: the polarization feats are formed by variant='train' only")
        x = x.permute(0, 3, 1, 2)
        if cnn_feats is not None:
            c1, c2, c3, c4, c5 = (c.permute(0, 3, 1, 2) for c in cnn_feats)
        else:
            c1, c2, c3, c4, c5 = self.base_cnn(x)
        if self.flag_vit:
            vs = [getattr(self, f"tran_vit{i}")(v)
                  for i, v in enumerate(self.base_vit.forward_features(x))]
            if self.flag_cnn:
                cs = [getattr(self, f"tran_cnn{i}")(c) for i, c in enumerate((c2, c3, c4, c5))]
                if self.flag_gate:
                    x2, x3, x4, x5 = (gate_fusion(v, c, self.training) for v, c in zip(vs, cs))
                else:
                    x2, x3, x4, x5 = (simple_fusion(v, c) for v, c in zip(vs, cs))
            else:
                x2, x3, x4, x5 = vs
        else:
            x2, x3, x4, x5 = c2, c3, c4, c5
        y8 = leaky_relu(self.head(x5))
        y4 = self.dec1(y8, x4)
        y2 = self.dec2(y4, x3)
        y1 = self.dec3(y2, x2)
        y0 = self.dec4(y1, c1)
        size = x.shape[2:]
        if self.variant == "train":
            y0 = self.t324(c1 + y0)
            y1 = self.t323(x2 + y1)
            y2 = self.t322(x3 + y2)
            y4 = self.t321(x4 + y4)
        outs = [
            self.aux0(y0),
            resize_bilinear(self.aux1(y1), size, align_corners=False),
            resize_bilinear(self.aux2(y2), size, align_corners=False),
            resize_bilinear(self.aux4(y4), size, align_corners=False),
        ]
        outs = [o.permute(0, 2, 3, 1) for o in outs]
        if not with_feats:
            return outs
        return outs, [norm_add([y0, y1, y2]).permute(0, 2, 3, 1)]
