"""FTC fusion + decoder (reference task1/nets/tcct.py:944-1046,
task1/onnx/tcct_goals.py and nets/tcct32.py; JAX counterpart
``tcct_tpu/models/ftc.py``).

Three variants, as in the JAX package:

- ``variant='infer'`` — the architecture of the shipped checkpoints: the
  aux heads act on the raw skips and ``dec4`` takes ``c1``.  The forward
  returns the four logit maps (main head first); the predictor never
  reads the polarization feats, so they are not formed.
- ``variant='train'`` — the training architecture of the goldens: 1x1
  projections ``t321``-``t324`` of skip + decoder output feed the aux
  heads and the polarization feats ``norm_add([y0, y1p, y2p])``
  (``forward(x, with_feats=True)``).  Only the JAX package's unpacked
  branch is ported.
- ``variant='t32'`` — the ``tcct32`` development variant: every level
  projected to ``t32_filters`` channels, a 32-channel decoder fed through
  the 1x1 skip adapters ``skip1``-``skip3`` (the JAX package's repair of
  the published file, whose widths do not add up), feats
  ``norm_add([c1, skip3(x2), skip2(x3), y0, y1, y2])``.

Fusion of a pyramid level, after the 1x1 conv + BN projections of the ViT
and the CNN features: their sum (simple fusion, ``stc_*``) or, with
``flag_gate`` (``gtc_*``), ``x1 * alpha + x2 * (1 - alpha)``.  In eval mode
alpha is 0.5.  In train mode each level draws a [B, C, h, w] uniform map
(``h, w = max(3, H // 32), max(3, W // 32)``) from the train pass's
generator, before the ViT branch's DropPath masks, upsamples it
bicubically to the level's size and clamps it to [0, 1]; under
:func:`pinned_gate` it is the deterministic :func:`pinned_alpha_nchw`
pattern of the cross-framework parity goldens.  The map is f32, so the
fused maps are f32 whatever the compute dtype, and so is everything after
them: the decoder's convs promote their bf16 weights to f32
(``layers.promoted``), as flax's do.  A bf16 gated train step therefore
returns f32 logits, as the JAX package's does.

``flag_vit=False`` (``cnnu``, ``pnnu``) decodes the CNN pyramid alone and
skips the ViT branch; ``flag_cnn=False`` (``vitu``) decodes the projected
ViT features with the CNN's level 0 as the last skip.  Every module exists
under every flag, as in the reference, so the state-dict names do not
depend on them.  ``cnn_msca`` adds the MSCA attention after every CrossCNN
block (``msca``).

``forward(x, cnn_feats=...)`` takes the CNN pyramid from outside (five NHWC
maps): the way the fused block kernel's branch
(``models/crosscnn.py::cross_resnet_fused``) enters.

Under a width shard (``parallel/spatial.py::width_shard``, the predictor's
``'model'`` mesh axis) ``x`` is the rank's block of the image's columns; the
convs, the MetaPool sites and the decoder's upsampling take the halo
columns they need from the other ranks, and only the main head's logits
come back (the aux heads are never read by the predictor).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from tcct_tpu_torch.models.crosscnn import CrossResNet
from tcct_tpu_torch.models.layers import BatchNorm2d, _TrainPass, conv2d, leaky_relu
from tcct_tpu_torch.models.mpvit import CRPE_MIXERS, MPViT, MPViTConfig
from tcct_tpu_torch.ops.resize import resize_bicubic, resize_bilinear, upsample2x_aligned_shard
from tcct_tpu_torch.parallel.distributed import Rows
from tcct_tpu_torch.utils.tracing import span


def unused_prefixes(model: nn.Module, serving: bool = False) -> Tuple[str, ...]:
    """State-dict prefixes, in ``model`` (a zoo model, or a module that
    holds one as ``base``), of the modules its forward never runs under the
    model's flags (:meth:`FTC.unused_prefixes`); with ``serving``, also
    those that only form the polarization feats (``feats_prefixes``:
    ReLayNet's ``eran``/``dran`` heads), which the serving forward never
    reads."""
    base = getattr(model, "base", model)
    prefix = "base." if base is not model else ""
    names = tuple(getattr(base, "unused_prefixes", tuple)())
    if serving:
        names += tuple(getattr(base, "feats_prefixes", ()))
    return tuple(prefix + p for p in names)


def never_run(model: nn.Module) -> Tuple[str, ...]:
    """Module names (one dotted part of a state-dict key) that no forward
    of ``model`` runs, so the JAX model never creates them: MPViT's
    classification head, and its CRPE convs unless the mixer is ``factor``
    or ``hydra``."""
    cfg = getattr(getattr(model, "base", model), "vit_cfg", None)
    return ("cls_head",) if cfg is not None and cfg.mixer in CRPE_MIXERS else ("crpe", "cls_head")


class MPUpBlock(nn.Module):
    """conv3-BN-LReLU -> 2x bilinear up (align_corners=True) -> +skip ->
    1x1 conv (reference tcct.py:887-914).  Under a width shard the
    upsampling takes one halo column from each side and the whole image's
    source coordinates (``ops/resize.py::upsample2x_aligned_shard``)."""

    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, cin, cout):
        super().__init__()
        self.prep = nn.Sequential(conv2d(cin, cout, 3, 1, 1), BatchNorm2d(cout))
        self.post = nn.Sequential(conv2d(cout, cout, 1, 1, 0))

    def forward(self, x1, x2=None):
        x1 = leaky_relu(self.prep(x1))
        shard = self.width_shard
        if shard is not None:
            w = x1.shape[3]
            x1 = upsample2x_aligned_shard(x1, *shard.halos(x1.permute(0, 2, 3, 1), 1, 1),
                                          *shard.level(w))
        else:
            x1 = resize_bilinear(x1, (x1.shape[2] * 2, x1.shape[3] * 2), align_corners=True)
        if x2 is not None:
            x1 = x1 + x2
        return self.post(x1)


def simple_fusion(x1, x2):
    return x1 + x2


_PINNED_GATE = False


@contextlib.contextmanager
def pinned_gate(enable: bool = True):
    """Inside the block a gated FTC in train mode takes its alpha maps from
    :func:`pinned_alpha_nchw` instead of the generator: the cross-framework
    noise hook of the gated train-parity golden (JAX
    ``tcct_tpu/models/ftc.py::pinned_gate``)."""
    global _PINNED_GATE
    prev = _PINNED_GATE
    _PINNED_GATE = bool(enable)
    try:
        yield
    finally:
        _PINNED_GATE = prev


def pinned_alpha_nchw(B: int, C: int, h: int, w: int) -> np.ndarray:
    """Deterministic well-spread [0, 1) alpha pattern in NCHW index order
    (the reference's ``torch.rand(B, C, h, w)`` layout, tcct.py:925): the
    tensor both frameworks build for the parity goldens."""
    i = np.arange(B * C * h * w, dtype=np.float64).reshape(B, C, h, w)
    return ((np.sin(i * 12.9898) * 43758.5453) % 1.0).astype(np.float32)


def gate_alpha(shape, generator: Optional[torch.Generator], device,
               rows: Optional[Rows] = None) -> torch.Tensor:
    """The train-mode alpha map of a fused level of NCHW ``shape``: a
    [B, C, max(3, H // 32), max(3, W // 32)] f32 draw (or the pinned
    pattern), bicubic to (H, W) with ``align_corners=False``, clamped to
    [0, 1], in channels_last memory.  ``rows`` (a ``parallel.Rows``, a
    data-parallel rank's): the draw (or the pattern) covers the global
    batch of ``rows.total`` and the map keeps ``[rows.start:rows.stop)``."""
    B, C, H, W = shape
    rows = rows if rows is not None else Rows(0, B, B)
    h, w = max(3, H // 32), max(3, W // 32)
    if _PINNED_GATE:
        a = torch.from_numpy(pinned_alpha_nchw(rows.total, C, h, w)).to(device)
    else:
        a = torch.rand((rows.total, C, h, w), generator=generator, device=device)
    a = torch.clamp(resize_bicubic(a[rows.start:rows.stop], (H, W), align_corners=False),
                    0.0, 1.0)
    return a.contiguous(memory_format=torch.channels_last)


def gate_fusion(x1, x2, alpha=0.5):
    """Alpha-map gating (reference tcct.py:916-932): ``x1 * alpha + x2 *
    (1 - alpha)``; alpha 0.5 in eval mode, a :func:`gate_alpha` map (f32,
    so the result is f32) in train mode."""
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
    onnx/tcct_goals.py for the ``infer`` variant, nets/tcct32.py for
    ``t32``)."""

    VARIANTS = ("infer", "train", "t32")
    train_pass: Optional[_TrainPass] = None  # set by layers.train_pass()
    width_shard = None  # set by parallel.spatial.width_shard()

    def __init__(self, vit_cfg: MPViTConfig = MPViTConfig(), cnn_tiny: bool = True,
                 out_channels: int = 5, filters: int = 32, variant: str = "infer",
                 cnn_plain: bool = False, flag_gate: bool = False, flag_cnn: bool = True,
                 flag_vit: bool = True, cnn_msca: bool = False, t32_filters: int = 64):
        super().__init__()
        if variant not in self.VARIANTS:
            raise ValueError(f"FTC: variant must be one of {self.VARIANTS}, got {variant!r}")
        self.variant = variant
        self.vit_cfg = vit_cfg
        self.flag_gate, self.flag_cnn, self.flag_vit = flag_gate, flag_cnn, flag_vit
        self.base_vit = MPViT(vit_cfg)
        self.base_cnn = CrossResNet(tiny=cnn_tiny, plain=cnn_plain, msca=cnn_msca)
        ld = self.base_cnn.layer_dims
        ed = vit_cfg.embed_dims
        t32 = variant == "t32"
        vit_out = tuple(ed[1:]) + (ed[-1],)  # each stage's aggregate width
        tran = (t32_filters,) * 4 if t32 else ld[1:]
        for i, l in enumerate(tran):
            setattr(self, f"tran_vit{i}", _tran(vit_out[i], l))
            setattr(self, f"tran_cnn{i}", _tran(ld[i + 1], l))
        self.head = nn.Sequential(conv2d(tran[-1], tran[-1], 3, 1, 1), BatchNorm2d(tran[-1]))
        # `fuse` exists in the reference state dict but is unused (tcct.py:982)
        self.fuse = conv2d(filters, filters, 1, 1, 0)
        dec = (tran[-1], 32, 32, 32, 32) if t32 else (ld[-1], ld[-2], ld[-3], ld[-4], filters)
        self.dec1 = MPUpBlock(dec[0], dec[1])
        self.dec2 = MPUpBlock(dec[1], dec[2])
        self.dec3 = MPUpBlock(dec[2], dec[3])
        self.dec4 = MPUpBlock(dec[3], dec[4])
        if t32:  # the 1x1 skip adapters to the 32-channel decoder
            self.skip1 = conv2d(tran[2], 32, 1, 1, 0)
            self.skip2 = conv2d(tran[1], 32, 1, 1, 0)
            self.skip3 = conv2d(tran[0], 32, 1, 1, 0)
            aux_in = (32, 32, 32, 32)
        elif variant == "train":
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

    def _alphas(self, cs) -> List[torch.Tensor]:
        """The four train-mode alpha maps, one a fused level (the CNN
        level's size, the projection's width), drawn in level order."""
        gen = self.train_pass.generator if self.train_pass is not None else None
        if gen is None and not _PINNED_GATE:
            raise ValueError(
                "gated fusion in train mode draws its alpha maps from train_pass(model, "
                "generator); none is set (stochastic gating would silently become the eval "
                "alpha 0.5), or pin them with pinned_gate()")
        return [gate_alpha((c.shape[0], getattr(self, f"tran_cnn{i}")[0].out_channels)
                           + tuple(c.shape[2:]), gen, c.device,
                           self.train_pass.draw_rows(c.shape[0])
                           if self.train_pass is not None else None)
                for i, c in enumerate(cs)]

    def forward(self, x: torch.Tensor, with_feats: bool = False,
                cnn_feats: Optional[Sequence[torch.Tensor]] = None):
        """NHWC image [B,H,W,3] -> four NHWC logit maps [B,H,W,n_class];
        with ``with_feats`` (variants ``train`` and ``t32``) -> ``(maps,
        [feat])`` with the NHWC polarization feat.  ``cnn_feats``: the CNN
        branch's five NHWC maps computed outside, instead of
        ``base_cnn``'s."""
        if with_feats and self.variant == "infer":
            raise ValueError("FTC: the polarization feats are formed by variant='train' only")
        if with_feats and self.width_shard is not None:
            raise NotImplementedError("FTC: a width shard serves the logits only, not the "
                                      "polarization feats")
        x = x.permute(0, 3, 1, 2)
        if cnn_feats is not None:
            c1, c2, c3, c4, c5 = (c.permute(0, 3, 1, 2) for c in cnn_feats)
        else:
            with span("model.cnn"):
                c1, c2, c3, c4, c5 = self.base_cnn(x)
        if self.flag_vit:
            gated = self.flag_gate and self.flag_cnn
            # the gate's draws come before the ViT branch's DropPath masks
            alphas = self._alphas((c2, c3, c4, c5)) if gated and self.training else [0.5] * 4
            with span("model.vit"):
                vs = [getattr(self, f"tran_vit{i}")(v)
                      for i, v in enumerate(self.base_vit.forward_features(x))]
            if self.flag_cnn:
                with span("model.fusion"):
                    cs = [getattr(self, f"tran_cnn{i}")(c)
                          for i, c in enumerate((c2, c3, c4, c5))]
                    if gated:
                        x2, x3, x4, x5 = (gate_fusion(v, c, a)
                                          for v, c, a in zip(vs, cs, alphas))
                    else:
                        x2, x3, x4, x5 = (simple_fusion(v, c) for v, c in zip(vs, cs))
            else:
                x2, x3, x4, x5 = vs
        else:
            x2, x3, x4, x5 = c2, c3, c4, c5
        with span("model.decoder"):
            return self._decode(x, c1, x2, x3, x4, x5, with_feats)

    def _decode(self, x, c1, x2, x3, x4, x5, with_feats: bool):
        """The head, the up-blocks and the aux heads on the NCHW input ``x``,
        the CNN's level 0 ``c1`` and the fused levels ``x2``-``x5``."""
        y8 = leaky_relu(self.head(x5))
        if self.variant == "t32":
            s2, s3 = self.skip2(x3), self.skip3(x2)
            y4 = self.dec1(y8, self.skip1(x4))
            y2 = self.dec2(y4, s2)
            y1 = self.dec3(y2, s3)
        else:
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
        if self.width_shard is not None and not with_feats:
            # the predictor reads the main head only: the aux heads' resizes
            # to the input size (align_corners=False) are not formed on a shard
            return [self.aux0(y0).permute(0, 2, 3, 1)]
        outs = [
            self.aux0(y0),
            resize_bilinear(self.aux1(y1), size, align_corners=False),
            resize_bilinear(self.aux2(y2), size, align_corners=False),
            resize_bilinear(self.aux4(y4), size, align_corners=False),
        ]
        outs = [o.permute(0, 2, 3, 1) for o in outs]
        if not with_feats:
            return outs
        maps = [c1, s3, s2, y0, y1, y2] if self.variant == "t32" else [y0, y1, y2]
        return outs, [norm_add(maps).permute(0, 2, 3, 1)]
