"""The plain reference model: a frozen, self-contained PyTorch copy of the
TCCT segmentation network as the benchmark's configurations describe it.

Tan et al., "Retinal Layer Segmentation in OCT images with Boundary
Regression and Feature Polarization", IEEE TMI 2023 (github.com/tyb311/TCCT,
task1/nets/tcct.py and task1/nets/reg.py): a dual-branch encoder (an MPViT
branch with the MetaPool token mixer, Lee et al., CVPR 2022; a CrossCNN
branch of {3x3, 3x3} and {1xk, kx1, 3x3} paths), simple fusion of the two
pyramids, a U-decoder with four logit heads, and the RegNet wrapper that
holds the boundary-regression and feature-polarization heads.

Plain ``torch`` operations only, NCHW tensors, every state-dict name the
reference's.  Written from the published description and the reference's
file; it imports nothing of the program under test.  The departures from
textbook layers are the reference's own and are kept:

- MetaPool is ``AvgPool2d(3, 1, 1, count_include_pad=False)`` applied to a
  [B, N, C] token tensor, which torch reads as (C, H, W): the window slides
  over (token, channel), not over space.
- The CrossCNN blocks run LeakyReLU *before* BatchNorm.
- BatchNorm in train mode normalises with the biased batch variance and
  moves its running statistics as ``0.9 * old + 0.1 * batch`` (biased); a
  BatchNorm run twice in one pass (``lap_map``) chains the two updates.
- GELU is the exact erf form; LayerNorm eps 1e-6; BatchNorm eps 1e-5
  (``lap_map``'s 1.0, the reference's ``nn.BatchNorm2d(1, 1)``).

``quant`` (a callable or None) is applied to the input and the weight of
every convolution and linear layer, ``quant_grad`` to its output: the
benchmark's lower-precision control passes the roundings to fp8 there
(``control.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


class Ctx:
    """What one forward shares with its layers: the quantizer of the
    control, whether BatchNorm runs on batch statistics, the generator of
    the DropPath masks and the new running statistics by module."""

    def __init__(self, quant: Quant = None, train: bool = False,
                 generator: Optional[torch.Generator] = None, quant_grad: Quant = None):
        self.quant = quant
        self.quant_grad = quant_grad
        self.train = train
        self.generator = generator
        self.new_stats: Dict[nn.Module, tuple] = {}
        self.batch_stats: Dict[nn.Module, tuple] = {}

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant is None else self.quant(t)

    def qg(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.quant_grad is None else self.quant_grad(t)


def _like(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if t is None else t.to(x.dtype)


class Conv(nn.Conv2d):
    def run(self, x, ctx: Ctx):
        return ctx.qg(F.conv2d(ctx.q(x), ctx.q(_like(self.weight, x)), _like(self.bias, x),
                               self.stride, self.padding, self.dilation, self.groups))


class Linear(nn.Linear):
    def run(self, x, ctx: Ctx):
        return ctx.qg(F.linear(ctx.q(x), ctx.q(_like(self.weight, x)), _like(self.bias, x)))


class BN(nn.BatchNorm2d):
    """Statistics and the scale ``rsqrt(var + eps) * weight`` in f32, the
    normalization in the input's type."""

    def run(self, x, ctx: Ctx):
        if ctx.train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf * xf).mean(dim=(0, 2, 3)) - mean * mean
            ctx.batch_stats[self] = (mean.detach(), var.detach())
            old = ctx.new_stats.get(self, (self.running_mean.float(), self.running_var.float()))
            ctx.new_stats[self] = (0.9 * old[0] + 0.1 * mean.detach(),
                                   0.9 * old[1] + 0.1 * var.detach())
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        inv = torch.rsqrt(var + self.eps) * self.weight.float()
        return (x - _like(mean, x)[:, None, None]) * _like(inv, x)[:, None, None] \
            + _like(self.bias, x)[:, None, None]


def conv(cin, cout, k=3, stride=1, padding=None, groups=1, bias=True) -> Conv:
    k = (k, k) if isinstance(k, int) else tuple(k)
    padding = (k[0] // 2, k[1] // 2) if padding is None else padding
    return Conv(cin, cout, k, stride, padding, groups=groups, bias=bias)


def lrelu(x):
    return F.leaky_relu(x, 0.01)


def run_seq(seq: nn.Sequential, x, ctx: Ctx):
    for m in seq:
        x = m.run(x, ctx) if hasattr(m, "run") else m(x)
    return x


# --- MPViT -------------------------------------------------------------------

class ConvBN(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, pad=0, groups=1, act=None):
        super().__init__()
        self.conv = conv(cin, cout, k, stride, pad, groups=groups, bias=False)
        self.bn = BN(cout)
        self.act = act

    def run(self, x, ctx):
        x = self.bn.run(self.conv.run(x, ctx), ctx)
        return self.act(x) if self.act is not None else x


class DWConvBN(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.dwconv = conv(cin, cout, 3, stride, 1, groups=cout, bias=False)
        self.pwconv = conv(cout, cout, 1, 1, 0, bias=False)
        self.bn = BN(cout)

    def run(self, x, ctx):
        return F.hardswish(self.bn.run(self.pwconv.run(self.dwconv.run(x, ctx), ctx), ctx))


class DWCPatchEmbed(nn.Module):
    def __init__(self, dim, stride):
        super().__init__()
        self.patch_conv = DWConvBN(dim, dim, stride)


class PatchEmbedStage(nn.Module):
    def __init__(self, dim, num_path, is_pool):
        super().__init__()
        self.patch_embeds = nn.ModuleList(
            DWCPatchEmbed(dim, 2 if is_pool and i == 0 else 1) for i in range(num_path))

    def run(self, x, ctx):
        outs = []
        for pe in self.patch_embeds:
            x = pe.patch_conv.run(x, ctx)
            outs.append(x)
        return outs


class ConvPosEnc(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.proj = conv(dim, dim, 3, 1, 1, groups=dim)


class ConvRelPosEnc(nn.Module):
    """The reference's CRPE; the MetaPool mixer never runs it, it exists for
    the state dict."""

    def __init__(self, ch, window=((3, 2), (5, 3), (7, 3))):
        super().__init__()
        self.conv_list = nn.ModuleList(
            conv(hs * ch, hs * ch, w, 1, w // 2, groups=hs * ch) for w, hs in window)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def run(self, x, ctx):
        return self.fc2.run(F.gelu(self.fc1.run(x, ctx)), ctx)


def drop_path(x, rate: float, ctx: Ctx):
    """Per-sample stochastic depth: keep with 1 - rate, scale by 1/(1 - rate);
    the mask drawn from the pass's generator as [B, 1, 1] uniforms."""
    if not ctx.train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=ctx.generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def metapool(x):
    """The reference's MetaPool on [B, N, C] tokens: the 3x3 average over
    (token, channel), padding not counted, minus the input."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False) - x


class MHCABlock(nn.Module):
    def __init__(self, dim, mlp_ratio, cpe, crpe, rate):
        super().__init__()
        self.cpe = cpe
        self.crpe = crpe
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)
        self.rate = rate

    def run(self, x, size, ctx):
        B, N, C = x.shape
        img = x.reshape(B, size[0], size[1], C).permute(0, 3, 1, 2)
        x = x + self.cpe.proj.run(img, ctx).permute(0, 2, 3, 1).reshape(B, N, C)
        x = x + drop_path(metapool(self.norm1(x)), self.rate, ctx)
        return x + drop_path(self.mlp.run(self.norm2(x), ctx), self.rate, ctx)


class MHCAEncoder(nn.Module):
    def __init__(self, dim, num_layers, num_heads, mlp_ratio, rates):
        super().__init__()
        self.cpe = ConvPosEnc(dim)
        self.crpe = ConvRelPosEnc(dim // num_heads)
        self.MHCA_layers = nn.ModuleList(
            MHCABlock(dim, mlp_ratio, self.cpe, self.crpe, rates[i]) for i in range(num_layers))

    def run(self, x, ctx):
        B, C, H, W = x.shape
        t = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.MHCA_layers:
            t = blk.run(t, (H, W), ctx)
        return t.reshape(B, H, W, C).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = ConvBN(dim, dim, act=F.hardswish)
        self.dwconv = conv(dim, dim, 3, 1, 1, groups=dim, bias=False)
        self.norm = BN(dim)
        self.conv2 = ConvBN(dim, dim)

    def run(self, x, ctx):
        y = self.conv1.run(x, ctx)
        y = F.hardswish(self.norm.run(self.dwconv.run(y, ctx), ctx))
        return x + self.conv2.run(y, ctx)


class MHCAStage(nn.Module):
    def __init__(self, dim, out_dim, num_layers, num_heads, mlp_ratio, num_path, rates):
        super().__init__()
        self.mhca_blks = nn.ModuleList(
            MHCAEncoder(dim, num_layers, num_heads, mlp_ratio, rates) for _ in range(num_path))
        self.InvRes = ResBlock(dim)
        self.aggregate = ConvBN(dim * (num_path + 1), out_dim, act=F.hardswish)

    def run(self, inputs, ctx):
        outs = [self.InvRes.run(inputs[0], ctx)]
        outs += [enc.run(x, ctx) for x, enc in zip(inputs, self.mhca_blks)]
        return self.aggregate.run(torch.cat(outs, dim=1), ctx)


class ClsHead(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.cls = nn.Linear(dim, 1000)


def drop_path_rates(rate: float, num_layers: Sequence[int]) -> List[List[float]]:
    total = sum(num_layers)
    flat = [rate * i / (total - 1) for i in range(total)] if total > 1 else [0.0] * total
    out, cur = [], 0
    for n in num_layers:
        out.append(flat[cur:cur + n])
        cur += n
    return out


class MPViT(nn.Module):
    def __init__(self, v: dict, drop_path_rate: float):
        super().__init__()
        ed, n = v["embed_dims"], len(v["embed_dims"])
        self.stem = nn.Sequential(ConvBN(3, ed[0] // 2, 3, 2, 1, act=F.hardswish),
                                  ConvBN(ed[0] // 2, ed[0], 3, 1, 1, act=F.hardswish))
        self.patch_embed_stages = nn.ModuleList(
            PatchEmbedStage(ed[i], v["num_path"][i], i != 0) for i in range(n))
        rates = drop_path_rates(drop_path_rate, v["num_layers"])
        self.mhca_stages = nn.ModuleList(
            MHCAStage(ed[i], ed[i + 1] if i + 1 < n else ed[i], v["num_layers"][i],
                      v["num_heads"][i], v["mlp_ratios"][i], v["num_path"][i], rates[i])
            for i in range(n))
        self.cls_head = ClsHead(ed[-1])

    def run(self, x, ctx):
        x = run_seq(self.stem, x, ctx)
        xs = []
        for pe, st in zip(self.patch_embed_stages, self.mhca_stages):
            x = st.run(pe.run(x, ctx), ctx)
            xs.append(x)
        return xs


# --- CrossCNN ------------------------------------------------------------------

class CrossCNNBlock(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.block12 = nn.Sequential(conv(cin, cout, 3), conv(cout, cout, 3), nn.LeakyReLU(0.01),
                                     BN(cout))
        self.block34 = nn.Sequential(conv(cin, cout, (1, k)), conv(cout, cout, (k, 1)),
                                     conv(cout, cout, 3), nn.LeakyReLU(0.01), BN(cout))
        self.block5 = nn.Sequential(conv(cout, cout, 3), nn.LeakyReLU(0.01), BN(cout))

    def run(self, x, ctx):
        a = run_seq(self.block12, x, ctx)
        b = run_seq(self.block34, x, ctx)
        return run_seq(self.block5, F.gelu(a + b), ctx)


class CrossResNet(nn.Module):
    def __init__(self, dims, kernels):
        super().__init__()
        self.cnn = nn.Sequential(conv(3, dims[0], 3), BN(dims[0]))
        cins = (dims[0],) + tuple(dims[:-1])
        self.path_estan = nn.ModuleList(
            CrossCNNBlock(cins[i], dims[i], k) for i, k in enumerate(kernels))

    def run(self, x, ctx):
        x = run_seq(self.cnn, x, ctx)
        xs = []
        for i, blk in enumerate(self.path_estan):
            x = blk.run(x, ctx)
            xs.append(x)
            if i < len(self.path_estan) - 1:
                x = F.max_pool2d(x, 2)
        return xs


# --- fusion and decoder -----------------------------------------------------------

class MPUpBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.prep = nn.Sequential(conv(cin, cout, 3), BN(cout))
        self.post = nn.Sequential(conv(cout, cout, 1, 1, 0))

    def run(self, x1, x2, ctx):
        x1 = lrelu(run_seq(self.prep, x1, ctx))
        x1 = F.interpolate(x1, scale_factor=2, mode="bilinear", align_corners=True)
        return run_seq(self.post, x1 + x2, ctx)


def up(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def norm_add(xs):
    xs = [x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-12)
          for x in xs]
    size = xs[0].shape[2:]
    return sum(up(x, size) for x in xs) / len(xs)


class FTC(nn.Module):
    """Simple fusion of the MPViT and CrossCNN pyramids and the U-decoder;
    ``variant`` ``'infer'`` (the shipped checkpoints' heads) or ``'train'``
    (the 1x1 projections t321-t324 and the polarization feats)."""

    def __init__(self, cfg: dict, n_class: int, variant: str):
        super().__init__()
        self.variant = variant
        v = cfg["mpvit"]
        ld = tuple(cfg["cnn_dims"])
        f = cfg["decoder_filters"]
        self.base_vit = MPViT(v, cfg["drop_path_rate"])
        self.base_cnn = CrossResNet(ld, cfg["cnn_kernels"])
        ed = v["embed_dims"]
        vit_out = tuple(ed[1:]) + (ed[-1],)
        for i in range(4):
            setattr(self, f"tran_vit{i}", nn.Sequential(conv(vit_out[i], ld[i + 1], 1, 1, 0),
                                                        BN(ld[i + 1])))
            setattr(self, f"tran_cnn{i}", nn.Sequential(conv(ld[i + 1], ld[i + 1], 1, 1, 0),
                                                        BN(ld[i + 1])))
        self.head = nn.Sequential(conv(ld[-1], ld[-1], 3), BN(ld[-1]))
        self.fuse = conv(f, f, 1, 1, 0)  # in the reference's state dict, never run
        self.dec1 = MPUpBlock(ld[-1], ld[-2])
        self.dec2 = MPUpBlock(ld[-2], ld[-3])
        self.dec3 = MPUpBlock(ld[-3], ld[-4])
        self.dec4 = MPUpBlock(ld[-4], f)
        if variant == "train":
            self.t321 = conv(ld[-2], f, 1, 1, 0)
            self.t322 = conv(ld[-3], f, 1, 1, 0)
            self.t323 = conv(ld[-4], f, 1, 1, 0)
            self.t324 = conv(f, f, 1, 1, 0)
            aux_in = (f, f, f, f)
        else:
            aux_in = (f, ld[-4], ld[-3], ld[-2])
        for name, cin in zip(("aux0", "aux1", "aux2", "aux4"), aux_in):
            setattr(self, name, conv(cin, n_class, 1, 1, 0))

    def run(self, x, ctx, with_feats=False):
        """NCHW image -> four NCHW logit maps (and the NCHW feat)."""
        c1, c2, c3, c4, c5 = self.base_cnn.run(x, ctx)
        vs = [run_seq(getattr(self, f"tran_vit{i}"), v, ctx)
              for i, v in enumerate(self.base_vit.run(x, ctx))]
        cs = [run_seq(getattr(self, f"tran_cnn{i}"), c, ctx)
              for i, c in enumerate((c2, c3, c4, c5))]
        x2, x3, x4, x5 = (v + c for v, c in zip(vs, cs))
        y8 = lrelu(run_seq(self.head, x5, ctx))
        y4 = self.dec1.run(y8, x4, ctx)
        y2 = self.dec2.run(y4, x3, ctx)
        y1 = self.dec3.run(y2, x2, ctx)
        y0 = self.dec4.run(y1, c1, ctx)
        if self.variant == "train":
            y0 = self.t324.run(c1 + y0, ctx)
            y1 = self.t323.run(x2 + y1, ctx)
            y2 = self.t322.run(x3 + y2, ctx)
            y4 = self.t321.run(x4 + y4, ctx)
        size = x.shape[2:]
        outs = [self.aux0.run(y0, ctx), up(self.aux1.run(y1, ctx), size),
                up(self.aux2.run(y2, ctx), size), up(self.aux4.run(y4, ctx), size)]
        return (outs, norm_add([y0, y1, y2])) if with_feats else outs


class Prototypes(nn.Module):
    def __init__(self, n_class, num_emb):
        super().__init__()
        self.register_buffer("vec_grad", torch.zeros(n_class, num_emb))
        self.register_buffer("cos_dist", torch.zeros(n_class * (n_class - 1) // 2))
        self.register_buffer("buf_grad", torch.zeros(n_class, num_emb))


class RegNet(nn.Module):
    """The base model with the reference's loss heads (task1/nets/reg.py)."""

    def __init__(self, cfg: dict, n_class: int, variant: str):
        super().__init__()
        nc = n_class
        self.base = FTC(cfg, nc, variant)
        self.tau = nn.Parameter(torch.full((1,), 100.0))
        self.fcp = Prototypes(nc, cfg["num_emb"])
        self.lap_epl = nn.Sequential(conv(nc, 1, 3), conv(1, 1, 3))
        self.lap_reg = nn.Sequential(
            *(conv(nc - 1, nc - 1, 3, groups=nc - 1) for _ in range(cfg["lap_reg_depth"])))
        self.lap_map = nn.Sequential(conv(1, 1, 3), BN(1, eps=1.0), conv(1, 1, 3))


@torch.no_grad()
def calibrate(model: RegNet, x: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to those of its input in
    one train-mode forward of the NCHW image batch ``x``, as training leaves
    them: the eval model then normalises its activations, as a trained one
    does, instead of letting random statistics blow them up."""
    ctx = Ctx(train=True)
    model.base.run(x, ctx)
    for m, (mean, var) in ctx.batch_stats.items():
        m.running_mean.copy_(mean)
        m.running_var.copy_(var)


# the modules no forward of the simple-fusion model runs with the MetaPool
# mixer (the reference's dead `fuse`, MPViT's classifier and CRPE convs):
# the train step neither decays nor moves them
FROZEN_PARTS = ("fuse", "cls_head", "crpe")


def trained_parameters(model: RegNet) -> Dict[str, nn.Parameter]:
    """The parameters a train step updates, by state-dict name (a shared
    module's once)."""
    return {k: p for k, p in model.named_parameters()
            if not any(part in FROZEN_PARTS for part in k.split("."))}
