"""Task-2 glaucoma classifier (JAX counterpart ``tcct_tpu/task2/model.py``;
reference task2/t2_train.py:128-153): a ResNet-18/34/50 with per-stage
dropout (0.1/0.2/0.3/0.4) and an fc -> 256 -> 2 head, NCHW in the
channels_last format.

It is built from the port's own layers, so in train mode every BatchNorm
is one launch of the train-BN kernel (K3) forward and one (K3b) backward
on the card; the convs are cuDNN's.  Module names are torchvision's
(``conv1``, ``layer1.0.conv1``, ``layer2.0.downsample.0``, ``fc.0``), so
``infer/importer.py::from_jax_variables`` carries the JAX package's
variables across and ImageNet ResNet state dicts graft onto the backbone
(:func:`load_resnet_checkpoint`).

Dropout draws its masks from :func:`models.layers.train_pass`'s generator
at fixed shapes, in module order (``drop1`` to ``drop4``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tcct_tpu_torch.models.layers import BatchNorm2d, conv2d, init_weights, trunc_normal
from tcct_tpu_torch.ops.pool import max_pool_2d

FEATS = (64, 128, 256, 512)
DROPS = (0.1, 0.2, 0.3, 0.4)


class ResBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.downsample = _downsample(cin, features, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = conv2d(cin, features, 1, 1, 0, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = conv2d(features, features, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = conv2d(features, out, 1, 1, 0, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _downsample(cin, out, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def _downsample(cin: int, cout: int, stride: int) -> Optional[nn.Sequential]:
    """The projection of the identity where the block changes shape."""
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(conv2d(cin, cout, 1, stride, 0, bias=False), BatchNorm2d(cout))


class Dropout(nn.Module):
    """flax's ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` and divided by it (a true division, as JAX's;
    CUDA divides a tensor by a Python scalar through its reciprocal), the
    mask drawn from :func:`train_pass`'s generator; the identity in eval
    mode."""

    train_pass = None  # set by train_pass()

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def draw(self, x: torch.Tensor, keep: float) -> torch.Tensor:
        """The keep mask of ``x``'s shape, from the pass's generator."""
        gen = self.train_pass.generator if self.train_pass is not None else None
        if gen is None:
            raise ValueError("Dropout in train mode draws from train_pass(model, generator); "
                             "none is set")
        return torch.rand(x.shape, generator=gen, device=x.device) < keep

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = self.draw(x, keep)
        return torch.where(mask, x / torch.full((), keep, dtype=x.dtype, device=x.device),
                           torch.zeros((), dtype=x.dtype, device=x.device))


_ARCH = {
    "res18": (ResBasicBlock, (2, 2, 2, 2)),
    "res34": (ResBasicBlock, (3, 4, 6, 3)),
    "res50": (ResBottleneck, (3, 4, 6, 3)),
}


class ClsModel(nn.Module):
    """ResNet backbone + per-stage dropout + fc -> 256 -> 2 (no activation
    between the two Linears, as in JAX).  ``forward`` takes NCHW f32
    images in [0, 1] and returns [B, num_classes] logits.  An unknown
    ``net`` builds res18, as JAX's ``_ARCH.get`` does."""

    def __init__(self, net: str = "res18", num_classes: int = 2):
        super().__init__()
        block, layout = _ARCH.get(net, _ARCH["res18"])
        self.conv1 = conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for li, (n_blocks, f, rate) in enumerate(zip(layout, FEATS, DROPS)):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(block(cin, f, 2 if (bi == 0 and li > 0) else 1))
                cin = f * block.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            setattr(self, f"drop{li + 1}", Dropout(rate))
        self.fc = nn.Sequential(nn.Linear(cin, 256), nn.Linear(256, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_2d(x, 3, 2, padding=1)
        for li in range(1, 5):
            x = getattr(self, f"drop{li}")(getattr(self, f"layer{li}")(x))
        return self.fc(torch.mean(x, dim=(2, 3)))


@torch.no_grad()
def init_cls_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded init with the JAX model's initialisers: convs He-normal over
    fan_out (``conv_init``), BatchNorm weight 1 / bias 0 / statistics 0 and
    1, Linear flax's default (lecun normal: truncated to two deviations,
    ``sqrt(1 / fan_in) / 0.8796``) with zero bias.  Draws come from
    ``generator`` in module order."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
            m.weight.copy_(trunc_normal(m.weight.shape, generator) * std)
            m.bias.zero_()
        elif isinstance(m, (nn.Conv2d, nn.BatchNorm2d)):
            init_weights(m, generator)
    return model


# ---------------------------------------------------------------------------
# pretrained-backbone grafting (reference t2_train.py:129-137)
# ---------------------------------------------------------------------------

def _canon_resnet_key(key: str) -> str:
    """torchvision / paddle / reference-wrapped ResNet keys -> torchvision
    naming: the reference Model's ``base.`` prefix stripped, its
    ``layerN.0.B.`` (each stage re-wrapped as ``Sequential(layer,
    Dropout)``, t2_train.py:141-144) unwrapped to ``layerN.B.``, paddle's
    BatchNorm ``._mean`` / ``._variance`` as ``.running_mean`` /
    ``.running_var``."""
    if key.startswith("base."):
        key = key[5:]
    key = re.sub(r"^(layer\d)\.0\.(\d+)\.", r"\1.\2.", key)
    return key.replace("._mean", ".running_mean").replace("._variance", ".running_var")


@dataclasses.dataclass
class GraftReport:
    loaded: List[str]  # model keys taken from the source
    untouched: List[str]  # model keys the source did not give (or gave in another shape)
    unused: List[str]  # source keys the model has no place for


def load_resnet_checkpoint(path_or_state, model: nn.Module) -> GraftReport:
    """Graft ImageNet-pretrained ResNet weights onto ``model`` (a
    :class:`ClsModel`) in place.

    ``path_or_state``: a torch ``.pt``/``.pth`` state dict file (read with
    ``weights_only=True``) or a ``{key: array}`` dict in torchvision,
    paddle.vision or the reference's wrapped naming.  The ImageNet ``fc``
    head is dropped (the model's is fc -> 256 -> 2).  Raises ``ValueError``
    if any backbone conv, BatchNorm or downsample tensor stays untouched, so
    a silent partial graft is impossible."""
    if isinstance(path_or_state, str):
        state = torch.load(path_or_state, map_location="cpu", weights_only=True)
    else:
        state = dict(path_or_state)
    state = {_canon_resnet_key(k): v for k, v in state.items()}
    state = {k: v for k, v in state.items() if not k.startswith("fc.")}
    own = model.state_dict()
    loaded: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if k in own and tuple(own[k].shape) == tuple(torch.as_tensor(v).shape):
            loaded[k] = torch.as_tensor(v).to(own[k].dtype)
    with torch.no_grad():
        for k, v in loaded.items():
            own[k].copy_(v)
    report = GraftReport(
        loaded=sorted(loaded),
        untouched=sorted(k for k in own if k not in loaded),
        unused=sorted(k for k in state if k not in loaded))
    unmatched = [k for k in report.untouched
                 if not k.endswith("num_batches_tracked")
                 and any(s in k for s in ("conv", "bn", "downsample"))]
    if unmatched:
        raise ValueError(f"pretrained graft left {len(unmatched)} backbone tensors untouched, "
                         f"e.g. {unmatched[:4]}: wrong architecture or naming?")
    return report
