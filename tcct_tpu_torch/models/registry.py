"""Model registry (JAX counterpart ``tcct_tpu/models/registry.py``).

The port has ``stc_tt`` and its alias ``tcct`` (simple fusion, MPViT-tiny
+ tiny CrossCNN) with the MetaPool mixer, in the ``infer`` variant (the
shipped checkpoints) and the ``train`` variant (the training goldens).
"""

from __future__ import annotations

from typing import Callable, Dict

from tcct_tpu_torch.models.ftc import FTC
from tcct_tpu_torch.models.mpvit import MPViTConfig

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


@register("stc_tt")
def stc_tt(n_class: int = 8, variant: str = "infer", drop_path_rate: float = 0.1):
    if variant not in ("infer", "train"):
        raise ValueError(f"stc_tt: variant must be 'infer' or 'train', got {variant!r}")
    return FTC(MPViTConfig(drop_path_rate=drop_path_rate), cnn_tiny=True,
               out_channels=n_class, variant=variant)


@register("tcct")
def tcct(n_class: int = 8, variant: str = "infer", drop_path_rate: float = 0.1):
    return stc_tt(n_class, variant=variant, drop_path_rate=drop_path_rate)


def get_model(name: str, n_class: int, **kw):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](n_class, **kw)


def list_models():
    return sorted(_REGISTRY)
