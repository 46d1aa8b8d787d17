"""Model registry (JAX counterpart ``tcct_tpu/models/registry.py``).

Factory names mirror the reference (task1/nets/tcct.py:1050-1137): ``stc_*``
simple fusion, ``gtc_*`` gated fusion, ``cnnu``/``pnnu``/``vitu`` branch
ablations, ``tcct`` = ``stc_tt``.  The two letters name the MPViT size
(tiny, small) and the CNN branch (tiny: 32 channels at every level; base:
32/64/96/128/256).  Every factory takes ``n_class`` and ``variant``
(``'infer'``, the architecture of the shipped checkpoints and this
package's default, or ``'train'``, the training goldens'), ``drop_path_rate``
and ``mixer``.  Only the MetaPool mixer is ported: ``'metapool'`` and
``'metapool_pallas'`` both name it (one kernel route here), the others
raise.  ``msca``, ``tcct32`` and ``relay`` are not ported yet (ROADMAP A.6).
"""

from __future__ import annotations

from typing import Callable, Dict

from tcct_tpu_torch.models.ftc import FTC
from tcct_tpu_torch.models.mpvit import (
    mpvit_base_config,
    mpvit_small_config,
    mpvit_tiny_config,
)

_REGISTRY: Dict[str, Callable] = {}
_VIT = {"tiny": mpvit_tiny_config, "small": mpvit_small_config, "base": mpvit_base_config}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def _ftc(name: str, vit: str, cnn_tiny: bool, gate: bool = False, **flags):
    def factory(n_class: int = 8, variant: str = "infer", drop_path_rate: float = 0.1,
                mixer: str = "metapool"):
        if variant not in ("infer", "train"):
            raise ValueError(f"{name}: variant must be 'infer' or 'train', got {variant!r}")
        if mixer not in ("metapool", "metapool_pallas"):
            raise ValueError(f"{name}: mixer {mixer!r} is not ported (ROADMAP A.6); "
                             "have 'metapool' (alias 'metapool_pallas')")
        return FTC(_VIT[vit](drop_path_rate=drop_path_rate), cnn_tiny=cnn_tiny,
                   out_channels=n_class, variant=variant, flag_gate=gate, **flags)

    factory.__name__ = name
    return register(name)(factory)


stc_tt = _ftc("stc_tt", "tiny", True)
tcct = _ftc("tcct", "tiny", True)
stc_tb = _ftc("stc_tb", "tiny", False)
stc_st = _ftc("stc_st", "small", True)
stc_sb = _ftc("stc_sb", "small", False)
gtc_tt = _ftc("gtc_tt", "tiny", True, gate=True)
gtc_tb = _ftc("gtc_tb", "tiny", False, gate=True)
cnnu = _ftc("cnnu", "tiny", True, flag_vit=False)
pnnu = _ftc("pnnu", "tiny", True, cnn_plain=True, flag_vit=False)
vitu = _ftc("vitu", "tiny", True, flag_cnn=False)


def get_model(name: str, n_class: int, **kw):
    if name not in _REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](n_class, **kw)


def list_models():
    return sorted(_REGISTRY)
