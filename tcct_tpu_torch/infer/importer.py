"""Weight import: JAX-package variables and reference ``.pt`` files ->
this package's state dict (JAX counterpart ``tcct_tpu/infer/importer.py``).

The JAX package names its flax modules after the reference's torch paths
with the numeric Sequential/ModuleList indices merged into the preceding
name (torch ``stem.0.conv.weight`` <-> flax ``stem_0/conv/kernel``).  This
module holds its own copy of that rename and of the leaf transforms:

  conv ``kernel`` HWIO -> ``weight`` OIHW     dense ``kernel`` IO -> ``weight`` OI
  norm ``scale``       -> ``weight``          ``bias``            -> ``bias``
  batch_stats ``mean``/``var`` -> ``running_mean``/``running_var``
  prototypes ``fcp_buf_grad``  -> ``fcp.buf_grad``

The reference shares one ConvPosEnc/CRPE module between an encoder and its
blocks, so each such tensor has two state-dict keys; both are emitted.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from tcct_tpu_torch.models.ftc import never_run, unused_prefixes

_LEAVES = {
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
    ("params", "prelu"): "prelu.weight",  # ReLayNet's bare PReLU slope, an nn.PReLU here
}
# flax names that are not "<name>_<index>" merges
_SPECIAL = {"cls_head_cls": "cls_head.cls", "fcp_buf_grad": "fcp.buf_grad"}
# training-only or dead entries of the reference checkpoints
_SKIP_PATTERNS = ("aug.", "fcp.ies", "fcp.jes")


def _unmerge(name: str) -> str:
    """flax module name -> torch path: ``patch_embeds_0_patch_conv`` ->
    ``patch_embeds.0.patch_conv``, ``tran_vit0_1`` -> ``tran_vit0.1``;
    MSCA's ``conv0_1`` ... are torch attribute names and stay."""
    if name in _SPECIAL:
        return _SPECIAL[name]
    if re.fullmatch(r"conv\d_\d", name):
        return name
    return re.sub(r"_(\d+)(_|$)", lambda m: "." + m.group(1) + ("." if m.group(2) else ""), name)


def _torch_key(path: Tuple[str, ...]) -> str:
    """(collection, module..., leaf) -> torch state-dict key."""
    coll, *mods, leaf = path
    if not mods:  # top-level leaves: params/tau, prototypes/fcp_buf_grad
        return _unmerge(leaf)
    prefix = ".".join(_unmerge(m) for m in mods)
    if leaf == "kernel":
        name = "weight"
    else:
        name = _LEAVES[(coll, leaf)]
    return f"{prefix}.{name}" if prefix else name


def _aliases(key: str, layer_ids: Iterable[str]) -> Iterable[str]:
    """Per-block keys of an encoder-level shared cpe/crpe tensor."""
    m = re.match(r"(.*\.mhca_blks\.\d+\.)(c?r?pe\..*)$", key)
    if m is None:
        return ()
    return (f"{m.group(1)}MHCA_layers.{i}.{m.group(2)}" for i in layer_ids)


def from_jax_variables(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX variables flattened to ``"params/base/.../kernel"`` numpy arrays
    -> this package's state dict (f32 CPU tensors).

    Both the serving variables and the whole train state carry across: the
    train variant's ``t321``-``t324``, the RegNet loss heads (``lap_*``;
    a ``ShiftConv3x3`` kernel ``(3,3,1,C)`` becomes ``[C,1,3,3]`` like any
    conv), ``tau``, the BN statistics and ``prototypes/fcp_buf_grad`` as
    ``fcp.buf_grad``.  Only what the JAX variables hold is returned:
    parameters the JAX model never created (``cls_head`` and, with the
    MetaPool mixers, the CRPE convs it never runs, ``fuse``; the loss heads
    and ReLayNet's feats heads of a serving model) and
    ``num_batches_tracked`` are absent, so load the result with
    ``load_state_dict(..., strict=False)`` or :func:`load_into`."""
    out: Dict[str, torch.Tensor] = {}
    layers: Dict[str, set] = {}
    for k in flat:
        m = re.search(r"^(.*/mhca_blks_\d+)/MHCA_layers_(\d+)/", k)
        if m:
            layers.setdefault(m.group(1), set()).add(m.group(2))
    for k, v in flat.items():
        path = tuple(k.split("/"))
        arr = np.array(v, np.float32)  # a writable copy
        if path[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.transpose(1, 0)
        key = _torch_key(path)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[key] = t
        enc = re.match(r"^(.*/mhca_blks_\d+)/c?r?pe/", k)
        if enc:
            for alias in _aliases(key, sorted(layers.get(enc.group(1), ()))):
                out[alias] = t
    return out


def flatten_variables(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> ``{"a/b/c": np.ndarray}``."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            flat.update(flatten_variables(v, name))
        else:
            flat[name] = np.asarray(v)
    return flat


def load_reference_pt(path: str) -> Dict[str, torch.Tensor]:
    """State dict of a reference ``.pt`` checkpoint (a state dict or a
    pickled module), minus its training-only entries.  The file is
    unpickled, so load only checkpoints from a trusted source."""
    pt = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(pt, "state_dict"):
        pt = pt.state_dict()
    return {k: torch.as_tensor(v) for k, v in pt.items()
            if not any(p in k for p in _SKIP_PATTERNS)}


# the RegNet wrapper's loss heads: the serving forward does not read them
_LOSS_HEADS = ("lap_", "fcp.", "tau")


def load_into(model: torch.nn.Module, state: Dict[str, torch.Tensor]) -> Tuple[list, list]:
    """``load_state_dict(strict=False)`` that raises if a tensor the
    forward pass reads was left out.  Returns (missing, unexpected).

    What the forward reads follows the model's flags
    (``FTC.unused_prefixes``): a ``cnnu`` may come without its ViT branch
    and a ``vitu`` without its CNN projections, as the JAX package's
    variables do, while a model that runs both branches may not.  Never
    needed: BatchNorm's step counter, what no forward runs (``never_run``:
    the CRPE convs unless the mixer runs them, the classifier), the heads
    that only form the polarization feats (ReLayNet's) and the RegNet
    wrapper's loss heads."""
    res = model.load_state_dict(state, strict=False)
    unused = unused_prefixes(model, serving=True)
    if getattr(model, "base", model) is not model:
        unused += _LOSS_HEADS
    dead = never_run(model) + ("num_batches_tracked",)
    needed = [k for k in res.missing_keys
              if not k.startswith(unused) and not any(p in dead for p in k.split("."))]
    if needed:
        raise KeyError(f"weights missing for the forward pass: {needed[:8]}")
    return res.missing_keys, res.unexpected_keys
