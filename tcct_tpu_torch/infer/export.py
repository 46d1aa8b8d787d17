"""Serving artifacts (JAX counterpart ``tcct_tpu/infer/export.py``).

The JAX package serialises its jitted forward as a ``jax.export`` artifact
(StableHLO).  This package's artifact is a ``torch.export`` program of the
eval forward, saved with ``torch.export.save``:

- :func:`export_model` traces ``model(x)[0]``, the main head's logits,
  with the gradient off, as the predictor runs it, so that every MetaPool
  block's token pass is one ``tcct::metapool_block`` and every depthwise
  conv a ``tcct::dwconv3x3``: the hand-written kernels are ops of the
  graph.  The batch is symbolic; H and W stay static, one bucket each (the
  bucketed predictor is the answer to other sizes).  The program is for the
  device it was exported on, as JAX's is for its lowering platform.
- :func:`load_exported` registers the ``tcct::`` ops (it imports this
  package's kernel modules, so ``tcct_tpu_torch`` must be importable),
  loads a program and returns ``callable(x) -> logits``.
- :func:`save_params_npz` / :func:`load_params_npz` exchange weights as
  compressed numpy arrays under the reference's state-dict names;
  :func:`load_params_npz` also reads the JAX package's npz files.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from tcct_tpu_torch.infer.importer import from_jax_variables
# the tcct:: ops, which an exported program calls
from tcct_tpu_torch.ops.kernels import bnstats, crosscnn_fused, dwconv, metapool  # noqa: F401


class _Logits(torch.nn.Module):
    """``model(x)[0]``: the main head's logits (JAX's ``fwd``)."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        out = self.model(x)
        return out[0] if isinstance(out, (list, tuple)) else out


def export_model(model: torch.nn.Module, sample_input: torch.Tensor, path: str,
                 dynamic_batch: bool = True) -> str:
    """Export the eval forward of ``model`` (its main head's logits) at
    ``sample_input``'s shape, type and device with ``torch.export``, under
    ``torch.no_grad()``, and save the program to ``path``.  With
    ``dynamic_batch`` the batch is a symbolic dimension (export at a batch
    of 2 or more); H and W are static.  The model is traced in eval mode
    and left in the mode it had.  Returns ``path``."""
    dynamic = None
    if dynamic_batch:
        dynamic = ({0: torch.export.Dim("batch", min=1)},)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(_Logits(model), (sample_input,), dynamic_shapes=dynamic)
    finally:
        model.train(was_training)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path: str):
    """Load a program written by :func:`export_model`; returns
    ``callable(x) -> logits``, which runs it under ``torch.inference_mode()``
    (its ``module`` attribute is the program's ``torch.fx.GraphModule``).
    The program's ``tcct::`` ops run their CUDA implementations (the
    kernels, counted as eager calls count them) on CUDA tensors and their
    plain versions on CPU tensors."""
    module = torch.export.load(path).module()

    def run(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(x)

    run.module = module
    return run


def save_params_npz(model: torch.nn.Module, path: str) -> str:
    """Write ``model``'s state dict (the reference's names) as numpy arrays
    to a compressed npz at ``path``; bf16 tensors are written widened to
    f32 (numpy has no bf16).  Returns ``path``."""
    arrays = {}
    for k, t in model.state_dict().items():
        t = t.detach().cpu()
        arrays[k] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.savez_compressed(path, **arrays)
    return path


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from an npz: one written by :func:`save_params_npz`
    as it is, or one written by the JAX package's ``save_params_npz``
    (keys ``"params/..."``, ``"batch_stats/..."``) through
    :func:`from_jax_variables`.  Load the result with ``load_state_dict``
    (``strict=False`` for the JAX case) or ``load_into``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    if any(k.startswith(("params/", "batch_stats/")) for k in flat):
        return from_jax_variables(flat)
    return {k: torch.from_numpy(v) for k, v in flat.items()}
