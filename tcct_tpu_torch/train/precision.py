"""Mixed precision (JAX counterpart ``tcct_tpu/train/precision.py``):
master parameters in f32, compute in the step's dtype.

Every floating parameter and buffer is cast to the compute dtype by an
explicit ``.to`` right before the forward; the gradients flow back through
those casts to the f32 masters.  Not ``torch.autocast``: it keeps some ops
in f32 and picks its own casts, so its bf16 step would not be the JAX
package's.
"""

from __future__ import annotations

from typing import Dict

import torch


def cast_floating(tensors: Dict[str, torch.Tensor], dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Each floating tensor cast to ``dtype`` (differentiably); the others
    pass as they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in tensors.items()}
