"""Frozen yardstick of the attention token mixer: the least time one
serving batch's mixers could take on one H100, built block by block from
the configuration and the traffic, whatever implements the mixer.

A block of C channels in h heads of d = C / h channels, over N tokens of a
batch of B, runs factorized attention with the CRPE (``reference/factor.py``):

- product operations 2·B·N·(4C² + 2C·d): the ``qkv`` (3C²) and ``proj``
  (C²) layers, ``k^T v`` and ``q kv`` (C·d each), two operations a
  multiply-add, on the tensor cores;
- CRPE operations 2·B·N·d·Σ(heads·w²): each group of heads' depthwise
  window of w x w taps, on the CUDA cores;
- bytes: the input and the output (B·N·C each) once in the serving type,
  and the ``qkv``, ``proj`` and CRPE weights and biases once.

Its bound is the largest of the bytes over the memory rate, the product
operations over the tensor cores' rate and the CRPE's over the CUDA cores':
the three units run at once, so the least time is the longest of the three,
not their sum.  The rates are ``costs.py``'s published peaks.
"""

from __future__ import annotations

import math
from typing import Iterator, Sequence, Tuple

from .costs import F32_FLOP_PER_S, HBM_BYTES_PER_S, PEAK_FLOPS
from .factor import CRPE_WINDOW

ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def grids(hw: Sequence[int], stages: int) -> Iterator[Tuple[int, int]]:
    """Each stage's token grid for an image of ``hw``: MPViT's stem halves
    it, and each stage after the first halves it again (3x3 convolutions of
    stride 2, padding 1)."""
    h, w = hw
    for i in range(stages):
        k = 2 ** (i + 1)
        yield math.ceil(h / k), math.ceil(w / k)


def block_costs(batch: int, tokens: int, dim: int, heads: int, es: int,
                window=CRPE_WINDOW) -> Tuple[int, int, int]:
    """(bytes, product operations, CRPE operations) of one block's mixer."""
    d = dim // heads
    taps = sum(hs * w * w for w, hs in window)
    weights = 3 * dim * dim + 3 * dim + dim * dim + dim + d * taps + dim
    return ((2 * batch * tokens * dim + weights) * es,
            2 * batch * tokens * (4 * dim * dim + 2 * dim * d),
            2 * batch * tokens * d * taps)


def block_bound_s(batch: int, tokens: int, dim: int, heads: int, dtype: str) -> float:
    nbytes, mm, taps = block_costs(batch, tokens, dim, heads, ELEMENT_BYTES[dtype])
    return max(nbytes / HBM_BYTES_PER_S, mm / PEAK_FLOPS[dtype], taps / F32_FLOP_PER_S)


def stage_blocks(cfg: dict, hw: Sequence[int]) -> Iterator[Tuple[int, int, int, int]]:
    """(blocks, tokens a B-scan, channels, heads) of each stage of the
    configuration's MPViT at the image size ``hw``."""
    v = cfg["mpvit"]
    for i, (gh, gw) in enumerate(grids(hw, len(v["embed_dims"]))):
        yield (v["num_path"][i] * v["num_layers"][i], gh * gw, v["embed_dims"][i],
               v["num_heads"][i])


def mixers(cfg: dict) -> int:
    """The attention mixers a forward runs: every MHCA block's."""
    v = cfg["mpvit"]
    return sum(p * n for p, n in zip(v["num_path"], v["num_layers"]))


def batch_bound_s(cfg: dict, traffic: dict) -> float:
    """The least seconds of one batch's mixers: the blocks' bounds summed."""
    return sum(n * block_bound_s(traffic["batch"], tokens, dim, heads, traffic["dtype"])
               for n, tokens, dim, heads in stage_blocks(cfg, traffic["hw"]))
