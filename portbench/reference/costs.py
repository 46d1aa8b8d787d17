"""Frozen yardsticks: the published peaks of one NVIDIA H100 SXM and, for
each ``tcct::`` op of the program, the operations and the bytes one call
needs, from its arguments' shapes.

A kernel's roofline bound is the larger of its bytes over the memory rate
and its operations over the rate of the units it runs on.  The formulas
were copied from the program's ``*_flops`` functions and its kernel
table's byte counts as they stood when the benchmark was written, and are
kept here so that a kernel's bound reads the same work whatever later
implements it.  Bytes count each input read once and each output written
once; ``es`` is the element size of the op's main tensor.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12  # FMA on the CUDA cores, outside the tensor cores
BF16_FLOP_PER_S = 989e12  # dense tensor cores
# the dense peak of the type a configuration computes in, for utilization
PEAK_FLOPS = {"bfloat16": BF16_FLOP_PER_S, "float32": F32_FLOP_PER_S}

Shape = Sequence[int]


def _n(shape: Shape) -> int:
    return math.prod(shape)


def _dw_out(x: Shape, stride: int) -> int:
    B, H, W, C = x
    return B * ((H - 1) // stride + 1) * ((W - 1) // stride + 1) * C


def metapool_tokens(dims, es, args) -> Tuple[int, int]:
    x = dims[0]  # [B, N, C]: x read, y written
    return 2 * _n(x) * es, 11 * _n(x)


def metapool_block(dims, es, args) -> Tuple[int, int]:
    x = dims[0]  # x read, y and n2 written, four [C] affines
    return (3 * _n(x) + 4 * x[-1]) * es, 30 * _n(x)


def dwconv3x3(dims, es, args) -> Tuple[int, int]:
    x, stride = dims[0], int(args[3])  # NHWC x, [3, 3, C] taps
    n_out = _dw_out(x, stride)
    return (_n(x) + n_out + 9 * x[3]) * es, 18 * n_out


def dwconv3x3_backward(dims, es, args) -> Tuple[int, int]:
    x, stride = dims[0], int(args[3])  # x and g read; dx (if asked) and dw written
    n_out = _dw_out(x, stride)
    need_dx = str(args[6]).lower() not in ("false", "0")
    return ((_n(x) * (2 if need_dx else 1) + n_out + 18 * x[3]) * es,
            36 * n_out)


def bn_act_train(dims, es, args) -> Tuple[int, int]:
    x = dims[0]  # NCHW x read, y written; four f32 [C] vectors
    return 2 * _n(x) * es + 16 * x[1], 8 * _n(x)


def bn_act_train_backward(dims, es, args) -> Tuple[int, int]:
    x = dims[0]  # x, gy read, dx written; weight, mean, var, dweight, dbias
    return 3 * _n(x) * es + 20 * x[1], 12 * _n(x)


def bn_act_sums(dims, es, args) -> Tuple[int, int]:
    x = dims[0]
    return _n(x) * es + 8 * x[1], 3 * _n(x)


def bn_act_normalize(dims, es, args) -> Tuple[int, int]:
    x = dims[0]
    return 2 * _n(x) * es + 24 * x[1], 5 * _n(x)


def bn_act_backward_sums(dims, es, args) -> Tuple[int, int]:
    x = dims[0]
    return 2 * _n(x) * es + 8 * x[1], 3 * _n(x)


def bn_act_backward_dx(dims, es, args) -> Tuple[int, int]:
    x = dims[0]
    return 3 * _n(x) * es + 28 * x[1], 6 * _n(x)


def cross_block_geometry(cin: int, cout: int, k: int):
    """(kh, kw, input channels) of the six convs of a CrossCNN block."""
    return [(3, 3, cin), (3, 3, cout), (1, k, cin), (k, 1, cout), (3, 3, cout), (3, 3, cout)]


def fused_cross_block(dims, es, args) -> Tuple[int, int]:
    x = dims[0]  # NHWC x read, y written, the weights once
    cin, cout, k = int(args[4]), int(args[5]), int(args[6])
    B, H, W, _ = x
    geo = cross_block_geometry(cin, cout, k)
    taps = sum(kh * kw * ci * cout for kh, kw, ci in geo)
    return (_n(x) + B * H * W * cout + taps) * es, 2 * B * H * W * taps


# op name -> (formula, whether it runs on the tensor cores in bf16)
FORMULAS: Dict[str, Tuple[Callable, bool]] = {
    "tcct::metapool_tokens": (metapool_tokens, False),
    "tcct::metapool_tokens_backward": (metapool_tokens, False),
    "tcct::metapool_block": (metapool_block, False),
    "tcct::metapool_block_shard": (metapool_block, False),
    "tcct::dwconv3x3": (dwconv3x3, False),
    "tcct::dwconv3x3_backward": (dwconv3x3_backward, False),
    "tcct::bn_act_train": (bn_act_train, False),
    "tcct::bn_act_train_backward": (bn_act_train_backward, False),
    "tcct::bn_act_sums": (bn_act_sums, False),
    "tcct::bn_act_normalize": (bn_act_normalize, False),
    "tcct::bn_act_backward_sums": (bn_act_backward_sums, False),
    "tcct::bn_act_backward_dx": (bn_act_backward_dx, False),
    "tcct::fused_cross_block": (fused_cross_block, True),
}

ELEMENT_SIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}


def bound_s(op: str, dims, types, args) -> float:
    """The least time one call of ``op`` could take on the card: the larger
    of its bytes over the memory rate and its operations over its units'
    rate.  ``dims``, ``types`` and ``args`` are the call's input shapes,
    types and values as the profiler records them."""
    fn, tensor_cores = FORMULAS[op]
    es = ELEMENT_SIZE.get(types[0], 4)
    nbytes, ops = fn(dims, es, args)
    rate = BF16_FLOP_PER_S if tensor_cores and es == 2 else F32_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)
