"""Fused CrossCNNBlock inference forward: a hand-written CUDA kernel
(``csrc/crosscnn_fused.cu``) and its plain PyTorch version.

Replaces the TPU kernel ``attic/crosscnn_fused.py::_block_kernel``
(``pallas_call`` at crosscnn_fused.py:237, reached through
``fused_cross_block`` and ``cross_resnet_fused``; the pyramid that calls
this block five times is ``models/crosscnn.py::cross_resnet_fused``).  One
launch runs the six chained convs of a block with bias, LeakyReLU, folded
eval BatchNorm and erf GELU, reading ``x`` once and writing ``y`` once.  The
kernel is bound by operations.  The input type decides how it runs: bf16 on
the tensor cores (``mma.sync``, f32 accumulators; Cin a multiple of 16 and
Cout of 32, as every model's blocks have), f32 as f32 FMAs on the CUDA
cores.  See the source's header notes for the design.

Roundings follow the TPU kernel, not the module path: sums, bias,
LeakyReLU, ``x * scale + shift``, ``a + b`` and the exact erf GELU are f32,
and a value is rounded to the input type only before each following conv
and at the output.  In bf16 the module path (``models/crosscnn.py``) rounds
after every op and uses the tanh GELU, so the two differ there by bf16
roundings; in f32 they differ by summation order only.

Inference only: there is no backward.  :func:`fused_cross_block` raises on
a block in train mode and on inputs that would need a gradient.  The op's
``out`` overload (``tcct::fused_cross_block.out``, the arguments then
``y``) launches the same kernel into a given output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from tcct_tpu_torch.ops.kernels import build, library

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass
class CrossBlockPack:
    """One block's operands as the kernel reads them.

    ``w``: the six conv weights, each tap-major ``[kh*kw, Cin, Cout]``, back
    to back in the compute dtype, in the order block12.0, block12.1,
    block34.0, block34.1, block34.2, block5.0.  ``vec``: f32 ``[12, Cout]``,
    the six biases in that order, then (scale, shift) of the folded
    BatchNorms of block12, block34 and block5.  ``wf``: in bf16 with Cin a
    multiple of 16 and Cout of 32, the same six weights fragment-major as
    the tensor cores read them, else None."""

    w: torch.Tensor
    vec: torch.Tensor
    cin: int
    cout: int
    k: int
    wf: Optional[torch.Tensor] = None

    def geometry(self) -> List[Tuple[int, int, int]]:
        """(kh, kw, cin) of the six convs."""
        ci, co, k = self.cin, self.cout, self.k
        return [(3, 3, ci), (3, 3, co), (1, k, ci), (k, 1, co), (3, 3, co), (3, 3, co)]

    def conv(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Conv ``i`` as f32 ``(weight [Cout,Cin,kh,kw], bias [Cout])``: the
        rounded operands, widened."""
        geo = self.geometry()
        off = sum(kh * kw * ci * self.cout for kh, kw, ci in geo[:i])
        kh, kw, ci = geo[i]
        n = kh * kw * ci * self.cout
        w = self.w[off:off + n].view(kh, kw, ci, self.cout).permute(3, 2, 0, 1)
        return w.float(), self.vec[i]


def fold_bn(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as an f32 (scale, shift) pair."""
    scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    return scale, bn.bias.float() - bn.running_mean.float() * scale


def _fragment_major(w: torch.Tensor) -> torch.Tensor:
    """Tap-major ``[taps, Cin, Cout]`` -> ``[taps, Cin/16, Cout/8, 32, 4]``:
    for each 16 x 8 (input x output channel) block the two registers of
    every lane of an ``mma.m16n8k16`` B fragment, lane ``4 g + t`` holding
    input channels ``2t, 2t+1`` then ``2t+8, 2t+9`` of output channel ``g``."""
    taps, cin, cout = w.shape
    v = w.view(taps, cin // 16, 2, 4, 2, cout // 8, 8)  # [tap, kc, reg, t, half, nt, g]
    return v.permute(0, 1, 5, 6, 3, 2, 4).reshape(-1)


def _block_tensors(block):
    convs = [block.block12[0], block.block12[1], block.block34[0], block.block34[1],
             block.block34[2], block.block5[0]]
    bns = [block.block12[-1], block.block34[-1], block.block5[-1]]
    return convs, bns


@torch.no_grad()
def pack_cross_block(block, dtype: torch.dtype) -> CrossBlockPack:
    """The :class:`CrossBlockPack` of a ``CrossCNNBlock`` in ``dtype``, on
    the block's device.  The pack is kept on the module and made again only
    when one of its tensors was replaced or written (a tensor made under
    ``torch.inference_mode()`` counts no writes: replace it to repack)."""
    convs, bns = _block_tensors(block)
    if torch.compiler.is_compiling():  # traced (torch.export): the pack is part of the graph
        return _pack(convs, bns, dtype)
    tensors = [t for c in convs for t in (c.weight, c.bias)]
    tensors += [t for bn in bns for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var)]
    stamp = (dtype, tensors[0].device) + tuple((t.data_ptr(), 0 if t.is_inference() else t._version)
                             for t in tensors)
    cached = block.__dict__.get("_fused_pack")
    if cached is not None and cached[0] == stamp:
        return cached[1]
    pack = _pack(convs, bns, dtype)
    block.__dict__["_fused_pack"] = (stamp, pack)
    return pack


def _pack(convs, bns, dtype: torch.dtype) -> CrossBlockPack:
    cout, cin = convs[0].weight.shape[:2]
    k = convs[2].weight.shape[3]
    want = [(cout, ci, kh, kw) for kh, kw, ci in CrossBlockPack(None, None, cin, cout, k).geometry()]
    if [tuple(c.weight.shape) for c in convs] != want:
        raise ValueError(f"fused_cross_block: not a CrossCNNBlock's convs: "
                         f"{[tuple(c.weight.shape) for c in convs]}")
    taps = [c.weight.to(dtype).permute(2, 3, 1, 0).flatten(0, 1) for c in convs]
    w = torch.cat([t.reshape(-1) for t in taps])
    vec = torch.stack([c.bias.float() for c in convs] + [v for bn in bns for v in fold_bn(bn)])
    wf = None
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 32 == 0:
        wf = torch.cat([_fragment_major(t) for t in taps]).contiguous()
    return CrossBlockPack(w.contiguous(), vec.contiguous(), cin, cout, k, wf)


def _lrelu(t: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(t, 0.01)


def fused_cross_block_reference(x: torch.Tensor, block,
                                acc: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: NHWC ``x`` [B,H,W,Cin] -> [B,H,W,Cout] in x's dtype,
    for a ``CrossCNNBlock`` or its :class:`CrossBlockPack` (``block``; the
    op's CPU implementation passes the pack).  The rounded operands are
    widened to f32, every conv is ``F.conv2d`` in f32 (zero padding of its
    own input), the epilogues are f32, and a value is rounded to x's dtype
    where the kernel rounds it.

    ``acc=torch.float64`` runs the same chain, rounded at the same places,
    with f64 sums and epilogues and returns it in f64: the yardstick for
    how far summation order moves either version."""
    pk = block if isinstance(block, CrossBlockPack) else pack_cross_block(block, x.dtype)
    dt, k2 = x.dtype, pk.k // 2
    s12, t12, s34, t34, s5, t5 = (v[None, :, None, None].to(acc) for v in pk.vec[6:])

    def conv(i, t, pad):
        w, b = pk.conv(i)
        return F.conv2d(t.to(dt).to(acc), w.to(acc), b.to(acc), padding=pad)

    xc = x.permute(0, 3, 1, 2)
    a = conv(1, conv(0, xc, 1), 1)
    a = _lrelu(a) * s12 + t12
    b = conv(4, conv(3, conv(2, xc, (0, k2)), (k2, 0)), 1)
    b = _lrelu(b) * s34 + t34
    y = conv(5, F.gelu(a + b), 1)
    y = _lrelu(y) * s5 + t5
    return y.to(dt if acc == torch.float32 else acc).permute(0, 2, 3, 1).contiguous()


@functools.cache
def _fn(name: str):
    """A C entry point of the library, typed (built and loaded on first use)."""
    fn = getattr(build.load("crosscnn_fused"), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "tcct_crosscnn_fused_fwd":
        fn.argtypes = [p] * 4 + [i] * 7 + [p]
        fn.restype = i
    elif name == "tcct_crosscnn_fused_fwd_at":  # the bf16 launch at a given plan, for tests
        fn.argtypes = [p] * 4 + [i] * 9 + [p]
        fn.restype = i
    else:  # tcct_crosscnn_fused_plan
        fn.argtypes = [i] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_longlong
    return fn


class FusedPlan(NamedTuple):
    """How a launch runs: the tile (``th`` x ``tw`` output pixels a block);
    in bf16 the steps of each of the weights' two ring slots (``ring``; 0:
    each stage's weights resident in shared memory); ``threads`` a block;
    the block's shared-memory bytes (``smem``) and those of the weights among
    them (``weight_smem``)."""

    th: int
    tw: int
    ring: int
    threads: int
    smem: int
    weight_smem: int


def fused_plan(B: int, H: int, W: int, cin: int, cout: int, k: int,
               dtype: torch.dtype) -> FusedPlan:
    """The :class:`FusedPlan` the launch picks for this shape (the f32
    kernel's has ``ring = weight_smem = 0``).  Needs the built library."""
    plan = (ctypes.c_int * 5)()
    smem = _fn("tcct_crosscnn_fused_plan")(B, H, W, cin, cout, k, _DTYPES[dtype], plan)
    if smem < 0:
        raise build.KernelError(f"fused_cross_block: no plan for Cin {cin} Cout {cout} k {k} "
                                f"{dtype}")
    return FusedPlan(*plan[:4], int(smem), plan[4])


def _fused_cuda(x, w, vec, wf, cin: int, cout: int, k: int, y=None):
    """The block's launch, into ``y`` where it is given (the ``out``
    overload)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"fused_cross_block: want NHWC float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    B, H, W, C = x.shape
    if C != cin or w.device != x.device or vec.device != x.device:
        raise ValueError(f"fused_cross_block: x has {C} channels on {x.device}, the block takes "
                         f"{cin} on {w.device}")
    if cin % 8 or cout % 8 or k % 2 == 0 or k < 3:
        raise ValueError(f"fused_cross_block: want Cin and Cout multiples of 8 and k odd, got "
                         f"{cin} {cout} {k}")
    if x.dtype == torch.bfloat16 and wf is None:
        raise ValueError(f"fused_cross_block: bfloat16 wants Cin a multiple of 16 and Cout of "
                         f"32, got {cin} {cout}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    if y is None:
        y = x.new_empty((B, H, W, cout))
    else:
        library.check_out("fused_cross_block", y, (B, H, W, cout), x)
    if y.numel() == 0:
        return y
    w = (w if wf is None else wf).contiguous()
    vec = vec.contiguous()
    err = _fn("tcct_crosscnn_fused_fwd")(
        x.data_ptr(), w.data_ptr(), vec.data_ptr(), y.data_ptr(), B, H, W, cin, cout, k,
        _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, f"fused_cross_block {tuple(x.shape)} -> {cout} k {k} {x.dtype}")
    fused_cross_block.launches += 1
    return y


def _fused_fake(x, w, vec, wf, cin: int, cout: int, k: int):
    return x.new_empty(tuple(x.shape[:3]) + (cout,))


# the block's pack as tensors (w tap-major, vec, wf fragment-major or None)
# and its geometry as ints, so that a traced graph carries the pack
_fused_op = library.define(
    "fused_cross_block(Tensor x, Tensor w, Tensor vec, Tensor? wf, int cin, int cout, int k) "
    "-> Tensor",
    cpu=lambda x, w, vec, wf, cin, cout, k: fused_cross_block_reference(
        x, CrossBlockPack(w, vec, cin, cout, k, wf)),
    cuda=_fused_cuda, fake=_fused_fake)
library.no_backward(_fused_op, "fused_cross_block")
library.define_out(_fused_op, "Tensor(a!) y", cuda=_fused_cuda, outputs=_fused_fake)


def fused_cross_block(x: torch.Tensor, block) -> torch.Tensor:
    """One eval-mode ``CrossCNNBlock`` in one kernel: NHWC ``x``
    [B,H,W,Cin] -> [B,H,W,Cout] in x's dtype (f32 or bf16), any H and W:
    the op ``tcct::fused_cross_block`` on the block's pack.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel, or the call raises.  There is no backward: a block in train mode
    raises, and so does grad mode with an input or a parameter that requires
    a gradient."""
    if block.training:
        raise ValueError("fused_cross_block: inference only (eval-mode BatchNorm); "
                         "the block is in train mode")
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in block.parameters())):
        raise ValueError("fused_cross_block has no backward: call it under torch.no_grad() "
                         "or torch.inference_mode()")
    library.check_device(x, "fused_cross_block")
    pk = pack_cross_block(block, x.dtype)
    return _fused_op(x, pk.w, pk.vec, pk.wf, pk.cin, pk.cout, pk.k)


def fused_cross_block_flops(x_shape, cin: int, cout: int, k: int) -> int:
    """Operations of K4 on NHWC ``x_shape``: a multiply and an add for every
    tap of its six convs at every pixel (no halo recompute)."""
    B, H, W, _ = x_shape
    geo = CrossBlockPack(None, None, cin, cout, k).geometry()
    return 2 * B * H * W * sum(kh * kw * ci * cout for kh, kw, ci in geo)


# launches of the kernel
fused_cross_block.launches = 0
