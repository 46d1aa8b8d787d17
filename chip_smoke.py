#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tcct_tpu_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``):

1. prints the card's name and power limit (``nvidia-smi``) and builds
   every kernel of ``tcct_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once);
2. holds each kernel (MetaPool forward and backward, depthwise 3x3
   forward and backward at strides 1 and 2, train BatchNorm forward and
   backward) against its plain PyTorch version on the card, at every
   shape the duke serving path and the train step give it (the depthwise
   forward also at MPViT-small's, ``stc_st``), in bf16 and in f32 (TF32
   off), and times kernel, plain version and the one-call PyTorch
   yardstick on the device (CUDA-graph replay, inputs beyond L2); one
   train BatchNorm forward and backward captured in a CUDA graph and
   replayed, bit for bit the eager calls; the depthwise backward at the
   ConvPosEnc site (the residual and the bias gradient in its one
   launch) against the kernel and the two plain passes, and one such call
   captured in a CUDA graph and replayed; the depthwise forward's
   two kernels at several strip heights; its bias-and-residual epilogue
   (the ConvPosEnc site) bit for bit against the three passes it
   replaces, and timed against them; the MetaPool site of the serving
   block (LayerNorm1, K1, the residual add, LayerNorm2 in one launch) at
   the serving shapes of ``stc_tt`` and ``stc_st``: its bare and
   residual-only flags bit for bit against K1 and K1 + x, the whole site
   against its plain version, timed against the four ops it replaces;
   then the fused CrossCNN
   block kernel at the five duke levels of ``stc_tt``, the four
   channel-changing levels of ``gtc_tb``, a plain (k = 3) block, an
   input smaller than a tile and one whose weights stream through the
   ring;
3. serves a 20-scan seeded duke volume through ``load_predictor`` at full
   width (random-init weights, batch 8, bf16) with the launch counts set
   to 0 just before and read just after (one site launch a MetaPool site,
   no bare K1), checks the class maps (shape, dtype, agreement with the f32
   predictor, and with the maps of the same eval model called with a
   gradient enabled, which runs each site as four ops: bf16 at least 99.9 %
   of pixels, f32 at least 99.999 %) and the f32 model against the CPU path
   on a small input, times the steady state and profiles one batch (no
   LayerNorm launch may remain);
4. exports the duke bf16 model (``infer/export.py``, ``drive_export``):
   its ``tcct::`` ops held to the per-batch launch table, the program
   served in a fresh process (``--serve-exported``) with the maps and the
   launches per batch equal to the eager predictor's and a batch of 3
   equal to the eager model's, f32 maps equal to the eager f32 maps and
   on 99.999 % of pixels the CPU program's, the program's ms per batch
   against the eager module's in turns, its profile by op and its cost;
5. serves the same volume with ``cnn_impl='fused'`` (the CNN branch
   through the fused block kernel), counts read around it, and holds its
   class maps against the plain path's (f32: at least 99.9 % of pixels);
   then ``gtc_tb`` (the wide CNN branch, gated fusion) both ways, one
   batch of every other model of the registry, and one batch of ``stc_tt``
   in every other dataset bucket, both ways, each bucket's maps held with
   and without the site as for duke;
6. holds the f32 train step on the card against the CPU path on the
   golden 64x64 parity case (step-0 gradients, one AdamW step);
7. trains ``RegNet(stc_tt, 'train')`` at full width (bf16, batch 8 at
   256x256, seeded random weights and a seeded banded batch) for 5 steps
   with the launch counts read around the first, checks every loss is
   finite, prints ms/step, peak memory and the device profile of a sixth
   by group with its launch count, and holds one step run twice from one
   state and one generator to bitwise-equal parameters and statistics;
8. runs the f32 train step on the card for 50 steps on the golden parity
   case and holds the losses and the final parameter L2 at the bounds of
   ``tests/test_train_parity.py``;
9. drives the training entry point (``drive_engine``): ``EyeSet.load``
   (synthetic goals, 608x512), a ``Trainer`` of ``stc_tt`` at full width
   with augmentation (bf16, batch 8, crop 256, debug) fitting 2 epochs
   with val, the launch counts read around the fit (every train kernel and
   the MetaPool site must launch); a resume from the epoch-0 checkpoint in
   a new Trainer held bit for bit to the unbroken run (parameters,
   buffers, moments, count, generator); one augmented step twice from one
   state, bit for bit; the augmentation with no host sync; one streaming
   epoch over 16 PNG files decoded by the native loader; the CLI as a
   subprocess; the times (ms/step with and without augmentation in turns,
   the augmentation's launches and device ms, val ms a scan, an epoch's
   wall time);
10. trains the rest of the zoo: ``gtc_tt`` (gated fusion, whose random
   alpha maps make everything after the fusion f32) at full width, one
   bf16 step with the launch counts held to the config's table
   (``train_launches``), its ms/step, busy ms and launches beside
   ``stc_tt``'s, one augmented step twice from one state, bit for bit, the
   f32 step against the CPU and the 50-step f32 trajectory on
   ``train_parity_gtc.npz``, a ``Trainer`` fit with val and a bitwise
   resume (``drive_gtc_train``); one bf16 step of every other model and
   mixer (``gtc_tb``, ``stc_tb``, ``stc_st``, ``stc_sb``, ``cnnu``,
   ``pnnu``, ``vitu``, ``msca``, ``tcct32``, ``relay``, ``stc_tt`` with
   ``factor``, ``hydra`` and ``metapool2d``), finite and counted
   (``drive_zoo_steps``); one duke serving batch of each model and mixer
   the slice adds, counted, the f32 model against the CPU, ms
   (``drive_zoo_serving``);
11. runs task 2, the ResNet glaucoma classifier, in f32 (``drive_task2``):
   a counted res18 step (batch 8 at 224x224, augmented: K3 and K3b 20
   each, every call held against its plain version), the step on the card
   against the CPU, one step twice bit for bit, its profile, eager ms/step
   with and without deterministic convs and peak memory, counted res34 and
   res50 steps, a ``ClsTrainer`` debug fit and reload, eval images/s, the
   TTA, the ensemble CLI, and a PNG folder with xlsx labels; the K3/K3b rows
   of step 2 also run every f32 shape of the res18 and res50 steps;
12. runs data parallelism (``drive_distributed``, the port's
   ``parallel/``): (a) the two-phase entry points of K3/K3b (sums, then
   normalize; backward sums, then dx) at every BN shape of the stc_tt step,
   bf16 and f32, bitwise the one-launch kernels at one rank, their device
   time a step against the one launch and SyncBatchNorm's library kernels;
   (b) NCCL with one rank: one augmented bf16 stc_tt step at full width on
   ``make_mesh(1)`` bitwise the step without a mesh (every state tensor),
   with the two-phase entry points launched 53 times each and K3/K3b not
   at all; (c) two processes sharing the card over gloo (``--dp-worker``),
   global batch 8: three augmented bf16 steps with the ranks' states
   bitwise equal after each, ms/step and the collectives a step, and one
   f32 step against one process within the bounds of step 6, a gradient
   past them no further from the step in f64 (on the CPU) than twice the
   one-process step's distance from it; (d) the duke
   volume through ``load_predictor(mesh=)`` on the two ranks against the
   one-process predictor; (e) the CLI with ``--pl`` under two processes;
   the phase's seconds.  No speed is claimed: one card shows none;
13. runs the width-sharded predictor (``drive_width_sharded``, the port's
   ``parallel/spatial.py``): (a) the MetaPool site's shard entry point
   (``metapool_block_shard``) at duke's four site shapes, 4 rows a rank,
   split 2 and 4 ways, bf16 and f32, against its plain version, the
   ranks' outputs reassembled bit for bit the one-launch site, timed
   against the plain version and the one-launch site on as many tokens,
   and the decoder's sharded upsampling against ``F.interpolate``; (c)
   the fused CrossCNN block (K4) on a rank's haloed blocks at duke's five
   levels, bf16 and f32: the cropped maps of 2 and 4 ranks bit for bit the
   one-launch K4 on the whole map, rank 0's launch against its plain
   version and timed against it and one K4 on as many columns, with its
   bound;
   (b) four processes sharing the card over gloo (``--ws-worker``) as a
   (2, 2) ``('data', 'model')`` mesh serving the duke volume through
   ``load_predictor(mesh=)`` in bf16 and f32: the launch counts a rank
   (the shard site 4 a batch, K2 s1 9, K2 s2 3, the one-launch site 0),
   the halo exchanges a batch with their bytes, every rank's maps equal,
   and on at least 99.9 % of pixels the one-process maps of step 3; then
   one duke batch of ``stc_tt`` with the ``factor``, ``hydra`` and
   ``metapool2d`` mixers, ``relay``, ``msca`` and ``stc_tt`` with the fused
   CNN branch, and one heg batch (672 columns: blocks 176, 176, 160, 160)
   of ``stc_tt`` both ways on a (1, 4) mesh, bf16 and f32, each with its
   launches (K4 5 a rank a batch on the fused branch), exchanges and
   all-reduces held to the config's and its maps against one process's
   (bf16 at least 99.9 % of pixels, f32 99.999 %, f32 bitwise printed);
   the phase's seconds.  No speed is claimed;
14. prints one JSON line of the kernels, then, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  Without a CUDA card, or
outside a checkout, it exits non-zero and prints no result.

    python3 chip_smoke.py --against DIR [NAME ...]

builds DIR's kernel sources (another checkout, e.g. the parent commit
unpacked with ``git archive``) beside this one's and holds this tree's
kernels against them at every shape of the main paths (the kernel table's
shapes, the MetaPool site's and the fused block's), in bf16 and f32: bit
for bit (a difference fails the run), device us per call in turns (other,
this, this, other), and each kernel's totals per serving batch and per
train step.  A kernel is compared only where DIR's C entries that it calls
are declared exactly as this tree's; NAME prefixes pick kernels by name
(``metapool``, ``dwconv3x3_backward``, ``fused_cross_block``, ...).

    python3 chip_smoke.py --dp-worker RANK STORE OUT

is one of the two ranks of step 12 (c) and (d), meeting the other through
the file store STORE and writing its numbers to OUT.

    python3 chip_smoke.py --ws-worker RANK STORE OUT

is one of the four ranks of step 13 (b), meeting the others through the
file store STORE, writing its numbers to OUT and rank 0 its maps beside it.

    python3 chip_smoke.py --serve-exported PROGRAM OUT

is the fresh process of step 4: it loads the exported bf16 program with
``load_exported``, serves the duke volume through it with the launches
counted, then a batch of 3, and writes the maps and counts to ``OUT``.

    python3 chip_smoke.py --profile DIR

imports ``tcct_tpu_torch`` from DIR (another checkout, or ``.``), builds
its kernels and prints, not held: one duke bf16 serving batch of ``stc_tt``
(plain and fused) and of ``stc_st`` (replayed and eager ms, device busy
ms, launches, the layer_norm and MetaPool groups); then the train step's
ms/step, the device time of one step by group (train BatchNorm forward
and backward, polarization bins and bilinear backward named apart) and its
launch count, the ops that ``torch.use_deterministic_algorithms`` names,
and which state tensors differ when one step runs twice from one state;
then the host us a call of each kernel wrapper at a small shape, forward
and forward plus backward (``dispatch_diagnostics``).
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter

# H100 SXM published peaks (NVIDIA data sheet), the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor-core rate

# kernel vs plain version: |kernel - plain| <= atol + rtol * |plain|
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 2.0 ** -7)}  # (atol, rtol)

DB, BATCH, N_SCANS, SEED = "duke", 8, 20, 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, inputs, iters: int = 30) -> float:
    """Mean ms per call over ``iters`` eager calls, cycling through
    ``inputs`` (argument tuples), by CUDA events: host dispatch included."""
    import torch

    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, inputs, iters: int = 30) -> float:
    """Mean device ms per call: ``iters`` calls cycling through ``inputs``
    (enough copies to exceed L2) captured in one CUDA graph and replayed,
    so the host's dispatch cost of each call drops out."""
    import torch

    for args in inputs[:2]:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def n_copies(nbytes: int) -> int:
    """Input copies that together exceed the 50 MB L2 twice over."""
    return max(2, min(16, math.ceil(100e6 / max(nbytes, 1))))


def path_shapes(cfg, batch: int, hw):
    """Launch counts per serving batch, by input shape, of each kernel on
    the MPViT branch: (metapool [B,N,C], dwconv stride 1 [B,H,W,C],
    dwconv stride 2 [B,H,W,C]).  The MetaPool mixers run one MetaPool site a
    block; factor and hydra one K2 a block in the CRPE (window 3)."""
    from tcct_tpu_torch.models.mpvit import CRPE_MIXERS, _fit_crpe_window

    mp, s1, s2 = Counter(), Counter(), Counter()
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1  # after the stride-2 stem
    for i, C in enumerate(cfg.embed_dims):
        for p in range(cfg.num_path[i]):
            if i > 0 and p == 0:  # the stride-2 patch embed of a pooling stage
                s2[(batch, h, w, C)] += 1
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            else:
                s1[(batch, h, w, C)] += 1
        blocks = cfg.num_path[i] * cfg.num_layers[i]
        s1[(batch, h, w, C)] += blocks + 1  # cpe per block, InvRes
        if cfg.mixer in ("metapool", "metapool_pallas"):
            mp[(batch, h * w, C)] += blocks
        elif cfg.mixer in CRPE_MIXERS:  # the CRPE's window-3 heads, the split refit
            heads3 = dict(_fit_crpe_window(cfg.crpe_window, cfg.num_heads[i])).get(3, 0)
            s1[(batch, h, w, heads3 * (C // cfg.num_heads[i]))] += blocks
    return mp, s1, s2


# the two-phase entry points of K3/K3b, which a data-parallel step runs
SPLIT_BN = ("bn_act_sums", "bn_act_normalize", "bn_act_backward_sums", "bn_act_backward_dx")


def train_launches(model, data_parallel: bool = False):
    """Launches of each kernel in one train step of ``model`` (a RegNet of
    the zoo: any name, flags, variant and mixer): the per-kernel sums of
    :func:`train_shapes`.  ``data_parallel``: a step on a mesh (any rank
    count), whose train BatchNorms run the two-phase entry points (sums,
    normalize; backward sums, dx) in place of K3 and K3b, the loss heads'
    on the gathered batch too."""
    n = {k: sum(c.values()) for k, c in train_shapes(model, 1, (64, 64)).items()}
    out = {"metapool_tokens": n["mp"], "metapool_tokens_backward": n["mp"],
           "dwconv3x3_s1": n["s1"], "dwconv3x3_backward_s1": n["s1"],
           "dwconv3x3_s2": n["s2"], "dwconv3x3_backward_s2": n["s2"],
           "bn_act_train": n["bn"], "bn_act_train_backward": n["bnb"]}
    if data_parallel:
        out.update(bn_act_train=0, bn_act_train_backward=0, bn_act_sums=n["bn"],
                   bn_act_normalize=n["bn"], bn_act_backward_sums=n["bnb"],
                   bn_act_backward_dx=n["bnb"])
    return out


def cpe_shapes(cfg, batch: int, hw):
    """ConvPosEnc calls per serving batch, by input shape [B,H,W,C]: one per
    MHCA block, each a depthwise 3x3 with bias plus its own input."""
    out = Counter()
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1  # after the stride-2 stem
    for i, C in enumerate(cfg.embed_dims):
        if i > 0:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        out[(batch, h, w, C)] += cfg.num_path[i] * cfg.num_layers[i]
    return out


def check_close(name, got, want, dtype_name):
    import torch

    atol, rtol = TOL[dtype_name.split("/")[0]]  # the input's type
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite output")
    bad = err > atol + rtol * w.abs()
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} elements outside atol {atol} rtol {rtol}, "
             f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def check_within(name, got, want, limit):
    """|got - want| <= limit elementwise (a tensor of per-element bounds)."""
    import torch

    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name}: non-finite output")
    if not bool((err <= limit).all()):
        fail(f"{name}: {int((err > limit).sum())} elements outside their bound, "
             f"max excess {float((err - limit).max()):.3e}")
    return float(err.max())


def check_bn_backward(name, x, w, mean, var, gy, leaky, got):
    """K3b's (dx, dweight, dbias) against the plain adjoint on the same
    inputs, within ``bn_act_train_backward_tolerance``.  Returns dx's max
    abs error."""
    from tcct_tpu_torch.ops.kernels.bnstats import (
        bn_act_train_backward_reference,
        bn_act_train_backward_tolerance,
    )

    want = bn_act_train_backward_reference(x, w, mean, var, gy, 1e-5, leaky)
    lims = bn_act_train_backward_tolerance(x, w, mean, var, gy, 1e-5, leaky)
    errs = [check_within(f"{name} {what}", a.double(), b.double(), lim)
            for what, a, b, lim in zip(("dx", "dweight", "dbias"), got, want, lims)]
    return errs[0]


def train_shapes(model, batch: int, hw):
    """Launch counts per bf16 train step of ``model`` (a RegNet of the zoo:
    any name, flags, variant and mixer; the loss heads on, udh and reg), by
    input shape and types, of every kernel.  Returns a dict of Counters:
    "mp" [B,N,C] and "s1" / "s2" [B,H,W,C] (NHWC inputs) keyed (shape,
    types); "bn" (forward) and "bnb" (backward) [B,C,H,W] keyed (shape,
    leaky, types).  ``types`` is the input's dtype, then the weights' after a
    slash where they differ: "float32/bfloat16" is an f32 map (after a
    trained gate, in ReLayNet's decoder, the lap_map head) before bf16
    compute weights.  The MetaPool and depthwise backwards equal their
    forwards (every launch is on the gradient's path); every BN's too except
    in ``vitu``, which runs the CNN branch's levels 1-4 and reads only level
    0: their 12 BatchNorms have no backward."""
    bf, f32, wide = "bfloat16", "float32", "float32/bfloat16"
    mp, s1, s2, bn, unread = Counter(), Counter(), Counter(), Counter(), Counter()
    H, W = hw
    base = model.base
    cfg = getattr(base, "vit_cfg", None)
    if cfg is None:  # ReLayNet: its decoder runs f32 after the f32 unpooling masks
        f = base.encode1.batchnorm.num_features
        for i in range(4):  # encode1-3, bottleneck
            bn[((batch, f, H >> i, W >> i), False, bf)] += 1
        for i in range(3):  # decode3-1
            bn[((batch, f, H >> i, W >> i), False, wide)] += 1
        logits = f32
    else:
        dims = base.base_cnn.layer_dims
        bn[((batch, dims[0], H, W), False, bf)] += 1  # cnn.1
        for i, d in enumerate(dims):  # LeakyReLU -> BN, fused, 3 a block
            key = ((batch, d, H >> i, W >> i), True, bf)
            bn[key] += 3
            if i and not base.flag_cnn:
                unread[key] += 3
        lvl = [(H, W)]  # after each stride-2 conv
        for _ in range(4):
            lvl.append(tuple((v - 1) // 2 + 1 for v in lvl[-1]))
        fused = bf
        if base.flag_vit:
            for c, got in zip((mp, s1, s2), path_shapes(cfg, batch, hw)):
                c.update({(k, bf): n for k, n in got.items()})
            ed = cfg.embed_dims
            bn[((batch, ed[0] // 2) + lvl[1], False, bf)] += 1  # stem
            bn[((batch, ed[0]) + lvl[1], False, bf)] += 1
            for i in range(cfg.num_stages):
                res = lvl[i + 1]
                bn[((batch, ed[i]) + res, False, bf)] += cfg.num_path[i] + 3  # patch embeds, InvRes
                out = ed[i + 1] if i + 1 < cfg.num_stages else ed[i]
                bn[((batch, out) + res, False, bf)] += 1  # aggregate
            for i in range(4):  # tran_vit, tran_cnn projections
                width = getattr(base, f"tran_vit{i}")[1].num_features
                bn[((batch, width) + lvl[i + 1], False, bf)] += 2 if base.flag_cnn else 1
            if base.flag_gate and base.flag_cnn:
                fused = wide  # the f32 alpha maps widen the fused maps
        bn[((batch, base.head[1].num_features) + lvl[4], False, fused)] += 1
        for dec, l in zip((base.dec1, base.dec2, base.dec3, base.dec4), (4, 3, 2, 1)):
            bn[((batch, dec.prep[1].num_features) + lvl[l], False, fused)] += 1
        logits = f32 if fused == wide else bf
    # RegNet loss heads at full resolution: lap_reg (C = n_class - 1) on the
    # logits and on the f32 one-hot; lap_map's two 1-channel convs on both f32
    # column-softmax maps, and its eps-1.0 BN on both
    nc = model.lap_reg[0].in_channels
    s1[((batch, H, W, nc), logits)] += 2
    s1[((batch, H, W, nc), f32)] += 2
    s1[((batch, H, W, 1), f32)] += 4
    bn[((batch, 1, H, W), False, wide)] += 2
    return {"mp": mp, "s1": s1, "s2": s2, "bn": bn, "bnb": bn - unread}


def _table(name, src, replaces, rows, main=None):
    """A kernel's rows; ``main`` names the path whose run gives its
    launches and its totals ("serve" or "train"; by default the serving
    batch where it has serving shapes)."""
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces, "rows": rows,
            "main": main}


def kernel_tables(serve, train, serve_small, gtc, task2):
    """The kernels, each with its wrapper, plain version, one-call library
    yardstick, input maker, check, bytes and operations, and the shapes of
    the serving batch (``serve``, ``path_shapes``), of an ``stc_tt`` train
    step (``train``) and of a ``gtc_tt`` one (``gtc``, ``train_shapes``);
    for the depthwise forward also the shapes of an ``stc_st``
    (MPViT-small) serving batch; for the train BatchNorm also those of the
    f32 task-2 res18 and res50 steps (``task2``: two Counters of
    ``task2_bn_shapes``).  A row's makers take a shape and the types
    of its table key ("bfloat16", "float32", "float32/bfloat16": x f32,
    weight and bias bf16)."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.ops.kernels.bnstats import (
        bn_act_backward_dx,
        bn_act_backward_sums,
        bn_act_normalize,
        bn_act_sums,
        bn_act_train,
        bn_act_train_backward,
        bn_act_train_backward_reference,
        bn_act_train_backward_tolerance,
        bn_act_train_flops,
        bn_backward_sums_reference,
        bn_normalize_reference,
        bn_stats_reference,
        bn_sums_reference,
        stats_from_sums,
    )
    from tcct_tpu_torch.ops.kernels.bnstats import _dx_from_sums as bn_dx_reference
    from tcct_tpu_torch.ops.kernels.dwconv import (
        dwconv3x3,
        dwconv3x3_backward,
        dwconv3x3_backward_reference,
        dwconv3x3_flops,
        dwconv3x3_reference,
    )
    from tcct_tpu_torch.ops.kernels.metapool import (
        metapool_flops,
        metapool_tokens,
        metapool_tokens_backward,
    )
    from tcct_tpu_torch.ops.pool import (
        metapool_tokens_backward_reference,
        metapool_tokens_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def dtypes(types):  # (input dtype, weight dtype)
        x, _, w = types.partition("/")
        return getattr(torch, x), getattr(torch, w or x)

    def out_hw(shape, s):
        return (shape[1] - 1) // s + 1, (shape[2] - 1) // s + 1

    # --- K1 / K1b ------------------------------------------------------------
    def mp_args(shape, types):
        return (randn(shape, dtypes(types)[0]),)

    def mp_lib(x):
        return F.avg_pool2d(x[:, None], 3, 1, 1, count_include_pad=False)[:, 0] - x

    def mp_lib_bwd(g):  # autograd's backward of avg_pool2d(cip=False) - x, one aten call + sub
        return torch.ops.aten.avg_pool2d_backward(g[:, None], g[:, None], [3, 3], [1, 1], [1, 1],
                                                  False, False, None)[:, 0] - g

    def close_check(kern, plain):
        def check(name, args, dn):
            got = kern(*args)
            torch.cuda.synchronize()
            return check_close(name, got, plain(*args), dn)
        return check

    # each cost: (bytes, operations); the operations are the kernel module's
    # formula, which utils/profiling.py's cost_analysis counts too
    def mp_cost(args):
        x = args[0]
        return 2 * x.numel() * x.element_size(), metapool_flops(x.shape)

    # --- K2 / K2b ------------------------------------------------------------
    def dw_args(stride, bwd):
        def make(shape, types):
            dtype = dtypes(types)[0]
            x = randn(shape, dtype)
            w = randn((3, 3, shape[-1]), dtype, 1 / 3)
            if not bwd:
                return (x, w)
            return (x, w, randn((shape[0],) + out_hw(shape, stride) + (shape[3],), dtype))
        return make

    def dw_lib(stride):
        def f(x, w):  # the NCHW view of NHWC x is channels_last
            wc = w.permute(2, 0, 1).unsqueeze(1)
            return F.conv2d(x.permute(0, 3, 1, 2), wc, stride=stride, padding=1, groups=x.shape[-1])
        return f

    def dw_lib_bwd(stride):
        def f(x, w, g):  # cuDNN's grouped-conv backward, both gradients in one call
            wc = w.permute(2, 0, 1).unsqueeze(1)
            return torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), wc, None, [stride, stride], [1, 1],
                [1, 1], False, [0, 0], x.shape[-1], [True, True, False])
        return f

    def dw_bwd_check(stride):
        def check(name, args, dn):
            x, w, g = args
            dx, dw, db = dwconv3x3_backward(x, w, g, stride, bias=True)
            torch.cuda.synchronize()
            rdx, _, _ = dwconv3x3_backward_reference(x, w, g, stride)
            err = check_close(name + " dx", dx, rdx, dn)
            # dw sums B*Ho*Wo products: 1e-5 of sum|x*g| per tap (summation
            # order), plus one bf16 rounding, against the plain version in f32;
            # db likewise of sum|g|
            one = 2.0 ** -7 if dn == "bfloat16" else 0.0
            ref32 = dwconv3x3_backward_reference(x.float(), w.float(), g.float(), stride)[1]
            mag = dwconv3x3_backward_reference(x.float().abs(), w.float(), g.float().abs(),
                                               stride)[1]
            check_within(name + " dw", dw, ref32, 1e-5 * mag + 1e-6 + one * ref32.abs())
            gsum = g.float().sum((0, 1, 2))
            check_within(name + " db", db, gsum,
                         1e-5 * g.float().abs().sum((0, 1, 2)) + 1e-6 + one * gsum.abs())
            _, dw2, db2 = dwconv3x3_backward(x, w, g, stride, bias=True)
            if not (torch.equal(dw, dw2) and torch.equal(db, db2)):
                fail(f"{name}: dw or db differs between two runs")
            return err
        return check

    def dw_cost(stride):
        def cost(args):
            x = args[0]
            Ho, Wo = out_hw(x.shape, stride)
            n_out = x.shape[0] * Ho * Wo * x.shape[3]
            if len(args) == 2:
                return ((x.numel() + n_out + 9 * x.shape[3]) * x.element_size(),
                        dwconv3x3_flops(x.shape, stride))
            # x, g read; dx written; taps read, dw written
            return ((2 * x.numel() + n_out + 18 * x.shape[3]) * x.element_size(),
                    dwconv3x3_flops(x.shape, stride, backward=True))
        return cost

    # --- K3 --------------------------------------------------------------------
    # args: x, weight, bias; then, for the library call only, weight and bias
    # in x's type (F.batch_norm takes no narrower weights)
    def bn_args(leaky):
        def make(shape, types):
            C = shape[1]
            xd, wd = dtypes(types)
            x = randn(shape, xd, 2.0, 0.5).contiguous(memory_format=torch.channels_last)
            w = (torch.rand(C, generator=gen, device=dev) + 0.5).to(wd)
            b = randn((C,), wd, 0.1)
            return (x, w, b, w.to(xd), b.to(xd))
        return make

    def bn_kern(leaky):
        return lambda x, w, b, *_: bn_act_train(x, w, b, 1e-5, leaky)

    def bn_plain(leaky):
        def f(x, w, b, *_):
            mean, var = bn_stats_reference(x, leaky)
            return bn_normalize_reference(x, mean, var, w, b, 1e-5, leaky)
        return f

    def bn_lib(leaky):
        def f(x, _w, _b, w, b):
            t = F.leaky_relu(x, 0.01) if leaky else x
            return F.batch_norm(t, None, None, w, b, training=True, momentum=0.1, eps=1e-5)
        return f

    def bn_check(leaky):
        def check(name, args, dn):
            x, w, b = args[:3]
            y, mean, var = bn_act_train(x, w, b, 1e-5, leaky)
            torch.cuda.synchronize()
            rm, rv = bn_stats_reference(x, leaky)
            tf = (F.leaky_relu(x, 0.01) if leaky else x).float()
            # f32 sums in another order: 1e-5 of E|t| and of E[t^2]
            check_within(name + " mean", mean, rm, 1e-5 * tf.abs().mean((0, 2, 3)) + 1e-7)
            check_within(name + " var", var, rv, 1e-5 * (tf * tf).mean((0, 2, 3)) + 1e-7)
            return check_close(name, y, bn_normalize_reference(x, mean, var, w, b, 1e-5, leaky), dn)
        return check

    def bn_cost(args):
        x = args[0]
        # x read, y written; weight, bias, mean, var as f32 vectors
        return 2 * x.numel() * x.element_size() + 16 * x.shape[1], bn_act_train_flops(x.shape)

    # --- K3b ---------------------------------------------------------------------
    # args: x, weight, the forward's mean and var, gy; then, for the library
    # call only, t = act(x) and 1/sqrt(var + eps), as autograd saves them,
    # and the weight in x's type
    def bnb_args(leaky):
        def make(shape, types):
            x, w, _, w_lib, _ = bn_args(leaky)(shape, types)
            mean, var = bn_stats_reference(x, leaky)
            gy = randn(shape, x.dtype).contiguous(memory_format=torch.channels_last)
            t = F.leaky_relu(x, 0.01) if leaky else x
            return (x, w, mean, var, gy, t, torch.rsqrt(var + 1e-5), w_lib)
        return make

    def bnb_kern(leaky):
        return lambda x, w, m, v, g, *_: bn_act_train_backward(x, w, m, v, g, 1e-5, leaky)

    def bnb_plain(leaky):
        return lambda x, w, m, v, g, *_: bn_act_train_backward_reference(x, w, m, v, g, 1e-5,
                                                                          leaky)

    def bnb_lib(leaky):
        def f(x, _w, m, v, g, t, invstd, w):  # autograd's backward of leaky_relu + F.batch_norm
            gt, gw, gb = torch.ops.aten.native_batch_norm_backward(
                g, t, w, None, None, m, invstd, True, 1e-5, [True, True, True])
            if leaky:
                gt = torch.ops.aten.leaky_relu_backward(gt, x, 0.01, False)
            return gt, gw, gb
        return f

    def bnb_check(leaky):
        def check(name, args, dn):
            x, w, mean, var, gy = args[:5]
            got = bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)
            torch.cuda.synchronize()
            err = check_bn_backward(name, x, w, mean, var, gy, leaky, got)
            again = bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                fail(f"{name}: differs between two runs")
            return err
        return check

    def bnb_cost(args):
        x = args[0]
        # x, gy read, dx written; weight, mean, var read, dweight, dbias written
        return (3 * x.numel() * x.element_size() + 20 * x.shape[1],
                bn_act_train_flops(x.shape, backward=True))

    # --- the two-phase entry points of K3/K3b (a data-parallel step) -------------
    # sums: args as K3's; the library call is torch.batch_norm_stats (SyncBatchNorm's)
    def sums_check(leaky):
        def check(name, args, dn):
            x = args[0]
            got = bn_act_sums(x, leaky)
            torch.cuda.synchronize()
            t = (F.leaky_relu(x, 0.01) if leaky else x).float()
            # f32 sums in another order: 1e-5 of sum|t| and of sum t^2
            lim = 1e-5 * torch.stack([t.abs().sum((0, 2, 3)), (t * t).sum((0, 2, 3))]) + 1e-6
            return check_within(name, got, bn_sums_reference(x, leaky), lim)
        return check

    def sums_lib(leaky):
        def f(x, *_):
            return torch.batch_norm_stats(F.leaky_relu(x, 0.01) if leaky else x, 1e-5)
        return f

    def sums_cost(args):
        x = args[0]  # x read, [2, C] f32 written
        return x.numel() * x.element_size() + 8 * x.shape[1], 3 * x.numel()

    # normalize: args x, sums, count, weight, bias, mean, invstd (f32), weight
    # and bias in x's type (the library call, torch.batch_norm_elemt)
    def norm_args(leaky):
        def make(shape, types):
            x, w, b, w_lib, b_lib = bn_args(leaky)(shape, types)
            sums = bn_sums_reference(x, leaky)
            n = x.numel() // shape[1]
            mean, var = stats_from_sums(sums, n)
            return (x, sums, n, w, b, mean, torch.rsqrt(var + 1e-5), w_lib, b_lib)
        return make

    def norm_kern(leaky):
        return lambda x, s, n, w, b, *_: bn_act_normalize(x, s, n, w, b, 1e-5, leaky)

    def norm_plain(leaky):
        def f(x, s, n, w, b, *_):
            mean, var = stats_from_sums(s, n)
            return bn_normalize_reference(x, mean, var, w, b, 1e-5, leaky)
        return f

    def norm_lib(leaky):
        def f(x, s, n, w, b, mean, invstd, w_lib, b_lib):
            t = F.leaky_relu(x, 0.01) if leaky else x
            return torch.batch_norm_elemt(t, w_lib, b_lib, mean, invstd, 1e-5)
        return f

    def norm_check(leaky):
        def check(name, args, dn):
            got = norm_kern(leaky)(*args)
            torch.cuda.synchronize()
            return check_close(name, got[0], norm_plain(leaky)(*args), dn)
        return check

    def norm_cost(args):
        x = args[0]  # x read, y written; sums, weight, bias read, [2, C] statistics written
        return 2 * x.numel() * x.element_size() + 24 * x.shape[1], 5 * x.numel()

    # backward sums: args as K3b's; the library call torch.batch_norm_backward_reduce
    def bsums_check(leaky):
        def check(name, args, dn):
            x, gy = args[0], args[4]
            got = bn_act_backward_sums(x, gy, leaky)
            torch.cuda.synchronize()
            t = (F.leaky_relu(x, 0.01) if leaky else x).float()
            g = gy.float()
            lim = 1e-5 * torch.stack([g.abs().sum((0, 2, 3)), (g * t).abs().sum((0, 2, 3))]) + 1e-6
            return check_within(name, got, bn_backward_sums_reference(x, gy, leaky), lim)
        return check

    def bsums_lib(leaky):
        def f(x, _w, m, v, g, t, invstd, w):
            return torch.batch_norm_backward_reduce(g, t, m, invstd, w, False, True, True)
        return f

    def bsums_cost(args):
        x = args[0]  # x, gy read; [2, C] f32 written
        return 2 * x.numel() * x.element_size() + 8 * x.shape[1], 3 * x.numel()

    # dx: args x, weight, mean, var, gy, sums, count; then for the library call
    # (torch.batch_norm_backward_elemt) t, invstd, the weight in x's type, the
    # two sums and the count as a tensor
    def dx_args(leaky):
        def make(shape, types):
            x, w, mean, var, gy, t, invstd, w_lib = bnb_args(leaky)(shape, types)
            sums = bn_backward_sums_reference(x, gy, leaky)
            n = x.numel() // shape[1]
            # SyncBatchNorm's sums: sum(gy) and sum(gy * (t - mean))
            return (x, w, mean, var, gy, sums, n, t, invstd, w_lib, sums[0].contiguous(),
                    sums[1] - mean * sums[0], torch.tensor([n], dtype=torch.int32, device=dev))
        return make

    def dx_kern(leaky):
        return lambda x, w, m, v, g, s, n, *_: bn_act_backward_dx(x, w, m, v, g, s, n, 1e-5,
                                                                   leaky)

    def dx_plain(leaky):
        return lambda x, w, m, v, g, s, n, *_: bn_dx_reference(x, w, m, v, g, s, n, 1e-5, leaky)

    def dx_lib(leaky):
        def f(x, _w, m, v, g, s, n, t, invstd, w, sum_dy, sum_dy_xmu, count):
            gt = torch.batch_norm_backward_elemt(g, t, m, invstd, w, sum_dy, sum_dy_xmu, count)
            return torch.ops.aten.leaky_relu_backward(gt, x, 0.01, False) if leaky else gt
        return f

    def dx_check(leaky):
        def check(name, args, dn):
            x, w, mean, var, gy = args[:5]
            got = dx_kern(leaky)(*args)
            torch.cuda.synchronize()
            # the plain version on the same sums; the bound of K3b's dx (which
            # also covers the sums' order) holds a fortiori
            lim = bn_act_train_backward_tolerance(x, w, mean, var, gy, 1e-5, leaky)[0]
            return check_within(name, got.double(), dx_plain(leaky)(*args).double(), lim)
        return check

    def dx_cost(args):
        x = args[0]  # x, gy read, dx written; per-channel vectors
        return 3 * x.numel() * x.element_size() + 28 * x.shape[1], 6 * x.numel()

    def serve_rows(c):  # the serving path runs bf16
        return Counter({(k, "bfloat16"): n for k, n in c.items()})

    def spec(kern, plain, lib, make, check, cost, tag=""):
        return dict(kern=kern, plain=plain, lib=lib, make=make, check=check, cost=cost, tag=tag)

    mp_fwd = spec(metapool_tokens, metapool_tokens_reference, mp_lib, mp_args,
                  close_check(metapool_tokens, metapool_tokens_reference), mp_cost)
    mp_bwd = spec(metapool_tokens_backward, metapool_tokens_backward_reference, mp_lib_bwd,
                  mp_args, close_check(metapool_tokens_backward,
                                       metapool_tokens_backward_reference), mp_cost)

    def dw_fwd(s):
        kern = lambda x, w: dwconv3x3(x, w, s)  # noqa: E731
        plain = lambda x, w: dwconv3x3_reference(x, w, s)  # noqa: E731
        return spec(kern, plain, dw_lib(s), dw_args(s, False), close_check(kern, plain),
                    dw_cost(s))

    def dw_bwd(s):
        return spec(lambda x, w, g: dwconv3x3_backward(x, w, g, s),
                    lambda x, w, g: dwconv3x3_backward_reference(x, w, g, s),
                    dw_lib_bwd(s), dw_args(s, True), dw_bwd_check(s), dw_cost(s))

    def bn_spec(leaky):
        return spec(bn_kern(leaky), bn_plain(leaky), bn_lib(leaky), bn_args(leaky),
                    bn_check(leaky), bn_cost, " leaky" if leaky else "")

    mp_src, dw_src = "tcct_tpu_torch/csrc/metapool.cu", "tcct_tpu_torch/csrc/dwconv3x3.cu"
    def bnb_spec(leaky):
        return spec(bnb_kern(leaky), bnb_plain(leaky), bnb_lib(leaky), bnb_args(leaky),
                    bnb_check(leaky), bnb_cost, " leaky" if leaky else "")

    def by_leaky(c, leaky):  # a BN Counter's (shape, types) keys with one leaky flag
        return Counter({(shape, t): n for (shape, lk, t), n in c.items() if lk == leaky})

    # each row: (spec, serving batch, stc_tt step, stc_st serving batch, gtc_tt step,
    # task-2 res18 step, task-2 res50 step); task 2 runs its BatchNorms in f32, leaky off
    no = Counter()
    t2 = [Counter({(shape, "float32"): n for shape, n in c.items()}) for c in task2]
    bn_rows = [(bn_spec(lk), no, by_leaky(train["bn"], lk), no, by_leaky(gtc["bn"], lk),
                *(t2 if not lk else (no, no))) for lk in (False, True)]
    bnb_rows = [(bnb_spec(lk), no, by_leaky(train["bnb"], lk), no, by_leaky(gtc["bnb"], lk),
                 *(t2 if not lk else (no, no))) for lk in (False, True)]
    def split_rows(make_spec, part):  # the stc_tt step's BN shapes, the main path a DP step
        return [(make_spec(lk), no, by_leaky(train[part], lk), no, no, no, no)
                for lk in (False, True)]

    def split_spec(kern, plain, lib, make, check, cost):
        return lambda lk: spec(kern(lk), plain(lk), lib(lk), make(lk), check(lk), cost,
                               " leaky" if lk else "")

    bn_src = "tcct_tpu_torch/csrc/bnstats.cu"
    split_tables = [
        _table("bn_act_sums", bn_src, "tcct_tpu/ops/pallas/bnstats.py:129", split_rows(
            split_spec(lambda lk: lambda x, *_: bn_act_sums(x, lk),
                       lambda lk: lambda x, *_: bn_sums_reference(x, lk), sums_lib, bn_args,
                       sums_check, sums_cost), "bn"), main="train"),
        _table("bn_act_normalize", bn_src, "tcct_tpu/ops/pallas/bnstats.py:149", split_rows(
            split_spec(norm_kern, norm_plain, norm_lib, norm_args, norm_check, norm_cost),
            "bn"), main="train"),
        _table("bn_act_backward_sums", bn_src, "tcct_tpu/ops/pallas/bnstats.py:181", split_rows(
            split_spec(lambda lk: lambda x, w, m, v, g, *_: bn_act_backward_sums(x, g, lk),
                       lambda lk: lambda x, w, m, v, g, *_: bn_backward_sums_reference(x, g, lk),
                       bsums_lib, bnb_args, bsums_check, bsums_cost), "bnb"), main="train"),
        _table("bn_act_backward_dx", bn_src, "tcct_tpu/ops/pallas/bnstats.py:181", split_rows(
            split_spec(dx_kern, dx_plain, dx_lib, dx_args, dx_check, dx_cost), "bnb"),
            main="train"),
    ]
    return [
        # the serving path runs K1 inside the site (metapool_block): its
        # launches are the train step's, its serving shapes are timed beside
        _table("metapool_tokens", mp_src, "tcct_tpu/ops/pallas/metapool.py:64",
               [(mp_fwd, serve_rows(serve[0]), train["mp"], no, gtc["mp"], no, no)], main="train"),
        _table("dwconv3x3_s1", dw_src, "tcct_tpu/ops/pallas/dwconv.py:200",
               [(dw_fwd(1), serve_rows(serve[1]), train["s1"], serve_rows(serve_small[1]),
                 gtc["s1"], no, no)]),
        _table("dwconv3x3_s2", dw_src, "tcct_tpu/ops/pallas/dwconv.py:380",
               [(dw_fwd(2), serve_rows(serve[2]), train["s2"], serve_rows(serve_small[2]),
                 gtc["s2"], no, no)]),
        _table("metapool_tokens_backward", mp_src, "tcct_tpu/ops/pallas/metapool.py:64",
               [(mp_bwd, no, train["mp"], no, gtc["mp"], no, no)]),
        _table("dwconv3x3_backward_s1", dw_src, "tcct_tpu/ops/pallas/dwconv.py:220",
               [(dw_bwd(1), no, train["s1"], no, gtc["s1"], no, no)]),
        _table("dwconv3x3_backward_s2", dw_src, "tcct_tpu/ops/pallas/dwconv.py:420",
               [(dw_bwd(2), no, train["s2"], no, gtc["s2"], no, no)]),
        _table("bn_act_train", "tcct_tpu_torch/csrc/bnstats.cu",
               "tcct_tpu/ops/pallas/bnstats.py:129", bn_rows),
        _table("bn_act_train_backward", "tcct_tpu_torch/csrc/bnstats.cu",
               "tcct_tpu/ops/pallas/bnstats.py:181", bnb_rows),
    ] + split_tables


def row_types(shape, counters):
    """The types to run a row's ``shape`` in: bf16 and f32, then any other
    its paths call it with ("float32/bfloat16"); a shape only the f32 task-2
    steps call (the last two Counters), in the types they call it with."""
    on = {k[1] for c in counters for k in c if k[0] == shape}
    if not any(k[0] == shape for c in counters[:-2] for k in c):
        return sorted(on)
    return ["bfloat16", "float32"] + sorted(on - {"bfloat16", "float32"})


# each kernel row's paths: (totals prefix, Counter index in the row, launches label)
PATHS = (("serve_", 1, "/batch"), ("train_", 2, "/stc_tt step"), ("small_", 3, "/stc_st batch"),
         ("gtc_", 4, "/gtc_tt step"), ("task2_", 5, "/task-2 res18 step"),
         ("task2_res50_", 6, "/task-2 res50 step"))


def bench_kernels(report, tables):
    """Each kernel against its plain version, in bf16 and in f32 (TF32 off)
    and in any mixed types a path calls it with, at every shape of the
    serving batch and of the stc_tt and gtc_tt train steps, timed against
    the plain version and the library yardstick.  The totals of a row weight
    each shape by its launches on its path, at the path's types: ``ms`` etc.
    over the table's main path (per serving batch or per stc_tt train step),
    ``serve_ms`` / ``train_ms`` etc. over the other where the kernel has
    shapes there, ``gtc_ms`` etc. per gtc_tt train step, ``small_ms`` the
    depthwise forward's totals over an ``stc_st`` serving batch."""
    entries = []
    for t in tables:
        name = t["name"]
        tot = Counter()
        max_err = 0.0
        for row in t["rows"]:
            sp = row[0]
            shapes = sorted({k[0] for c in row[1:] for k in c})
            for shape in shapes:
                for dn in row_types(shape, row[1:]):
                    n = {p: row[i].get((shape, dn), 0) for p, i, _ in PATHS}
                    args = sp["make"](shape, dn)
                    label = f"{name}{sp['tag']} {list(shape)} {dn}"
                    err = sp["check"](label, args, dn)
                    max_err = max(max_err, err)
                    nbytes, flops = sp["cost"](args)
                    copies = [tuple(a.clone() if hasattr(a, "clone") else a for a in args)
                              for _ in range(n_copies(nbytes))]
                    t_k = device_ms(sp["kern"], copies)
                    t_p = device_ms(sp["plain"], copies)
                    t_l = device_ms(sp["lib"], copies)
                    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    b_ops = flops / F32_FLOP_PER_S * 1e3
                    bound = max(b_bytes, b_ops)
                    per = "".join(f" x{n[p]}{what}" for p, _, what in PATHS if n[p])
                    print(f"  {label}{per}: max_abs_err {err:.3e} kernel {t_k * 1e3:.1f} us, "
                          f"plain {t_p * 1e3:.1f} us, library {t_l * 1e3:.1f} us, "
                          f"bound {bound * 1e3:.1f} us "
                          f"({'bytes' if b_bytes >= b_ops else 'operations'}), "
                          f"{b_bytes / t_k * 100:.0f}% of the byte bound", flush=True)
                    for prefix, _, _ in PATHS:
                        tot[prefix + "ms"] += n[prefix] * t_k
                        tot[prefix + "plain_ms"] += n[prefix] * t_p
                        tot[prefix + "library_ms"] += n[prefix] * t_l
                        tot[prefix + "bound_ms"] += n[prefix] * bound
                        tot[prefix + "bytes_ms"] += n[prefix] * b_bytes
                        tot[prefix + "ops_ms"] += n[prefix] * b_ops
                    del copies, args
        main = (t["main"] or ("serve" if tot["serve_ms"] > 0 else "train")) + "_"
        entry = {
            "name": name, "route": t["route"], "source": t["source"], "replaces": t["replaces"],
            "launches": 0, "max_abs_err": max_err,
            "ms": tot[main + "ms"], "plain_ms": tot[main + "plain_ms"],
            "bound_ms": tot[main + "bound_ms"],
            "bound_by": "bytes" if tot[main + "bytes_ms"] >= tot[main + "ops_ms"] else "operations",
            "library_ms": tot[main + "library_ms"],
        }
        for prefix, _, _ in PATHS:
            if prefix != main and tot[prefix + "ms"] > 0:
                entry.update({prefix + k: tot[prefix + k]
                              for k in ("ms", "plain_ms", "bound_ms", "library_ms")})
        entries.append(entry)
    report["kernels"] = entries


def check_bn_capture() -> None:
    """One K3 call and one K3b call at a bf16 train shape captured in a CUDA
    graph, then replayed on new inputs copied into the captured ones: the
    outputs equal the eager calls' bit for bit (the train step's capture
    needs both launches capturable)."""
    import torch

    from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train, bn_act_train_backward

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shape, cl = (8, 32, 128, 128), torch.channels_last

    def inputs(scale):
        x = (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)
        w = (torch.rand(shape[1], generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
        b = torch.randn(shape[1], generator=gen, device="cuda").to(torch.bfloat16)
        gy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        return [x.contiguous(memory_format=cl), w, b, gy.contiguous(memory_format=cl)]

    def both(x, w, b, gy):
        y, mean, var = bn_act_train(x, w, b, 1e-5, True)
        return (y, mean, var) + bn_act_train_backward(x, w, mean, var, gy, 1e-5, True)

    static = inputs(2.0)
    both(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = both(*static)
    new = inputs(0.5)
    for dst, src in zip(static, new):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(outs, both(*new))):
        fail("K3 and K3b replayed from a CUDA graph differ from the eager calls")
    print(f"train BN: one K3 and one K3b call {list(shape)} bf16 captured in a CUDA graph and "
          f"replayed: bitwise equal to eager", flush=True)


def bench_convposenc_backward(report, card, sites):
    """The ConvPosEnc site's backward at the train step's shapes: one K2b
    launch that adds g to dx and sums the bias gradient, against the kernel
    followed by the two plain passes it replaces (``dx + g``,
    ``g.sum``): dx bit for bit, db within 1e-5 of sum|g| plus a rounding,
    in bf16 and f32, timed against them and a bound of x and g read and
    dx written once.  Then one such call captured in a CUDA graph and
    replayed on new inputs: bitwise the eager call (the launch allocates
    nothing)."""
    import torch

    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3_backward

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    print(f"ConvPosEnc backward site: one launch vs the kernel and two passes [{card}]:",
          flush=True)

    def one(x, w, g):
        return dwconv3x3_backward(x, w, g, 1, bias=True, residual=True)

    def three(x, w, g):
        dx, dw, _ = dwconv3x3_backward(x, w, g, 1)
        return dx + g, dw, g.sum((0, 1, 2))

    def inputs(shape, dtype, scale=1.0):
        x = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
        w = (torch.randn((3, 3, shape[-1]), generator=gen, device="cuda") / 3).to(dtype)
        g = (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)
        return x, w, g

    tot = Counter()
    for shape in sorted(sites):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            x, w, g = inputs(shape, dtype)
            got, want = one(x, w, g), three(x, w, g)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                fail(f"ConvPosEnc backward {list(shape)} {dn}: dx or dw differs from the passes")
            gsum = g.float().sum((0, 1, 2))
            lim = 1e-5 * g.float().abs().sum((0, 1, 2)) + 1e-6 + (
                2.0 ** -7 * gsum.abs() if dtype == torch.bfloat16 else 0)
            check_within(f"ConvPosEnc backward {list(shape)} {dn} db", got[2], gsum, lim)
            nbytes = 3 * x.numel() * x.element_size()
            copies = [(x.clone(), w, g.clone()) for _ in range(n_copies(nbytes))]
            t_1, t_3 = device_ms(one, copies), device_ms(three, copies)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            n = sites[shape]
            print(f"  {list(shape)} {dn} x{n}/step: dx bitwise equal; one launch {t_1 * 1e3:.1f} "
                  f"us, kernel + two passes {t_3 * 1e3:.1f} us, bound {bound * 1e3:.1f} us",
                  flush=True)
            if dtype == torch.bfloat16:
                tot["ms"] += n * t_1
                tot["three_ms"] += n * t_3
            del copies
    for e in report["kernels"]:
        if e["name"] == "dwconv3x3_backward_s1":
            e.update(convposenc_ms=tot["ms"], convposenc_three_pass_ms=tot["three_ms"])
    print(f"  per bf16 train step: {sum(sites.values())} sites {tot['ms']:.4f} ms in one launch "
          f"each, {tot['three_ms']:.4f} ms as the kernel and two passes", flush=True)

    shape = max(sites)
    static = list(inputs(shape, torch.bfloat16))
    one(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = one(*static)
    new = inputs(shape, torch.bfloat16, 0.5)
    for dst, src in zip(static, new):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip(outs, one(*new))):
        fail("K2b replayed from a CUDA graph differs from the eager call")
    print(f"K2b: one call {list(shape)} bf16 (bias, residual) captured in a CUDA graph and "
          f"replayed: bitwise equal to eager", flush=True)


def bench_dwconv_variants(card):
    """The depthwise forward's two kernels at the stride-1 bf16 shapes of the
    serving paths: the launch's own choice, the direct kernel, and the ring
    kernel at named strip heights, beside the library call.  Printed, not
    held: the numbers behind the launch's choice."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3_forward

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    print(f"depthwise forward, stride 1, bf16: device us by kernel and strip height [{card}]:",
          flush=True)
    for shape in ((8, 128, 288, 64), (8, 64, 144, 128), (8, 64, 144, 96), (8, 32, 72, 216),
                  (8, 32, 72, 128)):
        x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((3, 3, shape[-1]), generator=gen, device="cuda") / 3).to(torch.bfloat16)
        copies = [(x.clone(), w.clone()) for _ in range(n_copies(4 * x.numel()))]
        wc = w.permute(2, 0, 1).unsqueeze(1)
        t_lib = device_ms(lambda a, b: F.conv2d(a.permute(0, 3, 1, 2), wc, padding=1,
                                                groups=shape[-1]), copies)
        cells = []
        for rows in (0, -1, 4, 8, 12, 16, 24, 32):
            t = device_ms(lambda a, b: dwconv3x3_forward(a, b, 1, rows=rows), copies)
            what = {0: "launch's choice", -1: "direct"}.get(rows, f"ring {rows}")
            cells.append(f"{what} {t * 1e3:.1f}")
        print(f"  {list(shape)}: " + ", ".join(cells) + f"; library {t_lib * 1e3:.1f}", flush=True)
        del copies


def bench_convposenc(report, card, sites, sites_small):
    """The ConvPosEnc site, ``conv(x) + bias + x``: the forward kernel's
    epilogue in one launch against the three passes it replaces (the kernel,
    a bias add, a residual add), bit for bit, in bf16 and f32, and against
    the plain version at the kernels' tolerance; timed against the three
    passes and against a bound of x read once and y written once.  Then the
    module itself: one ``ConvPosEnc.forward`` launches the kernel once and at
    most one elementwise kernel (the taps' layout copy)."""
    import torch

    from tcct_tpu_torch.models.mpvit import ConvPosEnc, image_to_tokens, tokens_to_image
    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3, dwconv3x3_reference

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    print(f"ConvPosEnc site: conv + bias + x in one launch vs the three passes [{card}]:",
          flush=True)

    def site(x, w, b):
        return dwconv3x3(x, w, 1, b, True)

    def three(x, w, b):
        return dwconv3x3(x, w, 1) + b + x

    tot = Counter()
    for shape in sorted(set(sites) | set(sites_small)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            C = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (torch.randn((3, 3, C), generator=gen, device="cuda") / 3).to(dtype)
            b = torch.randn((C,), generator=gen, device="cuda").to(dtype)
            label = f"ConvPosEnc site {list(shape)} {dn}"
            got = site(x, w, b)
            torch.cuda.synchronize()
            if not torch.equal(got, three(x, w, b)):
                fail(f"{label}: the epilogue differs from the three passes")
            err = check_close(label, got, dwconv3x3_reference(x, w, 1) + b + x, dn)
            nbytes = (2 * x.numel() + 10 * C) * x.element_size()
            copies = [(x.clone(), w, b) for _ in range(n_copies(nbytes))]
            t_k, t_3 = device_ms(site, copies), device_ms(three, copies)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            n, n_small = sites.get(shape, 0), sites_small.get(shape, 0)
            per = (f" x{n}/batch" if n else "") + (f" x{n_small}/stc_st batch" if n_small else "")
            print(f"  {label}{per}: bitwise equal, max_abs_err vs plain {err:.3e}, one launch "
                  f"{t_k * 1e3:.1f} us, three passes {t_3 * 1e3:.1f} us, bound "
                  f"{bound * 1e3:.1f} us ({bound / t_k * 100:.0f}% of it)", flush=True)
            if dtype == torch.bfloat16:
                for prefix, k in (("", n), ("small_", n_small)):
                    tot[prefix + "ms"] += k * t_k
                    tot[prefix + "three_ms"] += k * t_3
                    tot[prefix + "bound_ms"] += k * bound
            del copies
    for e in report["kernels"]:
        if e["name"] == "dwconv3x3_s1":
            e.update(convposenc_ms=tot["ms"], convposenc_three_pass_ms=tot["three_ms"],
                     convposenc_bound_ms=tot["bound_ms"],
                     small_convposenc_ms=tot["small_ms"],
                     small_convposenc_three_pass_ms=tot["small_three_ms"],
                     small_convposenc_bound_ms=tot["small_bound_ms"])
    print(f"  per bf16 batch: stc_tt {sum(sites.values())} sites {tot['ms']:.4f} ms in one launch "
          f"each, {tot['three_ms']:.4f} ms as three passes, bound {tot['bound_ms']:.4f} ms; stc_st "
          f"{sum(sites_small.values())} sites {tot['small_ms']:.4f} / {tot['small_three_ms']:.4f} "
          f"/ {tot['small_bound_ms']:.4f} ms", flush=True)

    # the module: one kernel launch, no bias pass, no residual pass
    B, H, W, C = max(sites)
    cpe = ConvPosEnc(C).to("cuda", torch.bfloat16)
    with torch.no_grad():
        cpe.proj.weight.copy_(torch.randn(cpe.proj.weight.shape, generator=gen, device="cuda") / 3)
        cpe.proj.bias.copy_(torch.randn((C,), generator=gen, device="cuda"))
    tokens = torch.randn((B, H * W, C), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        feat = tokens_to_image(tokens, (H, W))
        if not torch.equal(cpe(tokens, (H, W)), image_to_tokens(cpe.proj(feat) + feat)):
            fail("ConvPosEnc.forward differs from proj(feat) + feat")
        counts = {}
        t = device_ms(lambda a: cpe(a, (H, W)), [(tokens,)])
        profile_device(lambda: cpe(tokens, (H, W)), t, f"ConvPosEnc.forward {[B, H * W, C]} bf16",
                       counts)
    if counts and (counts.get("dwconv3x3 kernels (K2, K2b)") != 1
                   or counts.get("elementwise and copies", 0) > 1 or sum(counts.values()) > 2):
        fail(f"ConvPosEnc.forward launched {counts}, expected the depthwise kernel once and at "
             f"most one elementwise kernel")


def _site_inputs(shape, dtype, gen):
    """Seeded tokens and LayerNorm affines of one MetaPool site."""
    import torch

    C = shape[-1]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
    w1, w2 = ((torch.rand(C, generator=gen, device="cuda") + 0.5).to(dtype) for _ in range(2))
    b1, b2 = ((torch.randn(C, generator=gen, device="cuda") * 0.1).to(dtype) for _ in range(2))
    return x, w1, b1, w2, b2


def check_site(label, got, want, args, dn):
    """The site's (y, n2) against its plain version: f32 within
    1e-5 |plain| + 1e-5 rms (LayerNorm sums in another order); bf16 no
    further from the chain in f64 than 1.5x the plain passes, in the maximum
    and the mean.  Returns the max abs difference from the plain version."""
    import torch
    import torch.nn.functional as F

    x, w1, b1, w2, b2 = (t.double() for t in args)
    C = x.shape[-1]
    n = F.layer_norm(x, (C,), w1, b1, 1e-6)
    y = x + F.avg_pool2d(n[:, None], 3, 1, 1, count_include_pad=False)[:, 0] - n
    truth = (y, F.layer_norm(y, (C,), w2, b2, 1e-6))
    worst = 0.0
    for what, a, c, t in zip(("y", "n2"), got, want, truth):
        if not bool(torch.isfinite(a).all()):
            fail(f"{label} {what}: non-finite output")
        d = (a.double() - c.double()).abs()
        worst = max(worst, float(d.max()))
        if dn == "float32":
            rms = float(c.double().square().mean().sqrt())
            if not bool((d <= 1e-5 * c.double().abs() + 1e-5 * rms).all()):
                fail(f"{label} {what}: outside 1e-5 |plain| + 1e-5 rms, max diff {float(d.max())}")
            continue
        e_k, e_p = (a.double() - t).abs(), (c.double() - t).abs()
        if float(e_k.max()) > 1.5 * float(e_p.max()) or \
                float(e_k.mean()) > 1.5 * float(e_p.mean()):
            fail(f"{label} {what}: from the f64 chain max {float(e_k.max()):.3e} mean "
                 f"{float(e_k.mean()):.3e}, the plain passes {float(e_p.max()):.3e} / "
                 f"{float(e_p.mean()):.3e}")
    return worst


def bench_metapool_block(report, card, sites, sites_small):
    """The serving block's MetaPool site (LayerNorm1, K1, the residual add,
    LayerNorm2) in one launch, at every site shape of a duke serving batch of
    stc_tt and of stc_st, in bf16 and f32: its bare and residual-only flags
    bit for bit against K1 and K1 + x, the whole site against its plain
    version (``check_site``); timed against the plain version and the four
    PyTorch ops it replaces (F.layer_norm, K1, the add, F.layer_norm), and
    against a bound of 3 passes: x read, y and n2 written.  No single
    PyTorch call computes the site: ``library_ms`` is null, ``four_ops_ms``
    the yardstick."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.ops.kernels.metapool import (
        metapool_block,
        metapool_block_flops,
        metapool_block_reference,
        metapool_tokens,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    print(f"MetaPool site: LayerNorm1 + K1 + x + LayerNorm2 in one launch vs the four ops "
          f"[{card}]:", flush=True)

    def four(x, w1, b1, w2, b2):
        C = x.shape[-1]
        y = x + metapool_tokens(F.layer_norm(x, (C,), w1, b1, 1e-6))
        return y, F.layer_norm(y, (C,), w2, b2, 1e-6)

    tot, max_err = Counter(), 0.0
    for shape in sorted(set(sites) | set(sites_small)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            args = _site_inputs(shape, dtype, gen)
            x, C = args[0], shape[-1]
            label = f"metapool_block {list(shape)} {dn}"
            with torch.inference_mode():
                if not torch.equal(metapool_block(x, residual=False)[0], metapool_tokens(x)):
                    fail(f"{label}: the bare flags differ from metapool_tokens")
                if not torch.equal(metapool_block(x)[0], metapool_tokens(x) + x):
                    fail(f"{label}: the residual-only flags differ from metapool_tokens(x) + x")
                got = metapool_block(*args)
                torch.cuda.synchronize()
                err = check_site(label, got, metapool_block_reference(*args), args, dn)
            max_err = max(max_err, err)
            nbytes = (3 * x.numel() + 4 * C) * x.element_size()
            flops = metapool_block_flops(x.shape)
            copies = [(x.clone(),) + args[1:] for _ in range(n_copies(nbytes))]
            t_k = device_ms(metapool_block, copies)
            t_p = device_ms(metapool_block_reference, copies)
            t_4 = device_ms(four, copies)
            b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
            bound = max(b_bytes, b_ops)
            n, n_small = sites.get(shape, 0), sites_small.get(shape, 0)
            per = (f" x{n}/batch" if n else "") + (f" x{n_small}/stc_st batch" if n_small else "")
            print(f"  {label}{per}: flags bitwise, max_abs_err vs plain {err:.3e}; one launch "
                  f"{t_k * 1e3:.1f} us, four ops {t_4 * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, "
                  f"bound {bound * 1e3:.1f} us ({'bytes' if b_bytes >= b_ops else 'operations'}"
                  f"), {b_bytes / t_k * 100:.0f}% of the byte bound", flush=True)
            if dtype == torch.bfloat16:
                for prefix, k in (("", n), ("small_", n_small)):
                    tot[prefix + "ms"] += k * t_k
                    tot[prefix + "plain_ms"] += k * t_p
                    tot[prefix + "four_ops_ms"] += k * t_4
                    tot[prefix + "bound_ms"] += k * bound
            del copies
    report["kernels"].append({
        "name": "metapool_block", "route": "cuda", "source": "tcct_tpu_torch/csrc/metapool.cu",
        "replaces": "tcct_tpu/ops/pallas/metapool.py:64", "launches": 0, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "four_ops_ms": tot["four_ops_ms"],
        "small_ms": tot["small_ms"], "small_plain_ms": tot["small_plain_ms"],
        "small_bound_ms": tot["small_bound_ms"], "small_four_ops_ms": tot["small_four_ops_ms"]})
    print(f"  per bf16 batch: stc_tt {sum(sites.values())} sites {tot['ms']:.4f} ms in one launch "
          f"each, {tot['four_ops_ms']:.4f} ms as four ops, bound {tot['bound_ms']:.4f} ms; stc_st "
          f"{sum(sites_small.values())} sites {tot['small_ms']:.4f} / "
          f"{tot['small_four_ops_ms']:.4f} / {tot['small_bound_ms']:.4f} ms", flush=True)


def _counted():
    """(row name, wrapper, attribute) of every launch count."""
    from tcct_tpu_torch.ops.kernels.bnstats import (
        bn_act_backward_dx,
        bn_act_backward_sums,
        bn_act_normalize,
        bn_act_sums,
        bn_act_train,
        bn_act_train_backward,
    )
    from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block
    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3, dwconv3x3_backward
    from tcct_tpu_torch.ops.kernels.metapool import (
        metapool_block,
        metapool_block_shard,
        metapool_tokens,
        metapool_tokens_backward,
    )

    return [("fused_cross_block", fused_cross_block, "launches"),
            ("metapool_tokens", metapool_tokens, "launches"),
            ("metapool_block", metapool_block, "launches"),
            ("metapool_block_shard", metapool_block_shard, "launches"),
            ("dwconv3x3", dwconv3x3, "launches"), ("dwconv3x3_s2", dwconv3x3, "launches_s2"),
            ("metapool_tokens_backward", metapool_tokens_backward, "launches"),
            ("dwconv3x3_backward", dwconv3x3_backward, "launches"),
            ("dwconv3x3_backward_s2", dwconv3x3_backward, "launches_s2"),
            ("bn_act_train", bn_act_train, "launches"),
            ("bn_act_train_backward", bn_act_train_backward, "launches"),
            ("bn_act_sums", bn_act_sums, "launches"),
            ("bn_act_normalize", bn_act_normalize, "launches"),
            ("bn_act_backward_sums", bn_act_backward_sums, "launches"),
            ("bn_act_backward_dx", bn_act_backward_dx, "launches")]


def reset_counters() -> None:
    for _, fn, attr in _counted():
        setattr(fn, attr, 0)


def read_counters():
    """Launches by kernel row since the last reset (stride 1 = all - stride 2)."""
    raw = {name: getattr(fn, attr) for name, fn, attr in _counted()}
    return {
        "metapool_tokens": raw["metapool_tokens"],
        "metapool_block": raw["metapool_block"],
        "metapool_block_shard": raw["metapool_block_shard"],
        "dwconv3x3_s1": raw["dwconv3x3"] - raw["dwconv3x3_s2"],
        "dwconv3x3_s2": raw["dwconv3x3_s2"],
        "metapool_tokens_backward": raw["metapool_tokens_backward"],
        "dwconv3x3_backward_s1": raw["dwconv3x3_backward"] - raw["dwconv3x3_backward_s2"],
        "dwconv3x3_backward_s2": raw["dwconv3x3_backward_s2"],
        "bn_act_train": raw["bn_act_train"],
        "bn_act_train_backward": raw["bn_act_train_backward"],
        "fused_cross_block": raw["fused_cross_block"],
        **{k: raw[k] for k in SPLIT_BN},
    }


def drive_slice(report, card):
    import numpy as np
    import torch

    from tcct_tpu_torch.infer.predictor import load_predictor

    t0 = time.perf_counter()
    pred = load_predictor(DB, batch_size=BATCH, dtype=torch.bfloat16, device="cuda", seed=SEED)
    vol = duke_volume()
    print(f"slice: load_predictor({DB!r}) bf16 batch {BATCH}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the main path, with the launch counts read around it
    seg, counts = serve_checked(pred, vol, "slice")
    print(f"slice: launches over {math.ceil(N_SCANS / BATCH)} batches: {counts}", flush=True)
    for e in report["kernels"]:
        if e["name"] in report["per_batch_launches"]:
            if counts[e["name"]] == 0:
                fail(f"kernel {e['name']} was not launched on the serving path")
            e["launches"] = counts[e["name"]]

    # the f32 predictor on the same weights (TF32 off)
    pred32 = load_predictor(DB, batch_size=BATCH, dtype=torch.float32, device="cuda", seed=SEED)
    seg32 = pred32.predict_scans(vol)
    agree = float((seg == seg32).mean())
    print(f"slice: bf16 vs f32 class-map agreement {agree:.6f} (threshold 0.9)", flush=True)
    if agree <= 0.9:
        fail(f"bf16 vs f32 agreement {agree}")
    held_agreement(f"bucket {DB}: bf16 maps with vs without the site",
                   seg, maps_without_site(pred, vol, "slice bf16"), 0.999)
    held_agreement(f"bucket {DB}: f32 maps with vs without the site",
                   seg32, maps_without_site(pred32, vol, "slice f32"), 0.99999)
    plain = {"pred": pred, "vol": vol, "seg": seg, "seg32": seg32, "agree": agree}

    # the f32 model on the card against the CPU path (plain versions), small input
    check_card_vs_cpu(pred32, "slice")
    del pred32

    # steady state, bf16: whole-volume throughput and one batch
    for _ in range(2):
        pred.predict_scans(vol)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        pred.predict_scans(vol)
    torch.cuda.synchronize()
    vol_s = (time.perf_counter() - t0) / reps
    xb = torch.from_numpy(vol[:BATCH]).cuda()
    batch_ms = time_ms(pred._forward, [(xb,)], iters=20)
    graph_ms = device_ms(pred._forward, [(xb,)], iters=20)
    torch.cuda.reset_peak_memory_stats()
    pred._forward(xb)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"slice [{card}]: {N_SCANS}-scan volume {vol_s * 1e3:.2f} ms "
          f"({N_SCANS / vol_s:.1f} B-scans/s incl. host copies and the padded tail); "
          f"one batch of {BATCH} {batch_ms:.3f} ms ({BATCH / batch_ms * 1e3:.1f} B-scans/s), "
          f"{graph_ms:.3f} ms replayed as one CUDA graph; "
          f"peak device memory {peak:.2f} GiB", flush=True)
    by_group = {}
    plain["groups"] = profile_device(lambda: pred._forward(xb), batch_ms, "one bf16 batch",
                                     by_group)
    if by_group:
        print(f"slice: elementwise and copy launches in one bf16 batch: "
              f"{by_group.get('elementwise and copies', 0)}; layer_norm launches: "
              f"{by_group.get('layer_norm', 0)}", flush=True)
        if by_group.get("layer_norm", 0):
            fail("the serving batch still launches a LayerNorm kernel: the site should carry "
                 "every MHCA block's norms")
    plain.update(batch_ms=batch_ms, graph_ms=graph_ms)
    return plain


# --- the fused CrossCNN block kernel (K4) ------------------------------------------

# (what, x shape [B,H,W,Cin], Cout, k, plain, launches per stc_tt duke serving batch)
K4_SHAPES = [
    ("stc_tt duke level 0", (8, 256, 576, 32), 32, 13, False, 1),
    ("stc_tt duke level 1", (8, 128, 288, 32), 32, 11, False, 1),
    ("stc_tt duke level 2", (8, 64, 144, 32), 32, 9, False, 1),
    ("stc_tt duke level 3", (8, 32, 72, 32), 32, 7, False, 1),
    ("stc_tt duke level 4", (8, 16, 36, 32), 32, 5, False, 1),
    ("gtc_tb duke level 1", (8, 128, 288, 32), 64, 11, False, 0),
    ("gtc_tb duke level 2", (8, 64, 144, 64), 96, 9, False, 0),
    ("gtc_tb duke level 3", (8, 32, 72, 96), 128, 7, False, 0),
    ("gtc_tb duke level 4", (8, 16, 36, 128), 256, 5, False, 0),
    ("plain block (k = 3)", (8, 64, 144, 32), 32, 9, True, 0),
    ("smaller than a tile", (8, 4, 8, 32), 32, 5, False, 0),
    ("weights through the ring, no tile divides H, W", (3, 20, 44, 128), 256, 5, False, 0),
]
K4_ITERS = 4


def k4_plan_text(plan) -> str:
    ring = f"ring 2 x {plan.ring} steps" if plan.ring else "resident weights"
    return f"tile {plan.th}x{plan.tw}, {ring}, {plan.threads} threads"


def k4_weight_bytes(plan, shape, cout, k):
    """Weight bytes one bf16 launch copies from L2 into shared memory under
    ``plan`` (each stage's weights once a block when resident, once a round
    of warp items when streamed), and what the same tile read when every
    warp item took its conv's weights for its 32 output channels from
    global memory (the earlier design).  A warp's item is 2 M tiles x 32
    output channels."""
    B, H, W, cin = shape
    th, tw, R, ncg = plan.th, plan.tw, k // 2 + 2, cout // 32
    blocks = B * math.ceil(H / th) * math.ceil(W / tw)
    stages = [(th + 4, tw + 4, 9 * cin), (th + 2 * R, tw + 4, k * cin), (th + 4, tw + 4, k * cout),
              (th + 2, tw + 2, 18 * cout), (th, tw, 9 * cout)]  # (rows, columns, taps x Cin)
    now = per_item = 0
    for oh, ow, kc in stages:
        wbytes = kc * cout * 2
        mtiles = oh * math.ceil(ow / 16)
        per_item += math.ceil(mtiles / 2) * ncg * wbytes // ncg
        rounds = math.ceil(math.ceil(mtiles / 2) * ncg / (plan.threads // 32))
        now += wbytes * (rounds if plan.ring else 1)
    return now * blocks, per_item * blocks


def check_fused_block(name, got, want, truth, dn):
    """The kernel against its plain version, and both against the same chain
    summed in f64 (``truth``, on the first batch element).

    Both versions round the same chain at the same places and differ in the
    order of their f32 sums; the bounds scale with the plain output's rms (5
    to 12 with these seeded blocks, elements up to 290).
    f32: |kernel - plain| <= 1e-4 rms + 1e-4 |plain| (1e-4 + 1e-4 rel at unit
    scale): the summation-order error of six chained convs.
    bf16: where the two f32 sums of an intermediate straddle a bf16 rounding
    boundary the intermediate differs by one bf16 ulp, and up to three more
    convs and a BatchNorm scale carry that to a few outputs.  So every
    element is held to 2^-7 |plain| + 2^-3 rms, all but 2 + 2^-19 of them
    (about two in a million; seen: at most 6 of 37.7 million) to
    2^-6 |plain| + 2^-5 rms, and the mean error to 2^-11 rms (seen: at most
    2^-12.2 rms).
    Either type: the kernel is no further from the f64 chain than the plain
    version is, at most (twice its distance plus 1e-6, in bf16 2^-9, of the
    largest element) and on average (1.25 times its mean distance; seen: at
    most 1.05 times)."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite output")
    err = (g - w).abs()
    rms = float(w.pow(2).mean().sqrt().clamp_min(1.0))
    n_out = 0
    if dn == "float32":
        lim = 1e-4 * rms + 1e-4 * w.abs()
    else:
        lim = 2.0 ** -7 * w.abs() + 2.0 ** -3 * rms
        n_out = int((err > 2.0 ** -6 * w.abs() + 2.0 ** -5 * rms).sum())
        if n_out > 2 + err.numel() * 2.0 ** -19:
            fail(f"{name}: {n_out} of {err.numel()} elements outside the narrow bound")
        if float(err.mean()) > 2.0 ** -11 * rms:
            fail(f"{name}: mean abs err {float(err.mean()):.3e} at plain rms {rms:.2f}")
    if bool((err > lim).any()):
        fail(f"{name}: {int((err > lim).sum())} elements outside their bound, max abs err "
             f"{float(err.max()):.3e}, max excess {float((err - lim).max()):.3e}")
    n = truth.shape[0]
    d_k, d_p = (got[:n].double() - truth).abs(), (want[:n].double() - truth).abs()
    e_k, e_p = float(d_k.max()), float(d_p.max())
    slack = (1e-6 if dn == "float32" else 2.0 ** -9) * float(truth.abs().max())
    if e_k > 2 * e_p + slack:
        fail(f"{name}: kernel {e_k:.3e} from the f64 chain, plain version {e_p:.3e}")
    m_k, m_p = float(d_k.mean()), float(d_p.mean())
    if m_k > 1.25 * m_p:
        fail(f"{name}: kernel on average {m_k:.3e} from the f64 chain, plain version {m_p:.3e}")
    return float(err.max()), float(err.mean()), rms, n_out, (e_k, e_p, m_k, m_p)


def bench_fused_block(report, card):
    """K4 against its plain version on the card, bf16 (tensor cores) and f32
    (CUDA cores, TF32 off), at the shapes of K4_SHAPES, and per launch by
    CUDA-graph replay on inputs beyond L2: kernel, plain version, and the
    module path's block (``CrossCNNBlock.forward``: cuDNN convs and
    elementwise passes) for orientation.  No single PyTorch call computes
    the block, so there is no library column.  Bound: the larger of bytes (x
    read, y written, the weights once) over 3.35 TB/s and operations (no
    halo recompute) over the card's dense bf16 tensor-core rate for bf16
    inputs, the f32 FMA rate for f32.  The row's totals are one ``stc_tt``
    duke bf16 serving batch."""
    import torch

    from tcct_tpu_torch.models.crosscnn import seeded_cross_block
    from tcct_tpu_torch.ops.kernels.crosscnn_fused import (
        fused_cross_block,
        fused_cross_block_flops,
        fused_cross_block_reference,
        fused_plan,
    )

    print(f"fused CrossCNN block kernel vs its plain version [{card}]:", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    tot = Counter()
    max_err = 0.0
    with torch.inference_mode():
        for i, (what, shape, cout, k, plain, n_serve) in enumerate(K4_SHAPES):
            B, H, W, cin = shape
            kk = 3 if plain else k
            macs = 9 * cin * cout + 3 * 9 * cout * cout + kk * cin * cout + kk * cout * cout
            flops = fused_cross_block_flops(shape, cin, cout, kk)
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                blk = seeded_cross_block(cin, cout, k, SEED + 10 + i, plain).to("cuda", dtype)
                x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
                label = f"fused_cross_block {list(shape)} -> {cout} k {kk} {dn}"
                plan = fused_plan(B, H, W, cin, cout, kk, dtype)
                got = fused_cross_block(x, blk)
                torch.cuda.synchronize()
                want = fused_cross_block_reference(x, blk)
                truth = fused_cross_block_reference(x[:1], blk, acc=torch.float64)
                err, mean_err, rms, n_out, (e_k, e_p, m_k, m_p) = check_fused_block(
                    label, got, want, truth, dn)
                del got, want, truth
                max_err = max(max_err, err)
                nbytes = (x.numel() + B * H * W * cout + macs) * x.element_size()
                copies = [(x.clone(),) for _ in range(n_copies(x.numel() * x.element_size()))]
                t_k = device_ms(lambda t: fused_cross_block(t, blk), copies, K4_ITERS)
                t_p = device_ms(lambda t: fused_cross_block_reference(t, blk), copies, K4_ITERS)
                t_m = device_ms(lambda t: blk(t.permute(0, 3, 1, 2)), copies, K4_ITERS)
                b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
                b_ops = flops / rate * 1e3
                bound = max(b_bytes, b_ops)
                how = f"tile {plan.th}x{plan.tw} ({plan.smem} B shared)"
                if dtype == torch.bfloat16:
                    now, per_item = k4_weight_bytes(plan, shape, cout, kk)
                    how = (f"{k4_plan_text(plan)}; shared bytes: activations "
                           f"{plan.smem - plan.weight_smem}, weights {plan.weight_smem}; weight "
                           f"bytes from L2 a launch {now / 1e6:.1f} MB (read by every warp item: "
                           f"{per_item / 1e6:.1f} MB)")
                print(f"  {what}: {label}{' x1/batch' if n_serve else ''}: {how}, "
                      f"max_abs_err {err:.3e} (mean {mean_err:.3e}, plain rms "
                      f"{rms:.2f}, {n_out} outside the narrow bound; from the f64 chain: kernel max {e_k:.3e} mean {m_k:.3e}, plain "
                      f"max {e_p:.3e} mean {m_p:.3e}), "
                      f"kernel {t_k * 1e3:.1f} us = {flops / t_k / 1e9:.1f} TFLOP/s, plain {t_p:.3f} ms, "
                      f"module path {t_m:.3f} ms, bound {bound * 1e3:.1f} us "
                      f"({'bytes' if b_bytes >= b_ops else 'operations'} at "
                      f"{rate / 1e12:.0f} TFLOP/s), {bound / t_k * 100:.1f}% of it", flush=True)
                if dtype == torch.bfloat16:
                    tot["ms"] += n_serve * t_k
                    tot["plain_ms"] += n_serve * t_p
                    tot["module_ms"] += n_serve * t_m
                    tot["bound_ms"] += n_serve * bound
                    tot["bytes_ms"] += n_serve * b_bytes
                    tot["ops_ms"] += n_serve * b_ops
                del copies, x, blk
    report["kernels"].append({
        "name": "fused_cross_block", "route": "cuda",
        "source": "tcct_tpu_torch/csrc/crosscnn_fused.cu",
        "replaces": "attic/crosscnn_fused.py:237", "launches": 0, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        "library_ms": None, "module_ms": tot["module_ms"],
    })


def _c_entries(path: str):
    """The C entry points a source declares: {name: declaration, whitespace
    normalised}."""
    with open(path) as f:
        decls = (" ".join(d.split()) for d in re.findall(r'extern "C"[^{;]*', f.read()))
    return {re.search(r"(\w+)\(", d).group(1): d for d in decls}


class _SameEntries:
    """Another tree's kernel library showing only the C entries that it
    declares exactly as this tree does: a wrapper that calls any other
    entry gets AttributeError, never a call with the wrong arguments."""

    def __init__(self, lib, names):
        self._lib, self._names = lib, names

    def __getattr__(self, name):
        if name not in self._names:
            raise AttributeError(f"{name}: not declared as in this tree")
        return getattr(self._lib, name)


def _build_other(other_root: str):
    """DIR's kernel sources built beside this tree's (one ``nvcc`` each, all
    at once): {source name: library showing the entries this tree shares}."""
    import ctypes

    from tcct_tpu_torch.ops.kernels import build

    out_dir = os.path.join(build.BUILD_DIR, "other")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in build.sources():
        src = os.path.join(other_root, "tcct_tpu_torch", "csrc", name + ".cu")
        if not os.path.exists(src):
            continue
        mine, theirs = _c_entries(os.path.join(build.CSRC_DIR, name + ".cu")), _c_entries(src)
        same = {n for n, d in theirs.items() if mine.get(n) == d}
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src]
        procs[name] = (same, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (same, lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"cannot build {other_root}'s {name}.cu: {out[-2000:]}")
        libs[name] = _SameEntries(ctypes.CDLL(lib), same)
        print(f"  {name}.cu: entries as in this tree: {sorted(same)}", flush=True)
    return libs


def _use_libraries(libs) -> None:
    """Point the kernel wrappers at ``libs`` ({source name: library})."""
    from tcct_tpu_torch.ops.kernels import bnstats, build, crosscnn_fused, dwconv, metapool

    build._libs.update(libs)
    for mod in (bnstats, crosscnn_fused, dwconv, metapool):
        mod._fn.cache_clear()


def against_cases(names):
    """Every kernel call of the main paths as (name, source, label, make,
    kern, iters, per-path launches): the kernel table's shapes in bf16 and
    f32, the MetaPool site at the serving shapes of stc_tt and stc_st, the
    fused block at K4_SHAPES in bf16.  ``names``: name prefixes to keep
    (all when empty).  ``make()`` gives the arguments of ``kern``."""
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.models.crosscnn import seeded_cross_block
    from tcct_tpu_torch.models.mpvit import MPViTConfig, mpvit_small_config
    from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block
    from tcct_tpu_torch.ops.kernels.metapool import metapool_block

    def keep(name):
        return not names or any(name.startswith(n) for n in names)

    hw = get_geometry(DB).prep_hw
    serve = path_shapes(MPViTConfig(), BATCH, hw)
    small = path_shapes(mpvit_small_config(), BATCH, hw)
    train, gtc, task2 = step_tables()
    for t in kernel_tables(serve, train, small, gtc, task2):
        if not keep(t["name"]):
            continue
        src = os.path.splitext(os.path.basename(t["source"]))[0]
        for row in t["rows"]:
            sp = row[0]
            for shape in sorted({k[0] for c in row[1:] for k in c}):
                for dn in row_types(shape, row[1:]):
                    per = {what.lstrip("/"): row[i].get((shape, dn), 0) for _, i, what in PATHS}
                    yield (t["name"], src, f"{t['name']}{sp['tag']} {list(shape)} {dn}",
                           lambda sp=sp, shape=shape, dn=dn: sp["make"](shape, dn),
                           sp["kern"], 30, per)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    if keep("metapool_block"):
        for shape in sorted(set(serve[0]) | set(small[0])):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                per = {"batch": serve[0].get(shape, 0) if dn == "bfloat16" else 0,
                       "stc_st batch": small[0].get(shape, 0) if dn == "bfloat16" else 0}
                yield ("metapool_block", "metapool", f"metapool_block {list(shape)} {dn}",
                       lambda shape=shape, dtype=dtype: _site_inputs(shape, dtype, gen),
                       metapool_block, 30, per)
    if keep("fused_cross_block"):
        for i, (what, shape, cout, k, plain, n) in enumerate(K4_SHAPES):
            def make(i=i, shape=shape, cout=cout, k=k, plain=plain):
                blk = seeded_cross_block(shape[-1], cout, k, SEED + 30 + i, plain)
                blk = blk.to("cuda", torch.bfloat16)
                x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                return x, blk

            def kern(x, blk):
                with torch.inference_mode():
                    return fused_cross_block(x, blk)
            yield ("fused_cross_block", "crosscnn_fused",
                   f"fused_cross_block {what} {list(shape)} -> {cout} k {k} bfloat16", make, kern,
                   K4_ITERS, {"batch": n if what.startswith("stc_tt") else 0})


def _same_bits(a, b) -> bool:
    """Two kernel results (a tensor, or a tuple of tensors and Nones) equal bit for bit."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_bits(p, q) for p, q in zip(a, b))
    if a is None or b is None:
        return a is b
    return torch.equal(a, b)


def compare_against(other_root: str, card: str, names=(), timed: bool = True):
    """``--against DIR [NAME ...]``: this tree's kernels against DIR's at every
    call of :func:`against_cases`: bit for bit (a difference fails the run
    after the table), with ``timed`` device us per call in turns (other,
    this, this, other) and each kernel's totals per path (launches x the mean
    of each side's two turns).  A case whose C entries DIR does not declare
    as this tree does is listed as not compared.  Returns the verdicts."""
    import torch

    from tcct_tpu_torch.ops.kernels import build

    print(f"kernels: this tree against {other_root}'s sources [{card}]:", flush=True)
    other = _build_other(other_root)
    mine = {n: build.load(n) for n in other}
    verdicts, differ, skipped, tot = [], [], Counter(), Counter()
    for name, src, label, make, kern, iters, per in against_cases(names):
        if src not in other:
            skipped[name] += 1
            continue
        args = make()
        _use_libraries(mine)
        want = kern(*args)
        _use_libraries(other)
        try:
            got = kern(*args)
        except (AttributeError, ValueError):  # DIR lacks the entry, or refuses the shape
            skipped[name] += 1
            continue
        finally:
            _use_libraries(mine)
        same = _same_bits(got, want)
        verdicts.append(same)
        if not same:
            differ.append(label)
        line = f"  {label}: {'bitwise equal' if same else 'DIFFERS'}"
        if timed:
            nbytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
            copies = [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                      for _ in range(n_copies(2 * nbytes))]
            us = []
            for libs in (other, mine, mine, other):
                _use_libraries(libs)
                us.append(device_ms(kern, copies, iters) * 1e3)
            _use_libraries(mine)
            for path, n in per.items():
                tot[(name, path, "other")] += n * (us[0] + us[3]) / 2e3
                tot[(name, path, "this")] += n * (us[1] + us[2]) / 2e3
            line += (f"; us other {us[0]:.1f}, {us[3]:.1f}; this {us[1]:.1f}, {us[2]:.1f}"
                     + "".join(f" x{n}/{p}" for p, n in per.items() if n))
            del copies
        print(line, flush=True)
        del args, got, want
    for name, n in sorted(skipped.items()):
        print(f"  {name}: {n} calls not compared (DIR lacks an entry this tree declares, or "
              f"its kernel refuses the shape)")
    for name in dict.fromkeys(k[0] for k in tot):
        cells = [f"per {path} {tot[(name, path, 'other')]:.4f} / {tot[(name, path, 'this')]:.4f}"
                 for path in dict.fromkeys(k[1] for k in tot if k[0] == name)
                 if tot[(name, path, "this")]]
        if cells:
            print(f"  {name} ms, other / this: " + "; ".join(cells), flush=True)
    if differ:
        fail(f"{len(differ)} calls differ from {other_root}'s kernels: {differ}")
    return verdicts


def serve_diagnostics(card: str) -> None:
    """``--profile DIR``, first half: one duke bf16 batch of stc_tt (CNN branch
    plain, then fused) and of stc_st, each eager and replayed as one CUDA
    graph, then profiled: device busy ms, launches, and the layer_norm and
    MetaPool groups.  Not held: for parent-and-change comparisons."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor

    H, W = get_geometry(DB).prep_hw
    vol = np.random.default_rng(SEED).integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    xb = torch.from_numpy(vol).cuda()
    for net, impl in (("stc_tt", "plain"), ("stc_tt", "fused"), ("stc_st", "plain")):
        pred = load_predictor(DB, net=net, cnn_impl=impl, batch_size=BATCH, dtype=torch.bfloat16,
                              device="cuda", seed=SEED)
        pred.predict_scans(vol)
        eager, graph, _ = batch_times(pred, xb, 20)
        counts = Counter()
        groups = profile_device(lambda: pred._forward(xb), eager, f"{net} {impl} bf16 batch",
                                counts)
        mp = next((g for g in groups if g.startswith("metapool")), "metapool")
        print(f"serve-profile [{card}]: {net} {impl}: replayed {graph:.3f} ms, eager "
              f"{eager:.3f} ms, device busy {sum(groups.values()):.3f} ms, "
              f"{sum(counts.values())} launches; layer_norm {groups.get('layer_norm', 0.0):.3f} ms "
              f"x{counts.get('layer_norm', 0)}; MetaPool {groups.get(mp, 0.0):.3f} ms "
              f"x{counts.get(mp, 0)}", flush=True)
        del pred


def expected_launches(model, batch: int, hw, fused: bool):
    """Launches per serving batch of each kernel, from the model's config:
    every MetaPool site is one launch of the site kernel, none of bare K1
    (ReLayNet: none at all)."""
    base = model.base
    vit = getattr(base, "flag_vit", False)
    mp, s1, s2 = path_shapes(base.vit_cfg, batch, hw) if vit else ({}, {}, {})
    return {"metapool_block": sum(mp.values()), "dwconv3x3_s1": sum(s1.values()),
            "dwconv3x3_s2": sum(s2.values()), "fused_cross_block": 5 if fused else 0}


def serve_checked(pred, vol, what: str):
    """``pred.predict_scans(vol)`` with the launch counts set to 0 just
    before and read just after; fails unless every count is the config's
    and the class maps have the right shape, dtype and range."""
    import numpy as np
    import torch

    H, W = pred.geo.prep_hw
    reset_counters()
    seg = pred.predict_scans(vol)
    torch.cuda.synchronize()
    counts = read_counters()
    n_batches = math.ceil(len(vol) / pred.batch_size)
    want = expected_launches(pred.model, pred.batch_size, (H, W), pred.cnn_impl == "fused")
    for k, n in counts.items():
        if n != n_batches * want.get(k, 0):
            fail(f"{what}: kernel {k}: {n} launches over {n_batches} batches, expected "
                 f"{n_batches * want.get(k, 0)}")
    if seg.shape != (len(vol), H, W) or seg.dtype != np.uint8:
        fail(f"{what}: class map {seg.shape} {seg.dtype}, want {(len(vol), H, W)} uint8")
    if int(seg.max()) >= pred.geo.out_channels:
        fail(f"{what}: class index {int(seg.max())} out of range")
    return seg, counts


def held_agreement(what: str, a, b, threshold: float) -> float:
    agree = float((a == b).mean())
    print(f"{what}: class maps agree on {agree:.6f} of pixels (threshold {threshold})", flush=True)
    if agree < threshold:
        fail(f"{what}: agreement {agree} below {threshold}")
    return agree


def maps_without_site(pred, vol, what: str):
    """Class maps of ``pred``'s eval model (CNN branch plain) called under
    ``torch.enable_grad()``: every MHCA block then runs norm1, K1, the add
    and norm2 as four ops.  The launch counts are held to that: bare K1 once
    a site, the site kernel never."""
    import numpy as np
    import torch

    bs = pred.batch_size
    reset_counters()
    segs = []
    for i in range(0, len(vol), bs):
        chunk = vol[i: i + bs]
        if len(chunk) < bs:
            chunk = np.concatenate([chunk, np.zeros((bs - len(chunk),) + chunk.shape[1:],
                                                    chunk.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(pred.device).to(pred.dtype) / 255.0
        with torch.enable_grad():
            logits = pred.model(x)[0]
        segs.append(torch.argmax(logits.detach(), dim=-1).to(torch.uint8))
        del logits
    seg = torch.cat(segs)[:len(vol)].cpu().numpy()
    counts = read_counters()
    sites = expected_launches(pred.model, bs, pred.geo.prep_hw, False)["metapool_block"]
    n_batches = math.ceil(len(vol) / bs)
    if counts["metapool_block"] != 0 or counts["metapool_tokens"] != sites * n_batches:
        fail(f"{what}: without the site: {counts['metapool_block']} site and "
             f"{counts['metapool_tokens']} K1 launches, expected 0 and {sites * n_batches}")
    return seg


def batch_times(pred, xb, iters: int = 10):
    """(eager ms, CUDA-graph replay ms, peak GiB) of one batch."""
    import torch

    eager = time_ms(pred._forward, [(xb,)], iters=iters)
    graph = device_ms(pred._forward, [(xb,)], iters=iters)
    torch.cuda.reset_peak_memory_stats()
    pred._forward(xb)
    torch.cuda.synchronize()
    return eager, graph, torch.cuda.max_memory_allocated() / 2 ** 30


def check_card_vs_cpu(pred32, what: str) -> None:
    """The f32 model of ``pred32`` on the card (kernels) against the CPU
    path (plain versions) on a small seeded input: every head within
    1e-3 + 1e-5 * (logit scale).  Leaves the model on the CPU."""
    import numpy as np
    import torch

    from tcct_tpu_torch.models.crosscnn import cross_resnet_fused

    model = pred32.model
    fused = pred32.cnn_impl == "fused"
    x = torch.from_numpy(np.random.default_rng(SEED + 1).random((2, 64, 128, 3), np.float32))

    def run(t):
        with torch.inference_mode():
            kw = {"cnn_feats": cross_resnet_fused(t, model.base.base_cnn)} if fused else {}
            return [y.cpu() for y in model(t, **kw)]

    got = run(x.cuda())
    model.to("cpu")
    ref = run(x)
    for i, (g, r) in enumerate(zip(got, ref)):
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        print(f"{what}: f32 head {i} card vs CPU max abs err {err:.3e} (logit scale {scale:.1f})",
              flush=True)
        if not err <= 1e-3 + 1e-5 * scale:
            fail(f"{what}: head {i}: card vs CPU max abs err {err}")


def drive_fused(report, card, plain):
    """The fused path at full width: ``load_predictor(duke, net='stc_tt',
    cnn_impl='fused')``, bf16, batch 8, the 20-scan volume of the plain
    path, with the launch counts read around it; its class maps against the
    plain predictor's on the same weights; one batch eager and replayed,
    against the plain path's in the same run."""
    import torch

    from tcct_tpu_torch.infer.predictor import load_predictor

    vol = plain["vol"]
    kw = dict(net="stc_tt", batch_size=BATCH, device="cuda", seed=SEED)
    pred = load_predictor(DB, cnn_impl="fused", dtype=torch.bfloat16, **kw)
    seg, counts = serve_checked(pred, vol, "fused slice")  # the main path of this slice
    n_batches = math.ceil(N_SCANS / BATCH)
    print(f"fused slice: launches over {n_batches} batches: {counts}", flush=True)
    for e in report["kernels"]:
        if e["name"] == "fused_cross_block":
            e["launches"] = counts["fused_cross_block"]
    if counts["fused_cross_block"] != 5 * n_batches:
        fail(f"fused slice: {counts['fused_cross_block']} K4 launches, expected {5 * n_batches}")

    pred32 = load_predictor(DB, cnn_impl="fused", dtype=torch.float32, **kw)
    seg32 = pred32.predict_scans(vol)
    held_agreement("fused slice: f32 fused vs f32 plain", seg32, plain["seg32"], 0.999)
    a = held_agreement("fused slice: bf16 fused vs f32 plain", seg, plain["seg32"], 0.9)
    print(f"fused slice: bf16 plain vs f32 plain was {plain['agree']:.6f}; bf16 fused vs bf16 "
          f"plain {float((seg == plain['seg']).mean()):.6f}; difference of the two bf16 "
          f"agreements {a - plain['agree']:+.6f}", flush=True)
    check_card_vs_cpu(pred32, "fused slice")
    del pred32

    xb = torch.from_numpy(vol[:BATCH]).cuda()
    for _ in range(2):
        pred.predict_scans(vol)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        pred.predict_scans(vol)
    torch.cuda.synchronize()
    vol_s = (time.perf_counter() - t0) / 3
    eager, graph, peak = batch_times(pred, xb, 20)
    p_eager, p_graph, _ = batch_times(plain["pred"], xb, 20)
    print(f"fused slice [{card}]: {N_SCANS}-scan volume {vol_s * 1e3:.2f} ms "
          f"({N_SCANS / vol_s:.1f} B-scans/s); one batch of {BATCH}: fused {eager:.3f} ms eager, "
          f"{graph:.3f} ms replayed as one CUDA graph ({BATCH / graph * 1e3:.1f} B-scans/s); "
          f"plain, same run {p_eager:.3f} ms eager, {p_graph:.3f} ms replayed; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    profile_device(lambda: pred._forward(xb), eager, "one bf16 batch, cnn_impl='fused'")

    # the CNN branch alone, module path, on the same batch: its device time
    # and its share of the plain path's elementwise time
    cnn = plain["pred"].model.base.base_cnn
    x = (xb.to(torch.bfloat16) / 255.0).permute(0, 3, 1, 2)
    with torch.inference_mode():
        cnn_ms = device_ms(cnn, [(x,)], iters=20)
        groups = profile_device(lambda: cnn(x), cnn_ms,
                                "CrossResNet.forward alone, module path, bf16")
    ew = "elementwise and copies"
    if groups and plain["groups"].get(ew):
        print(f"fused slice: CrossResNet.forward, module path: {cnn_ms:.3f} ms replayed; its "
              f"elementwise passes {groups.get(ew, 0.0):.3f} ms = "
              f"{groups.get(ew, 0.0) / plain['groups'][ew] * 100:.1f}% of the plain batch's "
              f"{plain['groups'][ew]:.3f} ms", flush=True)


# --- the serving artifact: torch.export of the duke model ----------------------------

EXPORT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_export")


def duke_volume():
    """The seeded 20-scan duke volume every serving phase serves."""
    import numpy as np

    from tcct_tpu_torch.data.geometry import get_geometry

    H, W = get_geometry(DB).prep_hw
    return np.random.default_rng(SEED).integers(0, 256, (N_SCANS, H, W, 3), dtype=np.uint8)


def serve_program(fn, vol, bs: int, dtype, device):
    """``predict_scans`` through ``fn(x) -> logits`` (an exported program):
    batches of ``bs``, the tail padded with zeros, uint8 to ``dtype`` / 255 on
    ``device``, the argmax as uint8 class maps."""
    import numpy as np
    import torch

    segs = []
    for i in range(0, len(vol), bs):
        chunk = vol[i: i + bs]
        if len(chunk) < bs:
            chunk = np.concatenate([chunk, np.zeros((bs - len(chunk),) + chunk.shape[1:],
                                                    chunk.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
        with torch.inference_mode():
            segs.append(torch.argmax(fn(x.to(dtype) / 255.0), dim=-1).to(torch.uint8))
    return torch.cat(segs)[:len(vol)].cpu().numpy()


def serve_exported(path: str, out: str) -> None:
    """``--serve-exported PROGRAM OUT``, the fresh process of
    :func:`drive_export`: loads the bf16 program with ``load_exported``,
    serves the duke volume through it with the launch counts set to 0 just
    before and read just after, then one batch of 3, and writes the class
    maps and the counts to the npz ``OUT``."""
    import numpy as np
    import torch

    from tcct_tpu_torch.infer.export import load_exported

    fn = load_exported(path)
    vol = duke_volume()
    reset_counters()
    seg = serve_program(fn, vol, BATCH, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    counts = read_counters()
    seg3 = serve_program(fn, vol[:3], 3, torch.bfloat16, "cuda")
    np.savez(out, seg=seg, seg3=seg3, counts=json.dumps(counts))


def drive_export(card, plain):
    """The serving artifact on the card (``infer/export.py``): the duke
    ``stc_tt`` predictor's bf16 model exported with a symbolic batch (its
    time), the graph's ``tcct::`` ops held to ``expected_launches``; the
    program saved under ``build/`` and served in a fresh process
    (``--serve-exported``): class maps bitwise the eager predictor's, the
    launches per batch the eager predictor's, a batch of 3 bitwise the
    eager model's at 3; then in f32 (TF32 off) bitwise the eager f32 maps
    and on at least 99.999 % of pixels the CPU program's from the same
    weights; the program's ms per batch against the eager module's in turns
    (eager and replayed), its device time by op from ``utils/profiling``,
    and ``cost_analysis`` of one batch."""
    import numpy as np
    import torch

    from tcct_tpu_torch.infer.export import export_model, load_exported
    from tcct_tpu_torch.infer.predictor import load_predictor
    from tcct_tpu_torch.utils.profiling import cost_analysis, measured_traffic, trace

    pred, vol = plain["pred"], plain["vol"]
    H, W = pred.geo.prep_hw
    os.makedirs(EXPORT_DIR, exist_ok=True)
    path = os.path.join(EXPORT_DIR, "stc_tt_duke_bf16.pt2")
    xb = torch.from_numpy(vol[:BATCH]).cuda()
    xf = xb.to(torch.bfloat16) / 255.0
    t0 = time.perf_counter()
    export_model(pred.model, xf, path)
    export_s = time.perf_counter() - t0
    program = torch.export.load(path)
    ops = Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")
    strides = Counter(n.args[3] for n in program.graph.nodes
                      if n.op == "call_function" and str(n.target) == "tcct.dwconv3x3.default")
    got = {"metapool_block": ops["tcct.metapool_block.default"], "dwconv3x3_s1": strides[1],
           "dwconv3x3_s2": strides[2], "fused_cross_block": ops["tcct.fused_cross_block.default"]}
    want = expected_launches(pred.model, BATCH, (H, W), False)
    print(f"export [{card}]: stc_tt duke bf16 batch {BATCH} (symbolic batch) exported in "
          f"{export_s:.2f} s, saved {os.path.getsize(path) / 2 ** 20:.1f} MiB; tcct ops in the "
          f"graph {got}; layer_norm ops "
          f"{sum(n for t, n in ops.items() if 'layer_norm' in t)}", flush=True)
    if got != want or any("layer_norm" in t for t in ops):
        fail(f"export: the graph's ops {got} (layer_norm: "
             f"{[t for t in ops if 'layer_norm' in t]}), expected {want} and no layer_norm")
    del program

    # a fresh process loads and serves it
    out = os.path.join(EXPORT_DIR, "served.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-exported", path,
                           out], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"export: the fresh process failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    with np.load(out) as served:
        seg, seg3, counts = served["seg"], served["seg3"], json.loads(str(served["counts"]))
    n_batches = math.ceil(N_SCANS / BATCH)
    print(f"export: served {N_SCANS} scans in a fresh process ({time.perf_counter() - t0:.2f} s "
          f"with its start): launches {counts}", flush=True)
    for k, n in counts.items():
        if n != n_batches * want.get(k, 0):
            fail(f"export: kernel {k}: {n} launches over {n_batches} batches, expected "
                 f"{n_batches * want.get(k, 0)} as the eager predictor's")
    if not np.array_equal(seg, plain["seg"]):
        fail(f"export: class maps differ from the eager predictor's on "
             f"{float((seg != plain['seg']).mean()):.3e} of pixels")
    with torch.inference_mode():
        eager3 = pred._forward(xb[:3]).cpu().numpy()
    if seg3.shape != (3, H, W) or not np.array_equal(seg3, eager3):
        fail(f"export: a batch of 3 through the batch-{BATCH} program: {seg3.shape}, "
             f"{float((seg3 != eager3).mean()) if seg3.shape == eager3.shape else 'n/a'} of "
             f"pixels off the eager model's")
    print(f"export: bf16 class maps bitwise the eager predictor's (20 scans), a batch of 3 "
          f"bitwise the eager model's at 3", flush=True)

    # timing in turns: the eager module and the program, eager and replayed
    fn = load_exported(path)

    def eager(x):
        with torch.inference_mode():
            return pred.model(x)[0]

    rows = []
    for name, f in (("eager module", eager), ("program", fn), ("program", fn),
                    ("eager module", eager)):
        rows.append((name, time_ms(f, [(xf,)], iters=40), device_ms(f, [(xf,)], iters=20)))
    print(f"export [{card}]: ms per batch of {BATCH}, in turns (eager / replayed as one CUDA "
          "graph): " + "; ".join(f"{n} {e:.3f} / {g:.3f}" for n, e, g in rows), flush=True)
    tdir = os.path.join(EXPORT_DIR, "trace")
    fn(xf)
    with trace(tdir):
        fn(xf)
    traffic = measured_traffic(tdir)
    print(f"export: profile of one program batch (utils/profiling): device self "
          f"{traffic['self_time_s'] * 1e3:.3f} ms; by op:", flush=True)
    for op, t in sorted(traffic["categories"].items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {t * 1e3:8.3f} ms  {op}", flush=True)
    cost = cost_analysis(fn, xf)
    print(f"export: cost_analysis of one batch: {cost['flops'] / 1e9:.2f} GFLOP, "
          f"{cost['bytes_accessed'] / 1e9:.3f} GB accessed (inputs plus outputs of every op), "
          f"{cost['transcendentals'] / 1e6:.2f} M transcendentals", flush=True)
    del fn

    # f32 (TF32 off): the card's program against the eager maps and the CPU's program
    pred32 = load_predictor(DB, batch_size=BATCH, dtype=torch.float32, device="cuda", seed=SEED)
    path32 = os.path.join(EXPORT_DIR, "stc_tt_duke_f32.pt2")
    export_model(pred32.model, xb.float() / 255.0, path32)
    seg32 = serve_program(load_exported(path32), vol, BATCH, torch.float32, "cuda")
    if not np.array_equal(seg32, plain["seg32"]):
        fail(f"export: f32 class maps differ from the eager f32 predictor's on "
             f"{float((seg32 != plain['seg32']).mean()):.3e} of pixels")
    cpu_model = pred32.model.to("cpu")
    path_cpu = os.path.join(EXPORT_DIR, "stc_tt_duke_f32_cpu.pt2")
    t0 = time.perf_counter()
    export_model(cpu_model, xb.cpu().float() / 255.0, path_cpu)
    seg_cpu = serve_program(load_exported(path_cpu), vol, BATCH, torch.float32, "cpu")
    print(f"export: f32 program bitwise the eager f32 maps; the CPU program exported and served "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    held_agreement("export: f32 card program vs f32 CPU program", seg32, seg_cpu, 0.99999)
    del pred32, cpu_model


def drive_both_ways(net: str, card):
    """One model at full width on duke, bf16, one 20-scan volume, with the
    CNN branch plain and fused: launch counts, class maps, agreement of the
    f32 maps (fused vs plain, at least 99.9 %) and of the bf16 maps with
    them (above 90 %), the f32 model against the CPU path both ways, ms per
    batch."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor

    H, W = get_geometry(DB).prep_hw
    vol = np.random.default_rng(SEED).integers(0, 256, (N_SCANS, H, W, 3), dtype=np.uint8)
    xb = torch.from_numpy(vol[:BATCH]).cuda()
    segs = {}
    for impl in ("plain", "fused"):
        kw = dict(net=net, cnn_impl=impl, batch_size=BATCH, device="cuda", seed=SEED)
        pred = load_predictor(DB, dtype=torch.bfloat16, **kw)
        segs[impl, "bf16"], counts = serve_checked(pred, vol, f"{net} {impl}")
        eager, graph, peak = batch_times(pred, xb)
        print(f"{net} {impl} [{card}]: launches over {math.ceil(N_SCANS / BATCH)} batches "
              f"{counts}; one bf16 batch of {BATCH}: {eager:.3f} ms eager, {graph:.3f} ms "
              f"replayed ({BATCH / graph * 1e3:.1f} B-scans/s), peak {peak:.2f} GiB", flush=True)
        del pred
        pred32 = load_predictor(DB, dtype=torch.float32, **kw)
        segs[impl, "f32"] = pred32.predict_scans(vol)
        check_card_vs_cpu(pred32, f"{net} {impl}")
        del pred32
    held_agreement(f"{net}: f32 fused vs f32 plain", segs["fused", "f32"], segs["plain", "f32"],
                   0.999)
    for impl in ("plain", "fused"):
        held_agreement(f"{net}: bf16 {impl} vs f32 plain", segs[impl, "bf16"],
                       segs["plain", "f32"], 0.9)


def drive_zoo(card):
    """One bf16 batch of every other model of the registry on duke, module
    path: shape, dtype, class range, launch counts from the config, ms."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor

    H, W = get_geometry(DB).prep_hw
    vol = np.random.default_rng(SEED).integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    xb = torch.from_numpy(vol).cuda()
    for net in ("stc_tb", "stc_st", "stc_sb", "gtc_tt", "cnnu", "pnnu", "vitu"):
        pred = load_predictor(DB, net=net, batch_size=BATCH, dtype=torch.bfloat16,
                              device="cuda", seed=SEED)
        seg, counts = serve_checked(pred, vol, net)
        eager, graph, peak = batch_times(pred, xb, 5)
        n_par = sum(p.numel() for p in pred.model.parameters()) / 1e6
        print(f"zoo [{card}]: {net} ({n_par:.2f} M parameters) duke bf16 batch {BATCH}: classes "
              f"{np.unique(seg).tolist()}, launches {counts}, {eager:.3f} ms eager, {graph:.3f} ms "
              f"replayed ({BATCH / graph * 1e3:.1f} B-scans/s), peak {peak:.2f} GiB", flush=True)
        del pred


def drive_buckets(card):
    """One bf16 batch of stc_tt in every other dataset bucket, CNN branch
    plain and fused: the same checks; the two bf16 class maps agree on more
    than 90 % of pixels (they differ by bf16 roundings); ms per batch."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor

    for db in ("heg", "duke2", "hcms", "goals", "odsgh"):
        H, W = get_geometry(db).prep_hw
        vol = np.random.default_rng(SEED).integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
        xb = torch.from_numpy(vol).cuda()
        segs, line = {}, []
        for impl in ("plain", "fused"):
            pred = load_predictor(db, cnn_impl=impl, batch_size=BATCH, dtype=torch.bfloat16,
                                  device="cuda", seed=SEED)
            segs[impl], counts = serve_checked(pred, vol, f"{db} {impl}")
            eager, graph, peak = batch_times(pred, xb, 5)
            line.append(f"{impl}: launches {counts}, {eager:.3f} ms eager, {graph:.3f} ms "
                        f"replayed ({BATCH / graph * 1e3:.1f} B-scans/s), peak {peak:.2f} GiB")
            if impl == "plain":
                no_site = maps_without_site(pred, vol, f"{db} bf16")
            del pred
        held_agreement(f"bucket {db}: bf16 maps with vs without the site", segs["plain"],
                       no_site, 0.999)
        pred32 = load_predictor(db, batch_size=BATCH, dtype=torch.float32, device="cuda",
                                seed=SEED)
        held_agreement(f"bucket {db}: f32 maps with vs without the site",
                       pred32.predict_scans(vol), maps_without_site(pred32, vol, f"{db} f32"),
                       0.99999)
        del pred32
        print(f"bucket [{card}]: {db} {H}x{W} stc_tt bf16 batch {BATCH}: " + "; ".join(line),
              flush=True)
        held_agreement(f"bucket {db}: bf16 fused vs bf16 plain", segs["fused"], segs["plain"], 0.9)


# kernel-name substrings -> the port's layer that launched them (first match)
_GROUPS = (
    ("fused CrossCNN block kernel (K4)", ("crosscnn_fused",)),
    ("metapool kernels (K1, K1b, the site)", ("metapool_kernel",)),
    ("dwconv3x3 kernels (K2, K2b)", ("dwconv3x3_fwd", "dwconv3x3_bwd_kernel",
                                     "dw_finalize_kernel")),
    ("train BN forward kernels (K3)", ("bn_stats_kernel", "bn_finalize_kernel", "bn_norm_kernel",
                                       "bn_act_fwd_kernel")),
    ("train BN backward kernel (K3b)", ("bn_act_bwd_kernel",)),
    ("layer_norm", ("layer_norm",)),
    ("bilinear upsample backward", ("upsample_bilinear2d_backward",)),
    ("bilinear upsample", ("upsample",)),
    ("max_pool", ("max_pool",)),
    ("sort (polarization bins)", ("sort", "radix")),
    ("index_add (polarization bins)", ("index_add", "indexfunclargeindex",
                                       "indexfuncsmallindex")),
    ("index_select / gather / scatter", ("index", "scatter", "gather")),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("cuDNN conv", ("conv", "implicit_gemm", "nhwc", "winograd", "dgrad", "wgrad", "fprop",
                    "cudnn")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("elementwise and copies", ("elementwise", "copy", "cat", "fill")),
    ("memcpy / memset", ("memcpy", "memset")),
)


def _group_of(kernel_name: str) -> str:
    low = kernel_name.lower()
    return next((name for name, subs in _GROUPS if any(s in low for s in subs)), "other")


def profile_device(fn, wall_ms: float, what: str, counts=None):
    """Device time of one call of ``fn`` by kernel, grouped by layer, and the
    device's busy share of ``wall_ms``, the call's time without the
    profiler.  Returns the ms by group (empty if none was recorded) and
    puts the launches by group into ``counts`` if a dict is given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"profile: {what}: no device time recorded (not measured)", flush=True)
        return {}
    groups = Counter()
    launches = Counter()
    for t, n, key in rows:
        g = _group_of(key)
        groups[g] += t
        launches[g] += n
    if counts is not None:
        counts.update(launches)
    print(f"profile: {what}: {sum(r[1] for r in rows)} kernels, device busy "
          f"{busy:.3f} ms = {busy / wall_ms * 100:.1f}% of {wall_ms:.3f} ms "
          f"(idle share {max(0.0, 1 - busy / wall_ms) * 100:.1f}%)", flush=True)
    for g, t in groups.most_common():
        print(f"  {t:8.3f} ms {t / busy * 100:5.1f}%  x{launches[g]:<5d} {g}", flush=True)
    print("profile: top kernels:", flush=True)
    for t, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {t:8.3f} ms {t / busy * 100:5.1f}%  x{n:<5d} {key[:100]}", flush=True)
    return dict(groups)


def banded_batch(n: int, hw, n_class: int, seed: int):
    """A seeded uint8 batch of layered scans: per column, n_class - 1
    boundaries at seeded depths (a random start, seeded gaps of 5-15 % of
    the height, a seeded sine), class k between boundaries k and k+1, and
    an image that is each class's grey level plus noise.  Every class
    covers at least 5 % of each column."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = hw
    start = rng.uniform(0.1 * H, 0.25 * H, (n, 1, 1))
    gaps = rng.uniform(0.05 * H, 0.15 * H, (n, n_class - 1, 1))
    cols = np.arange(W)[None, None, :]
    wave = 0.05 * H * np.sin(2 * np.pi * cols / W * rng.uniform(0.5, 2.0, (n, 1, 1))
                             + rng.uniform(0, 2 * np.pi, (n, 1, 1)))
    bounds = start + np.cumsum(gaps, axis=1) - gaps[:, :1] + wave  # [n, n_class-1, W]
    rows = np.arange(H)[None, :, None, None]
    labs = (rows >= bounds[:, None, :, :].transpose(0, 1, 3, 2)).sum(-1).astype(np.uint8)
    grey = np.linspace(40, 220, n_class)[labs]
    imgs = np.clip(grey[..., None] + rng.normal(0, 20, (n, H, W, 3)), 0, 255).astype(np.uint8)
    return imgs, labs


TRAIN_BATCH, TRAIN_HW, TRAIN_NC, TRAIN_STEPS, LR = 8, (256, 256), 5, 5, 1e-4


def drive_train(report, card, train_counts):
    """The train slice at full width: RegNet(stc_tt, 'train'), bf16, batch 8
    at 256x256, DropPath 0.1, random boundary-loss noise, constant lr 1e-4,
    5 steps.  The launch counts are read around the first step and held
    against the config; every loss must be finite."""
    import numpy as np
    import torch

    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights
    from tcct_tpu_torch.train import TrainConfig, build_train_step, make_optimizer

    model = RegNet(get_model("stc_tt", TRAIN_NC, variant="train", drop_path_rate=0.1),
                   out_channels=TRAIN_NC)
    init_weights(model, torch.Generator().manual_seed(SEED))
    cfg = TrainConfig(crop_hw=TRAIN_HW, n_class=TRAIN_NC, ds=True, udh=True, reg=True,
                      augment=False, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = build_train_step(model, make_optimizer(1, lr=LR), cfg, device="cuda", generator=gen)
    imgs, labs = banded_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_NC, SEED)
    print(f"train: classes cover {np.bincount(labs.ravel(), minlength=TRAIN_NC).tolist()} pixels",
          flush=True)

    times = []
    for i in range(TRAIN_STEPS):
        if i == 0:
            reset_counters()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _ = step(imgs, labs)
        vals = {k: float(v) for k, v in metrics.items()}  # one host read ends the step
        times.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = read_counters()
        print(f"train: step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in vals.items())
              + f" ({times[-1]:.2f} ms)", flush=True)
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"train step {i}: non-finite loss {vals}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train: launches in one step: {counts}", flush=True)
    for k, want in train_counts.items():
        if counts[k] == 0:
            fail(f"kernel {k} was not launched on the train path")
    for k, n in counts.items():  # the inference-only fused block kernel: 0
        if n != train_counts.get(k, 0):
            fail(f"kernel {k}: {n} launches in one train step, expected {train_counts.get(k, 0)}")
    for e in report["kernels"]:
        if e["name"] in report["per_batch_launches"]:
            e["train_launches"] = counts[e["name"]]
        elif e["name"] in train_counts:
            e["launches"] = counts[e["name"]]
    steady = float(np.mean(times[2:]))
    print(f"train [{card}]: bf16 batch {TRAIN_BATCH} at {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"steady state {steady:.2f} ms/step (mean of steps 2-{TRAIN_STEPS - 1}; "
          f"step 0 {times[0]:.1f} ms, step 1 {times[1]:.1f} ms), "
          f"{TRAIN_BATCH / steady * 1e3:.1f} B-scans/s; peak device memory {peak:.2f} GiB",
          flush=True)
    report["stc_tt_step"] = (steady, profile_train_step(lambda: step(imgs, labs), steady, card))
    off, worst, n = train_repeat(cfg, imgs, labs)
    print(f"train: one step twice from one state and one generator: {n - len(off)} of {n} "
          f"tensors bitwise equal", flush=True)
    if off:
        fail(f"train step does not repeat: {len(off)} of {n} tensors differ, by up to "
             f"{worst:.3e} ({', '.join(off[:8])} ...)")


# (label, module, attribute) of the functions whose device time a train
# profile names apart; an attribute the tree lacks is skipped
# (label, the op whose calls it names, module, function wrapped in a range
# of the label where the module has it): a tree whose kernels are tcct::
# ops is labelled by the ops' own profiler ranges, an older one (``--profile
# DIR`` on a parent) by its autograd.Functions
_TRAIN_LABELS = (
    ("K3 forward (bn_act_train)", "tcct::bn_act_train", "tcct_tpu_torch.ops.kernels.bnstats",
     "_BNActTrain.forward"),
    ("train BN backward", "tcct::bn_act_train_backward", "tcct_tpu_torch.ops.kernels.bnstats",
     "_BNActTrain.backward"),
    ("polarization bins, forward", None, "tcct_tpu_torch.losses.polar", "points_selection_bins"),
    ("bilinear backward (adjoint)", None, "tcct_tpu_torch.ops.resize",
     "_ResizeBilinear.backward"),
    ("depthwise backward (K2b and the passes around it)", "tcct::dwconv3x3_backward",
     "tcct_tpu_torch.ops.kernels.dwconv", "_DWConv3x3.backward"),
)


def _wrap_labels():
    """Wrap each function of _TRAIN_LABELS in a profiler range of its label;
    returns the undo list."""
    import importlib

    from torch.profiler import record_function

    undo = []
    for label, _, mod_name, path in _TRAIN_LABELS:
        obj = importlib.import_module(mod_name)
        *outer, attr = path.split(".")
        for name in outer:
            obj = getattr(obj, name, None)
        if obj is None or not hasattr(obj, attr):
            continue
        raw = obj.__dict__[attr] if isinstance(obj, type) else getattr(obj, attr)
        fn = raw.__func__ if isinstance(raw, staticmethod) else raw

        def wrapped(*a, _fn=fn, _label=label, **k):
            with record_function(_label):
                return _fn(*a, **k)

        setattr(obj, attr, staticmethod(wrapped) if isinstance(raw, staticmethod) else wrapped)
        undo.append((obj, attr, raw))
    return undo


def profile_train_step(fn, wall_ms: float, card: str):
    """Device time of one train step by group: the ranges of _TRAIN_LABELS
    (every kernel launched inside one, whatever its name), then the other
    kernels by name (_GROUPS); the step's launch count and idle share.
    Returns {group: (ms, launches)}, empty if the profiler saw no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = {label for label, _, _, _ in _TRAIN_LABELS}
    ranges = {label: label for label in labels}  # a range's name -> its label
    ranges.update({op: label for label, op, _, _ in _TRAIN_LABELS if op})
    undo = _wrap_labels()
    try:
        fn()  # warm: a first call through the wrappers
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for obj, attr, raw in undo:
            setattr(obj, attr, raw)
    # every kernel by name; those launched by an op inside a labelled range
    # go to the label, the rest to the name's group (the port's own kernels,
    # launched through ctypes and not by an op, are found by name)
    by_name_ms, by_name_n = Counter(), Counter()
    ms, n = Counter(), Counter()
    inside = {label: Counter() for label in labels}
    inside_n = {label: Counter() for label in labels}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False) or ev.name in labels:
                continue  # the ranges' own marks on the device timeline
            by_name_ms[ev.name] += ev.time_range.elapsed_us() / 1e3
            by_name_n[ev.name] += 1
        elif ev.device_type == DeviceType.CPU and ev.kernels:
            up = ev
            while up is not None and up.name not in ranges:
                up = up.cpu_parent
            if up is None:
                continue
            label = ranges[up.name]
            for k in ev.kernels:
                ms[label] += k.duration / 1e3
                n[label] += 1
                inside[label][_group_of(k.name)] += k.duration / 1e3
                inside_n[label][_group_of(k.name)] += 1
                by_name_ms[k.name] -= k.duration / 1e3
                by_name_n[k.name] -= 1
    for name, t in by_name_ms.items():
        if by_name_n[name] > 0:
            ms[_group_of(name)] += t
            n[_group_of(name)] += by_name_n[name]
    busy = sum(ms.values())
    if busy == 0:
        print("train profile: no device time recorded (not measured)", flush=True)
        return {}
    print(f"train profile [{card}]: one bf16 step: {sum(n.values())} kernel launches, device busy "
          f"{busy:.3f} ms = "
          f"{busy / wall_ms * 100:.1f}% of {wall_ms:.3f} ms/step "
          f"(idle share {max(0.0, 1 - busy / wall_ms) * 100:.1f}%)", flush=True)
    for g, t in ms.most_common():
        within = ", ".join(f"{k} {v:.3f} (x{inside_n[g][k]})"
                           for k, v in inside.get(g, Counter()).most_common(4))
        print(f"  {t:8.3f} ms {t / busy * 100:5.1f}%  x{n[g]:<5d} {g}"
              + (f" (by kernel group: {within})" if within else ""), flush=True)
    rest = sorted(((t, name) for name, t in by_name_ms.items() if by_name_n[name] > 0),
                  reverse=True)
    print("train profile: top kernels outside the named ranges:", flush=True)
    for t, name in rest[:10]:
        print(f"  {t:8.3f} ms  x{by_name_n[name]:<5d} {name[:110]}", flush=True)
    return {g: (ms[g], n[g]) for g in ms}


def train_repeat(cfg, imgs, labs, deterministic_cudnn: bool = False, name: str = "stc_tt",
                 allow_tf32=(True, True)):
    """One bf16 step of a fresh seeded ``name`` model twice, from one state
    and one generator, the two runs with cuDNN's TF32 as ``allow_tf32``
    says: (names of the state tensors that differ, max abs difference,
    tensor count)."""
    import torch

    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights
    from tcct_tpu_torch.train import build_train_step, make_optimizer

    ends = []
    for tf32 in allow_tf32:
        m = RegNet(get_model(name, TRAIN_NC, variant="train", drop_path_rate=0.1),
                   out_channels=TRAIN_NC)
        init_weights(m, torch.Generator().manual_seed(SEED))
        g = torch.Generator(device="cuda").manual_seed(SEED)
        step = build_train_step(m, make_optimizer(1, lr=LR), cfg, device="cuda", generator=g)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=deterministic_cudnn, allow_tf32=tf32):
            step(imgs, labs)
        ends.append({k: v.detach().clone() for k, v in m.state_dict().items()})
    off = [k for k in ends[0] if not torch.equal(ends[0][k], ends[1][k])]
    worst = max((float((ends[0][k].double() - ends[1][k].double()).abs().max()) for k in off),
                default=0.0)
    return off, worst, len(ends[0])


def _summary(names) -> str:
    """State-dict names counted by their first two components."""
    c = Counter(".".join(k.split(".")[:2]) for k in names)
    return ", ".join(f"{k} {v}" for k, v in sorted(c.items()))


def train_diagnostics(card: str) -> None:
    """The train step's diagnostics, printed and not held, for the tree on
    ``sys.path`` (this checkout or another's, ``--profile DIR``, second half):
    ms/step over 5 steps, the device profile of one step by group, the ops
    that ``torch.use_deterministic_algorithms`` names in one step, and
    which state tensors differ when one step runs twice from one state,
    with cuDNN as it is and with ``cudnn.deterministic``."""
    import warnings

    import numpy as np
    import torch

    import tcct_tpu_torch
    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights
    from tcct_tpu_torch.train import TrainConfig, build_train_step, make_optimizer

    print(f"train diagnostics: package {os.path.dirname(tcct_tpu_torch.__file__)}", flush=True)
    model = RegNet(get_model("stc_tt", TRAIN_NC, variant="train", drop_path_rate=0.1),
                   out_channels=TRAIN_NC)
    init_weights(model, torch.Generator().manual_seed(SEED))
    cfg = TrainConfig(crop_hw=TRAIN_HW, n_class=TRAIN_NC, ds=True, udh=True, reg=True,
                      augment=False, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = build_train_step(model, make_optimizer(1, lr=LR), cfg, device="cuda", generator=gen)
    imgs, labs = banded_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_NC, SEED)
    times = []
    for _ in range(TRAIN_STEPS + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _ = step(imgs, labs)
        float(metrics["total"])
        times.append((time.perf_counter() - t0) * 1e3)
    steady = float(np.mean(times[3:]))
    print(f"train diagnostics [{card}]: {steady:.2f} ms/step (mean of steps 3-{len(times) - 1}: "
          + ", ".join(f"{t:.1f}" for t in times[3:]) + ")", flush=True)
    profile_train_step(lambda: step(imgs, labs), steady, card)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(imgs, labs)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    named = Counter(str(w.message).split(" does not have")[0].strip()
                    for w in caught if "deterministic" in str(w.message))
    print(f"train diagnostics: ops named by use_deterministic_algorithms in one step: "
          f"{dict(named) or 'none'}", flush=True)
    for det, flag in ((False, False), (True, False), (False, True)):
        if flag:
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            off, worst, n = train_repeat(cfg, imgs, labs, det)
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"train diagnostics: one step twice, cudnn.deterministic={det}, "
              f"use_deterministic_algorithms={flag}: {len(off)} of {n} tensors differ (max abs "
              f"difference {worst:.3e}): {_summary(off) or '-'}", flush=True)


def dispatch_diagnostics(card: str) -> None:
    """``--profile DIR``, last: the host's CPU us a call of each kernel
    wrapper of the tree on ``sys.path`` at a small bf16 shape (a few us of
    device work, so the host sets the pace): the forward under ``no_grad``,
    and the forward with the backward through ``torch.autograd.grad``.  Read
    parent against change for what the op dispatch costs a call."""
    import torch

    from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train
    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3
    from tcct_tpu_torch.ops.kernels.metapool import metapool_block, metapool_tokens

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    xm, xd, wd = rand(8, 64, 32), rand(8, 16, 16, 32), rand(3, 3, 32)
    xb = rand(8, 32, 16, 16).contiguous(memory_format=torch.channels_last)
    wb, bb = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
    ln = [rand(32) for _ in range(4)]
    cases = [("metapool_tokens", lambda *a: metapool_tokens(*a), (xm,)),
             ("metapool_block", lambda x: metapool_block(x, *ln)[0], (xm,)),
             ("dwconv3x3 s1", lambda x, w: dwconv3x3(x, w, 1), (xd, wd)),
             ("dwconv3x3 s2", lambda x, w: dwconv3x3(x, w, 2), (xd, wd)),
             ("bn_act_train", lambda x, w, b: bn_act_train(x, w, b, 1e-5, True)[0], (xb, wb, bb))]

    def host_us(fn, n=1000, windows=5):
        """The calling thread's CPU time a call, the least of a few windows:
        the machine's cores are shared, and wall time on them swings by 2x
        between turns."""
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        best = math.inf
        for _ in range(windows):
            t0 = time.thread_time()
            for _ in range(n):
                fn()
            best = min(best, time.thread_time() - t0)
            torch.cuda.synchronize()
        return best / n * 1e6

    cells = []
    for name, f, args in cases:
        with torch.no_grad():
            fwd = host_us(lambda: f(*args))
        cell = f"{name} {fwd:.2f}"
        if name != "metapool_block":  # the site has no backward
            req = [a.detach().clone().requires_grad_() for a in args]
            gy = torch.ones_like(f(*args))
            both = host_us(lambda: torch.autograd.grad(f(*req), req, gy))
            cell += f" / {both:.2f}"
        cells.append(cell)
    print(f"dispatch [{card}]: host CPU us a call (the thread's, least of 5 windows of "
          "1000), forward / forward + backward (small bf16 shapes): " + "; ".join(cells),
          flush=True)


GOLDENS = {"train_parity": "stc_tt", "train_parity_gtc": "gtc_tt"}


def _golden(fixture: str):
    """(golden arrays, sd0, model name, TrainConfig) of a train-parity
    golden: pinned boundary noise; for gtc_tt the pinned alpha maps and the
    edge-pixel loss, as tests/test_train_parity.py runs it."""
    import numpy as np

    from tcct_tpu_torch.train import TrainConfig

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                             fixture + ".npz"))
    sd0 = {k[len("sd0::"):]: g[k] for k in g.files if k.startswith("sd0::")}
    gated = fixture.endswith("_gtc")
    cfg = TrainConfig(n_class=5, crop_hw=(64, 64), ds=True, udh=True, reg=True, epl=gated,
                      augment=False, pinned_reg_noise=True, pinned_gate_noise=gated)
    return g, sd0, GOLDENS[fixture], cfg


def _port_slice(sd0, device, name="stc_tt"):
    import torch

    from tcct_tpu_torch.models import RegNet, get_model

    m = RegNet(get_model(name, 5, variant="train", drop_path_rate=0.0), out_channels=5)
    m.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd0.items()}, strict=True)
    return m.to(device=device, memory_format=torch.channels_last)


def check_train_f32_card_vs_cpu(fixture: str = "train_parity") -> None:
    """The f32 train step on the card (kernels) against the CPU path (plain
    versions) on a golden 64x64 parity case (``train_parity``: stc_tt;
    ``train_parity_gtc``: gtc_tt): step-0 gradients per tensor
    within max(2e-3 |ref|, 2e-4 global norm) over > 280 tensors of the
    CPU's; then one clip + AdamW step: every parameter within 2.1 lr, at
    most 2 % of elements more than 5 % of lr apart, update L2 drift below
    0.5, BN statistics within rtol 1e-4 + atol 1e-5 (the bounds of
    tests/test_torch_train.py).  Printed beside, not held: the card against
    the reference's own gradients (the CPU path sits at 0.88 of the bound
    there on one tensor), against itself on a second run, and without cuDNN
    against the CPU."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.train import (
        build_loss_fn,
        build_train_step,
        make_optimizer,
        trainable_parameters,
    )

    g, sd0, name, cfg = _golden(fixture)
    imgs = np.ascontiguousarray(np.moveaxis(g["x_u8"], 1, -1))
    labs = g["labels"]
    tag = f"train f32 64x64 {name}"

    def step0(dev):
        m = _port_slice(sd0, dev, name).train()
        params = trainable_parameters(m)
        img = torch.from_numpy(imgs).to(dev).float() / 255.0
        true_oh = F.one_hot(torch.from_numpy(labs).to(dev).long(), 5).float()
        loss, _ = build_loss_fn(m, cfg)(params, dict(m.named_buffers()), img, true_oh)
        gr = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return float(loss.detach()), {k: (torch.zeros_like(p) if x is None else x).cpu().double()
                                      .numpy() for (k, p), x in zip(params.items(), gr)}

    (loss_cpu, cpu), (loss_card, card) = step0("cpu"), step0("cuda")
    print(f"{tag}: loss card {loss_card:.7f} CPU {loss_cpu:.7f}", flush=True)
    if abs(loss_card - loss_cpu) > 1e-5 * abs(loss_cpu):
        fail(f"f32 train loss card {loss_card} vs CPU {loss_cpu}")
    gnorm = np.sqrt(sum(float((g[k].astype(np.float64) ** 2).sum())
                        for k in g.files if k.startswith("grad0::")))

    def worst_ratio(mine, ref_of):
        worst, worst_k, n = 0.0, "", 0
        for key in g.files:
            if not key.startswith("grad0::") or key.endswith(("running_mean", "running_var")):
                continue
            k = key[len("grad0::"):]
            ref = np.asarray(ref_of(k), np.float64)
            ratio = np.linalg.norm(mine[k] - ref) / max(2e-3 * np.linalg.norm(ref), 2e-4 * gnorm)
            if ratio > worst:
                worst, worst_k = ratio, k
            n += 1
        return worst, worst_k, n

    worst, worst_k, n = worst_ratio(card, cpu.__getitem__)
    print(f"{tag}: card step-0 gradients vs CPU: {n} tensors, worst {worst:.4f} of the "
          f"bound ({worst_k})", flush=True)
    if worst > 1.0 or n <= 280:
        fail(f"f32 card gradients vs CPU: worst {worst} of the bound over {n} tensors")
    # printed, not held: where the gap comes from
    _, again = step0("cuda")
    with torch.backends.cudnn.flags(enabled=False):
        _, no_cudnn = step0("cuda")
    for what, mine, ref_of in (("card vs the reference's grad0", card, lambda k: g["grad0::" + k]),
                               ("card vs card, a second run", again, card.__getitem__),
                               ("card without cuDNN vs CPU", no_cudnn, cpu.__getitem__)):
        worst, worst_k, n = worst_ratio(mine, ref_of)
        print(f"{tag}: {what}: worst {worst:.4f} of the bound ({worst_k})", flush=True)

    sds = {}
    for dev in ("cpu", "cuda"):
        m = _port_slice(sd0, dev, name)
        step = build_train_step(m, make_optimizer(1, lr=LR, weight_decay=2e-4), cfg, dev)
        step(imgs, labs)
        sds[dev] = {k: v.cpu().double().numpy() for k, v in m.state_dict().items()}
        names = set(trainable_parameters(m))
    moved2 = drift2 = 0.0
    n_el = n_off = 0
    for k, ref in sds["cpu"].items():
        mine = sds["cuda"][k]
        if "running" in k:
            if not np.all(np.abs(mine - ref) <= 1e-5 + 1e-4 * np.abs(ref)):
                fail(f"f32 one step: BN statistics {k} card vs CPU")
            continue
        if k not in names:
            continue
        diff = np.abs(mine - ref)
        if diff.max() > 2.1 * LR:
            fail(f"f32 one step: {k} moved {diff.max()} apart")
        n_el += diff.size
        n_off += int((diff > 0.05 * LR).sum())
        moved2 += float(((ref - sd0[k]) ** 2).sum())
        drift2 += float(((mine - ref) ** 2).sum())
    drift = np.sqrt(drift2 / moved2)
    print(f"{tag}: one step card vs CPU: {n_off} of {n_el} elements more than "
          f"5% of lr apart, update L2 drift {drift:.4f}", flush=True)
    if n_off > 0.02 * n_el or drift >= 0.5:
        fail(f"f32 one step card vs CPU: {n_off}/{n_el} off, drift {drift}")


def check_train_trajectory(fixture: str = "train_parity") -> None:
    """The f32 train step on the card for 50 steps on a golden 64x64
    parity case (the golden ``sd0`` weights and batch, pinned boundary
    noise and, for gtc_tt, alpha maps, constant lr 1e-4, TF32 off), held at
    the bounds of
    tests/test_train_parity.py: step-0 loss within 5e-4 and every loss
    within 5e-3 of the reference's (relative), the final parameter L2
    within rtol 1e-5 of ``param_l2``, the drift from the reference's final
    weights below 0.5 of the distance they moved."""
    import numpy as np

    from tcct_tpu_torch.train import build_train_step, make_optimizer

    g, sd0, name, cfg = _golden(fixture)
    m = _port_slice(sd0, "cuda", name)
    step = build_train_step(m, make_optimizer(1, lr=LR, weight_decay=2e-4), cfg, "cuda")
    imgs = np.ascontiguousarray(np.moveaxis(g["x_u8"], 1, -1))
    t0 = time.perf_counter()
    losses = np.array([float(step(imgs, g["labels"])[0]["total"]) for _ in range(50)])
    wall = time.perf_counter() - t0
    ref = np.asarray(g["losses"][:50], np.float64)
    rel = np.abs(losses - ref) / np.abs(ref)
    final = {k: v.double().cpu().numpy() for k, v in m.state_dict().items()}
    l2 = np.sqrt(sum(float((v ** 2).sum()) for k, v in final.items()
                     if v.ndim > 0 and "running" not in k and "tracked" not in k))
    l2_rel = abs(l2 - float(g["param_l2"])) / float(g["param_l2"])
    moved2 = drift2 = 0.0
    for key in g.files:
        if key.startswith("sdN::"):
            k = key[len("sdN::"):]
            ref_final = g[key].astype(np.float64)
            moved2 += float(((ref_final - sd0[k].astype(np.float64)) ** 2).sum())
            drift2 += float(((final[k] - ref_final) ** 2).sum())
    drift = float(np.sqrt(drift2 / moved2))
    print(f"train f32 64x64 {name}, 50 steps on the card: loss rel. error step 0 {rel[0]:.3e} "
          f"(bound 5e-4), max {rel.max():.3e} at step {int(rel.argmax())} (bound 5e-3); param L2 "
          f"{l2:.6f} vs {float(g['param_l2']):.6f}, rel. {l2_rel:.3e} (bound 1e-5); drift "
          f"{drift:.4f} of the distance moved (bound 0.5); {wall:.2f} s", flush=True)
    if not (rel[0] < 5e-4 and rel.max() < 5e-3 and l2_rel <= 1e-5 and drift < 0.5):
        fail(f"{name}: the 50-step f32 trajectory on the card misses "
             "tests/test_train_parity.py's bounds")


# --- the training entry point: data, augmentation, engine, checkpoints, CLI ----------

ENGINE_DB, ENGINE_BATCH, ENGINE_CROP = "goals", 8, (256, 256)
ENGINE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_engine")


def _engine_model():
    from tcct_tpu_torch.models import RegNet, get_model

    return RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.1), out_channels=5)


def _engine_cfg(augment: bool = True):
    import torch

    from tcct_tpu_torch.train import TrainConfig

    return TrainConfig(n_class=5, crop_hw=ENGINE_CROP, ds=True, udh=True, reg=True,
                       augment=augment, dtype=torch.bfloat16)


def _state_tensors(tr):
    """Every tensor of a Trainer's state: parameters and buffers, AdamW's
    moments and count, and the generator's state."""
    import torch

    out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
    for name in ("mu", "nu"):
        out.update({f"{name}.{i}": t for i, t in enumerate(getattr(tr.state.optimizer, name))})
    out["optimizer.count"] = torch.tensor(tr.state.optimizer.count)
    out["generator"] = tr.state.generator.get_state()
    return out


def _png_bytes(arr) -> bytes:
    """A PNG file of an 8-bit [H, W] (grey) or [H, W, 3] (RGB) array, with
    the standard library's zlib: one IDAT, filter 0 on every row."""
    import struct
    import zlib

    import numpy as np

    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_goals_pngs(root: str, n: int = 16, hw=(800, 1100)) -> None:
    """``n`` goals-shaped scans (native 800x1100, layered, seeded) as
    ``<root>/goals/train_{img,lab}/*.png``, labels as class * 30."""
    import dataclasses

    from tcct_tpu_torch.data import get_geometry, synthesize_oct

    geo = dataclasses.replace(get_geometry(ENGINE_DB), prep_hw=hw)
    imgs, labs = synthesize_oct(geo, n, seed=SEED + 5)
    for sub in ("train_img", "train_lab"):
        os.makedirs(os.path.join(root, ENGINE_DB, sub), exist_ok=True)
    for i in range(n):
        for sub, arr in (("train_img", imgs[i][..., ::-1]), ("train_lab", labs[i] * 30)):
            with open(os.path.join(root, ENGINE_DB, sub, f"scan{i:02d}.png"), "wb") as f:
                f.write(_png_bytes(arr.copy()))


def _steps_ms(step, batches, n: int):
    """Host ms per step over ``n`` steps (``batches`` cycled), ended by a
    synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        step(*batches[i % len(batches)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def drive_engine(report, card, per_step, per_val_scan):
    """The training entry point on the card at the full width of stc_tt:
    ``EyeSet.load('goals')`` (synthetic, 608x512, 24 train and 8 val scans),
    ``Trainer`` with augmentation, bf16, ds + udh + reg, crop 256, batch 8,
    debug (12 steps an epoch), ``fit`` 2 epochs with val, the launch counts
    read around it; a resume from the epoch-0 checkpoint in a new Trainer,
    bit for bit the unbroken run; one augmented step twice from one state,
    bit for bit; the augmentation free of host syncs; one streaming epoch
    over 16 PNG files through the native loader; the CLI in a subprocess;
    the times, beside the card's name and power limit."""
    import shutil
    import warnings

    import torch

    from tcct_tpu_torch.data import EyeSet, apply_train, draw_train
    from tcct_tpu_torch.train import Trainer, build_train_step

    t_phase = time.perf_counter()
    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    os.makedirs(ENGINE_DIR)
    os.environ.pop("TCCT_DATA_ROOT", None)
    ds = EyeSet.load(ENGINE_DB)
    shapes = {k: v[0].shape for k, v in ds.splits.items()}
    print(f"engine: EyeSet.load({ENGINE_DB!r}): synthetic {ds.synthetic}, {shapes}, "
          f"oversample {ds.oversample}", flush=True)
    if not ds.synthetic or shapes["train"] != (24, 608, 512, 3) or shapes["val"][0] != 8:
        fail(f"engine: unexpected dataset {shapes}")
    cfg = _engine_cfg()

    def trainer(name):
        return Trainer(_engine_model(), ds, cfg, root=os.path.join(ENGINE_DIR, name),
                       bs=ENGINE_BATCH, device="cuda", debug=True)

    # run A: the fit, launches counted around it
    a = trainer("a")
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    logs = a.fit(epochs=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counters()
    lines = [json.loads(x) for x in open(os.path.join(a.root, "metrics.jsonl"))]
    print(f"engine: fit 2 epochs x {a.steps_per_epoch} steps + val ({fit_s:.2f} s): "
          + "; ".join(f"epoch {x['epoch']}: total {x['total']:.5f}, los {x['los']:.5f}, "
                      f"udh {x['udh']:.5f}, reg {x['reg']:.5f}, val_f1s {x['val_f1s']:.5f}"
                      for x in lines), flush=True)
    for x in lines:
        if not all(math.isfinite(x[k]) for k in ("total", "los", "udh", "reg", "los_epoch",
                                                 "val_f1s", "val_iou")):
            fail(f"engine: non-finite value in the fit's log {x}")
    if [x["epoch"] for x in lines] != [0, 1] or not math.isfinite(logs["val_f1s"]):
        fail(f"engine: the fit logged {lines}")
    steps, scans = 2 * a.steps_per_epoch, 2 * min(shapes["val"][0], 9)
    want = {k: steps * per_step.get(k, 0) + scans * per_val_scan.get(k, 0) for k in counts}
    print(f"engine: launches in the fit ({steps} steps, {scans} val scans): {counts}; from the "
          f"per-step and per-scan tables: {want}", flush=True)
    for k in list(per_step) + list(per_val_scan):
        if counts[k] == 0:
            fail(f"kernel {k} was not launched by the engine's fit")
    for e in report["kernels"]:
        e["engine_launches"] = counts[e["name"]]

    # run B: epoch 0, a checkpoint, a new Trainer that resumes and fits epoch 1
    b = trainer("b")
    b.fit(epochs=1)
    del b
    b = trainer("b")
    if not b.resume("last") or b.state.epoch != 1:
        fail("engine: resume from the epoch-0 checkpoint failed")
    b.fit(epochs=2)
    ta, tb = _state_tensors(a), _state_tensors(b)
    off = [k for k in ta if k not in tb or not torch.equal(ta[k], tb[k])]
    print(f"engine: resume: {len(ta) - len(off)} of {len(ta)} state tensors (parameters, buffers, "
          f"moments, count, generator) bitwise equal to the unbroken run", flush=True)
    if off or ta.keys() != tb.keys():
        fail(f"engine: resume is not bitwise: {len(off)} tensors differ ({', '.join(off[:8])})")
    del b

    # one augmented step twice from one state and one generator
    imgs, labs = ds.splits["train"][0][:ENGINE_BATCH], ds.splits["train"][1][:ENGINE_BATCH]
    off, worst, n = train_repeat(cfg, imgs, labs)
    print(f"engine: one augmented bf16 step twice from one state and one generator: "
          f"{n - len(off)} of {n} tensors bitwise equal", flush=True)
    if off:
        fail(f"augmented train step does not repeat: {len(off)} of {n} tensors differ, by up "
             f"to {worst:.3e} ({', '.join(off[:8])} ...)")

    # the augmentation: no host sync, its launches and device time
    d_imgs, d_labs = a._dev["train"]
    bi = torch.arange(ENGINE_BATCH, device="cuda")
    xb, yb = d_imgs.index_select(0, bi), d_labs.index_select(0, bi)
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def augment():
        return apply_train(xb, yb, draw_train(yb, gen, ENGINE_CROP), ENGINE_CROP)

    augment()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            augment()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    if syncs:
        fail(f"the augmentation synchronises with the host at {syncs}")
    aug_host_ms = _steps_ms(lambda: augment(), [()], 20)
    aug_launches = Counter()
    aug_groups = profile_device(augment, aug_host_ms, f"the augmentation of one bf16 batch of "
                                f"{ENGINE_BATCH} at 608x512 -> {ENGINE_CROP[0]}x{ENGINE_CROP[1]}",
                                aug_launches)
    aug_ms = sum(aug_groups.values())

    # eager ms/step with and without augmentation, in turns, on run A's model
    plain_step = build_train_step(a.model, a.state.optimizer, _engine_cfg(augment=False),
                                  "cuda", a.state.generator)
    crops = [(d_imgs[i:i + ENGINE_BATCH, :ENGINE_CROP[0], :ENGINE_CROP[1]].contiguous(),
              d_labs[i:i + ENGINE_BATCH, :ENGINE_CROP[0], :ENGINE_CROP[1]].contiguous())
             for i in (0, 8, 16)]
    full = [(d_imgs[i:i + ENGINE_BATCH], d_labs[i:i + ENGINE_BATCH]) for i in (0, 8, 16)]
    turns = {"with": [], "without": []}
    for order in (("with", "without"), ("without", "with"), ("with", "without"),
                  ("without", "with")):
        for k in order:
            turns[k].append(_steps_ms(a.train_step if k == "with" else plain_step,
                                      full if k == "with" else crops, 3))
    with_busy = Counter()
    profile_device(lambda: a.train_step(*full[0]), min(turns["with"]),
                   "one augmented bf16 train step", with_busy)
    without_busy = Counter()
    profile_device(lambda: plain_step(*crops[0]), min(turns["without"]),
                   "one bf16 train step without augmentation", without_busy)

    # the val pass and an epoch's wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.val(epoch=5)
    val_ms = (time.perf_counter() - t0) * 1e3 / min(shapes["val"][0], 9)
    t0 = time.perf_counter()
    a.train_epoch(epoch=5)
    epoch_s = time.perf_counter() - t0
    del a

    # streaming: 16 PNG files through the native loader
    t0 = time.perf_counter()
    data_root = os.path.join(ENGINE_DIR, "data")
    write_goals_pngs(data_root)
    disk = EyeSet.load(ENGINE_DB, root=data_root)
    if disk.synthetic or disk.splits["train"][0].shape != (16, 608, 512, 3):
        fail(f"engine: the PNG folder loaded as {disk.splits['train'][0].shape}")
    print(f"engine: 16 PNG scans (800x1100, native goals size) written and loaded natively in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    s = Trainer(_engine_model(), disk, cfg, root=os.path.join(ENGINE_DIR, "s"),
                bs=ENGINE_BATCH, device="cuda", debug=True, streaming=True)
    out = s.train_epoch_streaming(0)
    if not all(math.isfinite(out[k]) for k in ("total", "los", "udh", "reg")):
        fail(f"engine: streaming epoch {out}")
    print(f"engine [{card}]: streaming epoch, {s.steps_per_epoch} batches of {ENGINE_BATCH}: "
          f"decode {out['stream_decode_mb_s']} MB/s ({out['stream_decode_s']} s in the "
          f"producer, {out['stream_io_scans_per_s']} scans/s), stall {out['stream_stall_s']} s, "
          f"compute {out['stream_compute_s']} s; total {out['total']:.5f}", flush=True)
    del s

    # the CLI in a subprocess
    cli_root = os.path.join(ENGINE_DIR, "cli")
    cmd = [sys.executable, "-m", "tcct_tpu_torch.cli.main", "--db", ENGINE_DB, "--bug", "true",
           "--bs", str(ENGINE_BATCH), "--ds", "true", "--udh", "true", "--reg", "true",
           "--root", cli_root]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"engine: the CLI exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")
    path = os.path.join(cli_root, "metrics.jsonl")
    cli_lines = [json.loads(x) for x in open(path)] if os.path.exists(path) else []
    if not cli_lines or not math.isfinite(cli_lines[-1].get("total", float("nan"))):
        fail(f"engine: the CLI wrote no metrics.jsonl line: {cli_lines}")
    print(f"engine: CLI {' '.join(cmd[1:])}: exit 0 in {cli_s:.2f} s, {len(cli_lines)} "
          f"metrics.jsonl line(s), total {cli_lines[-1]['total']:.5f}, val_f1s "
          f"{cli_lines[-1]['val_f1s']:.5f}", flush=True)

    w, wo = turns["with"], turns["without"]
    crop = f"{ENGINE_CROP[0]}x{ENGINE_CROP[1]}"
    print(f"engine [{card}]: eager ms/step, bf16 batch {ENGINE_BATCH}, in turns: with augmentation "
          f"(608x512 -> {crop}) {', '.join(f'{t:.2f}' for t in w)}; without ({crop} as it "
          f"comes) {', '.join(f'{t:.2f}' for t in wo)}; launches a step {sum(with_busy.values())} "
          f"with, {sum(without_busy.values())} without", flush=True)
    print(f"engine [{card}]: the augmentation: {sum(aug_launches.values())} launches, "
          f"{aug_ms:.4f} ms device busy, {aug_host_ms:.3f} ms host a batch; val "
          f"{val_ms:.2f} ms a scan (608x512, batch 1, bf16, metrics read once); an epoch of "
          f"{ENGINE_BATCH * 12} scans {epoch_s:.2f} s wall", flush=True)
    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    print(f"engine: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


# --- the rest of the zoo: gtc_tt training, one step of every model, serving -----------

ZOO_STEPS = (("gtc_tb", "metapool"), ("stc_tb", "metapool"), ("stc_st", "metapool"),
             ("stc_sb", "metapool"), ("cnnu", "metapool"), ("pnnu", "metapool"),
             ("vitu", "metapool"), ("msca", "metapool"), ("tcct32", "metapool"),
             ("relay", "metapool"), ("stc_tt", "factor"), ("stc_tt", "hydra"),
             ("stc_tt", "metapool2d"))
ZOO_SERVE = (("msca", "infer", "metapool"), ("tcct32", "t32", "metapool"),
             ("relay", "infer", "metapool"), ("stc_tt", "infer", "factor"),
             ("stc_tt", "infer", "hydra"), ("stc_tt", "infer", "metapool2d"))


def _zoo_model(name: str, mixer: str = "metapool"):
    import torch

    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights

    variant = "t32" if name == "tcct32" else "train"
    m = RegNet(get_model(name, TRAIN_NC, variant=variant, drop_path_rate=0.1, mixer=mixer),
               out_channels=TRAIN_NC)
    init_weights(m, torch.Generator().manual_seed(SEED))
    return m


def step_tables():
    """``train_shapes`` of the bf16 stc_tt and gtc_tt train steps at full
    width (batch 8 at 256x256), and ``task2_bn_shapes`` of the f32 task-2
    res18 and res50 steps (batch 8 at 224x224)."""
    from tcct_tpu_torch.task2.model import ClsModel

    return (*(train_shapes(_zoo_model(name), TRAIN_BATCH, TRAIN_HW)
              for name in ("stc_tt", "gtc_tt")),
            tuple(task2_bn_shapes(ClsModel(net), T2_BATCH, T2_HW) for net in ("res18", "res50")))


def _counted_step(step, imgs, labs, want, what: str):
    """One step with the launch counts set to 0 just before and read just
    after, held to ``want``; finite losses.  Returns (metrics, counts, ms)."""
    import torch

    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    metrics, _ = step(imgs, labs)
    vals = {k: float(v) for k, v in metrics.items()}
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counters()
    if not all(math.isfinite(v) for v in vals.values()):
        fail(f"{what}: non-finite loss {vals}")
    for k, n in counts.items():
        if n != want.get(k, 0):
            fail(f"{what}: kernel {k}: {n} launches in one train step, expected "
                 f"{want.get(k, 0)}")
    return vals, counts, ms


def drive_gtc_train(report, card):
    """The slice's main path: gtc_tt training at full width.  One bf16 step
    (batch 8 at 256x256, drive_train's batch, DropPath 0.1, ds + udh + reg)
    with the launch counts read around it and held to ``train_launches``;
    the step's eager ms, device busy ms and launches under the CLI's
    settings for a bf16 run (PyTorch's defaults: cuDNN may use TF32), beside
    stc_tt's from ``drive_train`` (the gate and the f32 decoder after it);
    one augmented step (320x320 scans to 256x256 crops) run twice from one
    state and one generator, bit for bit; one step with cuDNN's TF32 off
    (this script's setting) and on, bit for bit (the promoted f32 convs
    pin their own precision); the f32 step against the CPU and the 50-step f32 trajectory on
    ``train_parity_gtc.npz``; a ``Trainer`` fit (synthetic goals 608x512,
    debug, 2 epochs of 3 steps with val) with its launches held to the
    per-step and per-scan tables, and a resume from the epoch-0 checkpoint
    bit for bit the unbroken run."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from tcct_tpu_torch.data import EyeSet
    from tcct_tpu_torch.train import TrainConfig, Trainer, build_train_step, make_optimizer

    t_phase = time.perf_counter()
    model = _zoo_model("gtc_tt")
    cfg = TrainConfig(crop_hw=TRAIN_HW, n_class=TRAIN_NC, ds=True, udh=True, reg=True,
                      augment=False, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = build_train_step(model, make_optimizer(1, lr=LR), cfg, device="cuda", generator=gen)
    imgs, labs = banded_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_NC, SEED)  # drive_train's batch
    per_step = train_launches(model)
    vals, counts, ms0 = _counted_step(step, imgs, labs, per_step, "gtc_tt train")
    print(f"gtc_tt train: step 0 ({ms0:.1f} ms): "
          + ", ".join(f"{k} {v:.6f}" for k, v in vals.items()), flush=True)
    print(f"gtc_tt train: launches in one step {counts} (the per-step table)", flush=True)
    for k, n in per_step.items():
        if n == 0:
            fail(f"gtc_tt train: kernel {k} is not on the path")
    for e in report["kernels"]:
        e["gtc_step_launches"] = counts[e["name"]]
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                    allow_tf32=True):  # the CLI's bf16 run: PyTorch's defaults
        times = [_steps_ms(step, [(imgs, labs)], 1) for _ in range(4)]
        steady = float(np.mean(times[1:]))
        groups = profile_train_step(lambda: step(imgs, labs), steady, card)
    stc_ms, stc_groups = report.get("stc_tt_step", (float("nan"), {}))
    busy = sum(t for t, _ in groups.values())
    stc_busy = sum(t for t, _ in stc_groups.values())
    print(f"gtc_tt train [{card}]: bf16 batch {TRAIN_BATCH} at 256x256, the CLI's settings: "
          f"{steady:.2f} ms/step "
          f"eager (steps 1-3: {', '.join(f'{t:.2f}' for t in times[1:])}); device busy "
          f"{busy:.3f} ms in {sum(n for _, n in groups.values())} launches; stc_tt on the same "
          f"batch in this run: {stc_ms:.2f} ms/step, busy {stc_busy:.3f} ms in "
          f"{sum(n for _, n in stc_groups.values())} launches", flush=True)
    for g in sorted(set(groups) | set(stc_groups)):
        a, b = groups.get(g, (0.0, 0)), stc_groups.get(g, (0.0, 0))
        print(f"  {a[0] - b[0]:+8.3f} ms {a[1] - b[1]:+6d} launches  gtc_tt - stc_tt: {g}",
              flush=True)
    # augmented (320x320 scans to 256x256 crops): the generator draws the crop, the gate, the
    # DropPath masks and the boundary noise
    big = banded_batch(TRAIN_BATCH, (320, 320), TRAIN_NC, SEED)
    off, worst, n = train_repeat(dataclasses.replace(cfg, augment=True), *big, name="gtc_tt")
    print(f"gtc_tt train: one augmented bf16 step twice from one state and one generator: "
          f"{n - len(off)} of {n} tensors bitwise equal", flush=True)
    if off:
        fail(f"gtc_tt step does not repeat: {len(off)} of {n} tensors differ, by up to "
             f"{worst:.3e} ({', '.join(off[:8])} ...)")
    off, worst, n = train_repeat(cfg, imgs, labs, name="gtc_tt", allow_tf32=(False, True))
    print(f"gtc_tt train: one bf16 step with cuDNN's TF32 off and on: {n - len(off)} of {n} "
          f"tensors bitwise equal", flush=True)
    if off:
        fail(f"gtc_tt step depends on cuDNN's TF32 setting: {len(off)} of {n} tensors differ, "
             f"by up to {worst:.3e} ({', '.join(off[:8])} ...)")
    check_train_f32_card_vs_cpu("train_parity_gtc")
    check_train_trajectory("train_parity_gtc")

    # a Trainer fit of gtc_tt with val, and a bitwise resume
    root = os.path.join(ENGINE_DIR, "gtc")
    shutil.rmtree(root, ignore_errors=True)
    os.environ.pop("TCCT_DATA_ROOT", None)
    ds = EyeSet.load(ENGINE_DB)
    ecfg = _engine_cfg()

    def trainer(sub):
        tr = Trainer(_zoo_model("gtc_tt"), ds, ecfg, root=os.path.join(root, sub),
                     bs=ENGINE_BATCH, device="cuda", debug=True)
        tr.steps_per_epoch = 3
        return tr

    a = trainer("a")
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    a.fit(epochs=2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counters()
    scans = 2 * min(ds.splits["val"][0].shape[0], 9)
    per_scan = expected_launches(a.model, 1, ds.splits["val"][0].shape[1:3], False)
    want = {k: 6 * per_step.get(k, 0) + scans * per_scan.get(k, 0) for k in counts}
    lines = [json.loads(x) for x in open(os.path.join(a.root, "metrics.jsonl"))]
    print(f"gtc_tt engine: fit 2 epochs x 3 steps + val ({fit_s:.2f} s): "
          + "; ".join(f"epoch {x['epoch']}: total {x['total']:.5f}, val_f1s {x['val_f1s']:.5f}"
                      for x in lines) + f"; launches {counts}", flush=True)
    if counts != want:
        fail(f"gtc_tt engine: launches {counts}, expected {want}")
    if [x["epoch"] for x in lines] != [0, 1] or not all(
            math.isfinite(x[k]) for x in lines for k in ("total", "los", "udh", "reg", "val_f1s")):
        fail(f"gtc_tt engine: the fit logged {lines}")
    b = trainer("b")
    b.fit(epochs=1)
    b = trainer("b")
    if not b.resume("last") or b.state.epoch != 1:
        fail("gtc_tt engine: resume from the epoch-0 checkpoint failed")
    b.fit(epochs=2)
    ta, tb = _state_tensors(a), _state_tensors(b)
    off = [k for k in ta if k not in tb or not torch.equal(ta[k], tb[k])]
    print(f"gtc_tt engine: resume: {len(ta) - len(off)} of {len(ta)} state tensors bitwise equal "
          f"to the unbroken run", flush=True)
    if off or ta.keys() != tb.keys():
        fail(f"gtc_tt engine: resume is not bitwise: {len(off)} tensors differ "
             f"({', '.join(off[:8])})")
    shutil.rmtree(root, ignore_errors=True)
    print(f"gtc_tt train: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def drive_zoo_steps(card):
    """One bf16 train step of every other model and mixer at full width
    (batch 8 at 256x256, DropPath 0.1, ds + udh + reg): finite losses and
    the launch counts of ``train_launches``; the step's ms."""
    import torch

    from tcct_tpu_torch.train import TrainConfig, build_train_step, make_optimizer

    t_phase = time.perf_counter()
    cfg = TrainConfig(crop_hw=TRAIN_HW, n_class=TRAIN_NC, ds=True, udh=True, reg=True,
                      augment=False, dtype=torch.bfloat16)
    imgs, labs = banded_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_NC, SEED)
    for name, mixer in ZOO_STEPS:
        model = _zoo_model(name, mixer)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        step = build_train_step(model, make_optimizer(1, lr=LR), cfg, device="cuda",
                                generator=gen)
        what = f"{name} ({mixer})" if name != "relay" else name
        vals, counts, ms0 = _counted_step(step, imgs, labs, train_launches(model), what)
        ms1 = _steps_ms(step, [(imgs, labs)], 1)
        n_par = sum(p.numel() for p in model.parameters()) / 1e6
        print(f"zoo train [{card}]: {what}, {n_par:.2f} M parameters, bf16 batch {TRAIN_BATCH} "
              f"at 256x256: total {vals['total']:.5f}, launches "
              f"{ {k: n for k, n in counts.items() if n} }, {ms0:.1f} ms first step, "
              f"{ms1:.2f} ms second", flush=True)
        del model, step
    print(f"zoo train: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


def drive_zoo_serving(card):
    """One duke serving batch (bf16, batch 8) of each model and mixer this
    slice adds, through ``load_predictor``, the launch counts held to
    ``expected_launches``; the f32 model on the card against the CPU path
    (``check_card_vs_cpu``); eager and replayed ms."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor

    t_phase = time.perf_counter()
    H, W = get_geometry(DB).prep_hw
    vol = np.random.default_rng(SEED).integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    xb = torch.from_numpy(vol).cuda()
    for name, variant, mixer in ZOO_SERVE:
        what = f"{name} {variant} ({mixer})" if name != "relay" else name
        kw = dict(net=name, variant=variant, mixer=mixer, batch_size=BATCH, device="cuda",
                  seed=SEED)
        pred = load_predictor(DB, dtype=torch.bfloat16, **kw)
        seg, counts = serve_checked(pred, vol, what)
        eager, graph, peak = batch_times(pred, xb, 5)
        print(f"zoo serving [{card}]: {what} duke bf16 batch {BATCH}: classes "
              f"{np.unique(seg).tolist()}, launches { {k: n for k, n in counts.items() if n} }, "
              f"{eager:.3f} ms eager, {graph:.3f} ms replayed "
              f"({BATCH / graph * 1e3:.1f} B-scans/s), peak {peak:.2f} GiB", flush=True)
        del pred
        pred32 = load_predictor(DB, dtype=torch.float32, **kw)
        check_card_vs_cpu(pred32, what)
        del pred32
    print(f"zoo serving: phase {time.perf_counter() - t_phase:.1f} s", flush=True)

T2_BATCH, T2_HW = 8, 224  # task 2: ResNet glaucoma classifier, f32, batch 8 at 224x224
T2_BNS = {"res18": 20, "res34": 36, "res50": 53}  # BatchNorms: K3 and K3b launches a step
T2_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_task2")


def task2_bn_shapes(model, batch: int, hw: int):
    """The train BatchNorm calls of one task-2 step of ``model`` (a
    ``ClsModel``) on [batch, 3, hw, hw] images, by NCHW input shape, read off
    its modules: one K3 and one K3b launch each."""
    def out(conv, h):
        return (h + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1

    c = Counter()
    h = out(model.conv1, hw)
    c[(batch, model.bn1.num_features, h, h)] += 1
    h = (h - 1) // 2 + 1  # the stem's 3x3/2 max-pool, pad 1
    for li in range(1, 5):
        for blk in getattr(model, f"layer{li}"):
            h_in = h
            for i in (1, 2, 3):
                conv = getattr(blk, f"conv{i}", None)
                if conv is not None:
                    h = out(conv, h)
                    c[(batch, getattr(blk, f"bn{i}").num_features, h, h)] += 1
            if blk.downsample is not None:
                hd = out(blk.downsample[0], h_in)
                c[(batch, blk.downsample[1].num_features, hd, hd)] += 1
    return c


def _task2_model(net: str):
    import torch

    from tcct_tpu_torch.task2.model import ClsModel, init_cls_weights

    return init_cls_weights(ClsModel(net), torch.Generator().manual_seed(SEED))


def _record_bn_calls(fn):
    """Run ``fn()`` with the inputs and outputs of every call of the K3 and
    K3b ops (``tcct::bn_act_train``, ``tcct::bn_act_train_backward``) kept
    (copies), seen by a dispatch mode: returns (fn's result, forward calls,
    backward calls)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    fwd_op = torch.ops.tcct.bn_act_train.default
    bwd_op = torch.ops.tcct.bn_act_train_backward.default
    fwd, bwd = [], []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is fwd_op:
                x, w, b, eps, leaky = args
                y, stats = out
                fwd.append(([t.detach().clone() for t in (x, w, b, y, stats[0], stats[1])],
                            eps, leaky))
            elif func is bwd_op:
                x, w, mean, var, gy, eps, leaky = args
                dx, dwb = out
                bwd.append(([t.detach().clone() for t in (x, w, mean, var, gy)],
                            [dx.clone(), dwb[0].clone(), dwb[1].clone()], eps, leaky))
            return out

    with Record():
        out = fn()
    return out, fwd, bwd


def check_bn_calls(fwd, bwd, what: str):
    """Each recorded K3 call against the plain statistics and normalize,
    each K3b call against the plain adjoint (``check_bn_backward``), at the
    bounds of ``kernel_tables``.  Returns the max abs errors of y and dx."""
    from tcct_tpu_torch.ops.kernels.bnstats import bn_normalize_reference, bn_stats_reference

    err_y = err_dx = 0.0
    for (x, w, b, y, mean, var), eps, leaky in fwd:
        name = f"{what} K3 {list(x.shape)}"
        rm, rv = bn_stats_reference(x, leaky)
        tf = x.float()
        check_within(name + " mean", mean, rm, 1e-5 * tf.abs().mean((0, 2, 3)) + 1e-7)
        check_within(name + " var", var, rv, 1e-5 * (tf * tf).mean((0, 2, 3)) + 1e-7)
        err_y = max(err_y, check_close(
            name, y, bn_normalize_reference(x, mean, var, w, b, eps, leaky), "float32"))
    for (x, w, mean, var, gy), got, eps, leaky in bwd:
        err_dx = max(err_dx, check_bn_backward(f"{what} K3b {list(x.shape)}", x, w, mean, var,
                                               gy, leaky, got))
    return err_y, err_dx


def _bn_autograd(x, weight, bias, eps, leaky):
    """Train BatchNorm by autograd in x's dtype (the f64 references of
    ``task2_card_vs_cpu`` and ``_f64_grads``): LeakyReLU(0.01) first with
    ``leaky``, then ``(x - mean) * inv + bias``, the batch mean and biased
    var."""
    import torch
    import torch.nn.functional as F

    if leaky:
        x = F.leaky_relu(x, 0.01)
    dims = (0, 2, 3)
    mean = x.mean(dims)
    var = (x * x).mean(dims) - mean * mean
    inv = torch.rsqrt(var + eps) * weight
    return ((x - mean[:, None, None]) * inv[:, None, None] + bias[:, None, None],
            mean.detach(), var.detach())


def task2_forward_backward(model, img, labels, masks, device, f64: bool = False):
    """One train-mode forward and backward of ``model`` on ``device`` at the
    NHWC images ``img``, with the dropout masks of ``masks`` (keyed by rate,
    drawn on the CPU where absent): (logits, loss, grads by name, new BN
    statistics by module name).  ``f64``: the model, the images and the
    BatchNorms (by autograd, :func:`_bn_autograd`) in f64, the reference."""
    import torch

    from tcct_tpu_torch.models import layers
    from tcct_tpu_torch.task2 import train as t2
    from tcct_tpu_torch.task2.model import Dropout

    cpu = torch.Generator().manual_seed(SEED + 40)
    raw, raw_bn = Dropout.draw, layers.bn_act_train
    Dropout.draw = lambda self, x, keep: masks.setdefault(
        self.rate, torch.rand(x.shape, generator=cpu) < keep).to(x.device)
    if f64:
        model, img = model.double(), img.double()
        layers.bn_act_train = _bn_autograd
    try:
        model.to(device=device, memory_format=torch.channels_last).train()
        params = dict(model.named_parameters())
        names = {m: n for n, m in model.named_modules()}
        with layers.full_f32_cudnn(deterministic=True):
            with layers.train_pass(model, None) as new_stats:
                logits = model(img.to(device).permute(0, 3, 1, 2))
            loss = t2.bce_on_softmax(logits, t2.one_hot(labels.to(device)).to(logits.dtype))
            grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        Dropout.draw, layers.bn_act_train = raw, raw_bn
    return (logits.detach().cpu(), loss.item(), {k: g.cpu() for k, g in zip(params, grads)},
            {names[m]: (a.cpu(), b.cpu()) for m, (a, b) in new_stats.items()})


def _grad_shares(got, ref):
    """Each gradient's distance from ``ref``'s over the CPU tests' bound,
    ``max(2e-3 |ref|, 2e-4 global norm)``: (worst name, its share)."""
    import torch

    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref.values())))
    shares = {k: float((got[k].double() - g.double()).norm())
              / max(2e-3 * float(g.double().norm()), 2e-4 * gnorm) for k, g in ref.items()}
    worst = max(shares, key=shares.get)
    return worst, shares[worst]


def task2_card_vs_cpu(start, batch: int, hw: int, card: str, truth: bool):
    """The res18 step's forward and backward on the card against the CPU
    from the state ``start``, one augmented batch (synthetic images, the
    draws made on the CPU) and one set of dropout masks: the augmentation
    within 1e-5, logits within 1e-4 + 1e-5 |ref|, BN statistics within 1e-5.
    Returns the worst gradients' shares of the bound: card vs CPU, and with
    ``truth`` card and CPU each against the step in f64."""
    import torch

    from tcct_tpu_torch.task2.data import (
        ClsDraws,
        apply_cls_train,
        draw_cls_train,
        synthesize_cls,
    )

    imgs_np, labels_np = synthesize_cls(batch, hw, SEED)
    draws = draw_cls_train(batch, torch.Generator().manual_seed(SEED + 41), "cpu")
    img_cpu = apply_cls_train(torch.from_numpy(imgs_np), draws, hw)
    img_gpu = apply_cls_train(torch.from_numpy(imgs_np).cuda(), ClsDraws(
        *(getattr(draws, f).cuda() for f in draws.__dataclass_fields__)), hw)
    aug_err = float((img_gpu.cpu() - img_cpu).abs().max())
    if not aug_err <= 1e-5:
        fail(f"task-2 augmentation at {hw}: card vs CPU max abs err {aug_err:.3e} > 1e-5")
    masks, runs = {}, {}
    labels = torch.from_numpy(labels_np)
    for name, device, f64 in (("cpu", "cpu", False), ("card", "cuda", False),
                              ("f64", "cpu", True))[:3 if truth else 2]:
        m = _task2_model("res18")
        m.load_state_dict(start)
        runs[name] = task2_forward_backward(m, img_cpu, labels, masks, device, f64)
    (lc, loss_c, gc, sc), (lg, loss_g, gg, sg) = runs["cpu"], runs["card"]
    what = f"task-2 step, batch {batch} at {hw}x{hw}"
    if not bool(((lg - lc).abs() <= 1e-4 + 1e-5 * lc.abs()).all()):
        fail(f"{what}: logits card vs CPU {float((lg - lc).abs().max()):.3e}")
    stat_err = max(float((a - b).abs().max()) for k in sc for a, b in zip(sg[k], sc[k]))
    if not stat_err <= 1e-5:
        fail(f"{what}: BN statistics card vs CPU {stat_err:.3e} > 1e-5")
    out = {"card_cpu": _grad_shares(gg, gc)}
    if truth:
        out["card_f64"] = _grad_shares(gg, runs["f64"][2])
        out["cpu_f64"] = _grad_shares(gc, runs["f64"][2])
    print(f"task2 [{card}]: {what}, card vs CPU from one state and draws: augmentation "
          f"{aug_err:.3e}, logits {float((lg - lc).abs().max()):.3e}, loss {loss_g:.7f} / "
          f"{loss_c:.7f}, BN statistics {stat_err:.3e}; worst gradient (share of the bound "
          f"max(2e-3 |ref|, 2e-4 global norm)): "
          + ", ".join(f"{k} {n} {v:.4f}" for k, (n, v) in out.items()), flush=True)
    return out


def task2_repeat(start, imgs, labels):
    """One f32 res18 step from ``start`` twice (one generator seed):
    (state tensors that differ: parameters, BN statistics, Adam moments;
    their count)."""
    import torch

    from tcct_tpu_torch.task2 import train as t2
    from tcct_tpu_torch.task2.model import ClsModel
    from tcct_tpu_torch.train.state import Adam

    ends = []
    for _ in range(2):
        m = ClsModel("res18")
        m.load_state_dict(start)
        opt = Adam()
        step = t2.build_cls_train_step(m, opt, device="cuda",
                                       generator=torch.Generator(device="cuda").manual_seed(SEED))
        step(imgs, labels)
        ends.append([*m.state_dict().values(), *opt.mu, *opt.nu])
    return sum(not torch.equal(a, b) for a, b in zip(*ends)), len(ends[0])


def write_cls_pngs(folder: str, shapes, colour=(200, 60, 10)) -> None:
    """One PNG a shape (``NNNN.png`` from 0001), each a solid RGB
    ``colour`` with seeded noise in its top-left corner."""
    import numpy as np

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(SEED + 50)
    for i, hw in enumerate(shapes):
        img = np.empty(hw + (3,), np.uint8)
        img[:] = colour
        img[:64, :64] = rng.integers(0, 256, (64, 64, 3))
        with open(os.path.join(folder, f"{i + 1:04d}.png"), "wb") as f:
            f.write(_png_bytes(img))


def drive_task2(report, card):
    """Task 2, the ResNet glaucoma classifier, f32 (TF32 off), batch 8 at
    224x224 (synthetic fundus images from the seed):

    - a res18 step with augmentation, the launch counts set to 0 just before
      and read just after (K3 and K3b 20 each, nothing else), every K3 and
      K3b call of it held against its plain version;
    - the step's forward and backward on the card against the CPU from one
      state, one augmented batch and one set of dropout masks (the
      augmentation within 1e-5, logits within 1e-4 + 1e-5 |ref|, BN
      statistics within 1e-5, each gradient within the CPU tests' bound);
    - one step run twice from one state and one generator, bitwise over
      every state tensor (parameters, BN statistics, Adam moments); and the
      same with cuDNN free to pick non-deterministic algorithms, reported;
    - a profile (busy ms by group, launches), eager ms/step in turns with and
      without deterministic convs, peak memory;
    - one counted step of res34 (36/36) and res50 (53/53);
    - a ``ClsTrainer`` debug fit on 40 synthetic images (4 steps, val), its
      launches counted, and a ``load`` of its ``best_model``;
    - eval images/s at batch 8 and the TTA on the 40 images;
    - the ensemble CLI (``main(argv)``) over two saved checkpoints;
    - ``GoalClsSet.load`` of 8 colour PNGs (one smaller than 1120x1120, one
      larger) with an xlsx of labels, both written here."""
    import shutil

    import numpy as np
    import torch

    from tcct_tpu_torch.models import layers
    from tcct_tpu_torch.task2 import ensemble
    from tcct_tpu_torch.task2 import train as t2
    from tcct_tpu_torch.task2.data import GoalClsSet, synthesize_cls, write_labels_xlsx
    from tcct_tpu_torch.train.state import Adam

    t_phase = time.perf_counter()
    shutil.rmtree(T2_DIR, ignore_errors=True)
    imgs_np, labels_np = synthesize_cls(T2_BATCH, T2_HW, SEED)
    imgs, labels = torch.from_numpy(imgs_np).cuda(), torch.from_numpy(labels_np).cuda()
    model = _task2_model("res18")
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = Adam()
    step = t2.build_cls_train_step(model, opt, device="cuda",
                                   generator=torch.Generator(device="cuda").manual_seed(SEED))
    want = {"bn_act_train": T2_BNS["res18"], "bn_act_train_backward": T2_BNS["res18"]}

    def counted(fn, want, what):
        torch.cuda.synchronize()
        reset_counters()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counters()
        for k, n in counts.items():
            if n != want.get(k, 0):
                fail(f"{what}: kernel {k}: {n} launches, expected {want.get(k, 0)}")
        return out, counts

    (m, fwd, bwd), counts = counted(lambda: _record_bn_calls(lambda: step(imgs, labels)), want,
                                    "task-2 res18 step")
    loss = float(m["loss"])
    if not math.isfinite(loss):
        fail(f"task-2 res18 step: loss {loss}")
    err_y, err_dx = check_bn_calls(fwd, bwd, "task-2 res18 step")
    for e in report["kernels"]:
        e["task2_step_launches"] = counts[e["name"]]
    print(f"task2 [{card}]: res18 f32 step, batch {T2_BATCH} at {T2_HW}x{T2_HW}: loss "
          f"{loss:.6f}, launches { {k: n for k, n in counts.items() if n} }; its {len(fwd)} K3 "
          f"and {len(bwd)} K3b calls against their plain versions: y max abs err "
          f"{err_y:.3e}, dx {err_dx:.3e}", flush=True)
    del fwd, bwd

    # the card against the CPU: at the CPU tests' size (64x64, batch 4) to their
    # bound; at full size each against the f64 step: the f32 step at a random
    # init is about two bounds from it on the CPU there, so the card is held to
    # be as close to it as the CPU is, within a factor 1.5
    small = task2_card_vs_cpu(start, 4, 64, card, truth=False)
    if small["card_cpu"][1] > 1.0:
        fail(f"task-2 step at 64x64: gradient {small['card_cpu'][0]} card vs CPU "
             f"{small['card_cpu'][1]:.3f} of its bound")
    full = task2_card_vs_cpu(start, T2_BATCH, T2_HW, card, truth=True)
    if full["card_f64"][1] > max(1.0, 1.5 * full["cpu_f64"][1]):
        fail(f"task-2 step at {T2_HW}x{T2_HW}: gradient {full['card_f64'][0]} card vs f64 "
             f"{full['card_f64'][1]:.3f} of its bound, the CPU's {full['cpu_f64'][1]:.3f}")
    report["task2_card_vs_cpu"] = {"64": small, str(T2_HW): full}

    # one step twice; then cuDNN free to choose (what the deterministic convs cost)
    off, n_state = task2_repeat(start, imgs, labels)
    if off:
        fail(f"task-2 step: {off} of {n_state} state tensors differ between two runs")
    free = lambda deterministic=False: layers.full_f32_cudnn(False)  # noqa: E731
    t2.full_f32_cudnn = free
    try:
        off_free, _ = task2_repeat(start, imgs, labels)
    finally:
        t2.full_f32_cudnn = layers.full_f32_cudnn
    print(f"task2 [{card}]: one step twice: {n_state - off} of {n_state} state tensors "
          f"bitwise equal; with cuDNN's default (non-deterministic) algorithms {off_free} "
          f"differ", flush=True)

    # time and profile: deterministic convs (the step) and cuDNN's default, in turns
    ms = {"deterministic": [], "default": []}
    for kind in ("deterministic", "default", "default", "deterministic"):
        t2.full_f32_cudnn = layers.full_f32_cudnn if kind == "deterministic" else free
        try:
            step(imgs, labels)
            ms[kind].append(_steps_ms(step, [(imgs, labels)], 5))
        finally:
            t2.full_f32_cudnn = layers.full_f32_cudnn
    busy = {}
    for kind in ("deterministic", "default"):
        t2.full_f32_cudnn = layers.full_f32_cudnn if kind == "deterministic" else free
        try:
            launches = Counter()
            groups = profile_device(lambda: step(imgs, labels), min(ms[kind]),
                                    f"task-2 res18 f32 step, {kind} convs [{card}]", launches)
            busy[kind] = (sum(groups.values()), sum(launches.values()))
        finally:
            t2.full_f32_cudnn = layers.full_f32_cudnn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(imgs, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"task2 [{card}]: res18 f32 step eager ms/step (5 steps, in turns): deterministic "
          f"{ms['deterministic']}, default {ms['default']}; device busy ms and launches "
          f"{busy}; peak memory {peak:.3f} GiB", flush=True)
    report["task2"] = {"eager_ms": ms, "busy_ms_launches": busy, "peak_gib": peak,
                       "repeat_off": off, "repeat_off_default_convs": off_free}
    del model, step, opt

    for net in ("res34", "res50"):
        m = _task2_model(net)
        s = t2.build_cls_train_step(m, Adam(), device="cuda",
                                    generator=torch.Generator(device="cuda").manual_seed(SEED))
        n = T2_BNS[net]
        out, c = counted(lambda: s(imgs, labels), {"bn_act_train": n,
                                                     "bn_act_train_backward": n},
                         f"task-2 {net} step")
        ms_net = _steps_ms(s, [(imgs, labels)], 2)
        print(f"task2 [{card}]: {net} f32 step: loss {float(out['loss']):.6f}, launches "
              f"{ {k: v for k, v in c.items() if v} }, {ms_net:.2f} ms/step", flush=True)
        del m, s

    # the trainer, eval, TTA, the ensemble CLI
    ds = GoalClsSet.load(img_size=T2_HW)
    tr, _ = counted(lambda: t2.ClsTrainer(net="res18", bs=T2_BATCH,
                                          root=os.path.join(T2_DIR, "fit"), dataset=ds,
                                          debug=True, device="cuda"), {}, "task-2 trainer init")
    t0 = time.perf_counter()
    scores, _ = counted(lambda: tr.fit(), {"bn_act_train": 4 * T2_BNS["res18"],
                                           "bn_act_train_backward": 4 * T2_BNS["res18"]},
                        "task-2 debug fit")
    fit_s = time.perf_counter() - t0
    best = os.path.join(T2_DIR, "fit", "best_model")
    other = t2.ClsTrainer(net="res18", bs=T2_BATCH, root=os.path.join(T2_DIR, "fit"),
                          dataset=ds, seed=1, device="cuda")
    other.load(best)
    if set(scores) != {"auc", "f1s", "acc"} or not np.array_equal(other.predict(),
                                                                   tr.predict()):
        fail(f"task-2 trainer: scores {scores} or the loaded best_model's predictions differ")
    xb = tr.imgs_dev[:T2_BATCH]
    tr.predict_fn(xb)
    eval_ms = _steps_ms(tr.predict_fn, [(xb,)], 20)
    tta = ensemble.build_tta_predict(tr.model, device="cuda")
    tta(xb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means = torch.cat([tta(tr.imgs_dev[j:j + T2_BATCH]) for j in range(0, len(ds.imgs),
                                                                       T2_BATCH)])
    torch.cuda.synchronize()
    tta_ms = (time.perf_counter() - t0) * 1e3
    if means.shape != (len(ds.imgs),) or not bool(torch.isin(
            means, torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device="cuda")).all()):
        fail(f"task-2 TTA: means {means.tolist()}")
    weights = os.path.join(T2_DIR, "weights")
    tr.save(os.path.join(weights, "res18_a"))
    t2.ClsTrainer(net="res34", root=os.path.join(T2_DIR, "fit"), dataset=ds,
                  device="cuda").save(os.path.join(weights, "res34_b"))
    t0 = time.perf_counter()
    final = ensemble.main(["--weights", weights, "--out", os.path.join(T2_DIR, "pred")])
    ens_s = time.perf_counter() - t0
    if set(final) != set(ds.names) or not set(final.values()) <= {0, 1}:
        fail(f"task-2 ensemble CLI: {final}")
    print(f"task2 [{card}]: debug fit of 4 steps with val {fit_s:.2f} s, scores {scores}; "
          f"eval {eval_ms:.3f} ms a batch of {T2_BATCH} ({T2_BATCH / eval_ms * 1e3:.1f} "
          f"images/s); TTA of {len(ds.imgs)} images {tta_ms:.2f} ms; the ensemble CLI over "
          f"two checkpoints {ens_s:.2f} s", flush=True)
    del tr, other

    # a PNG folder with labels
    folder = os.path.join(T2_DIR, "goals", "Train", "Image")
    write_cls_pngs(folder, [(800, 1100), (1300, 1200)] + [(1120, 1120)] * 6)
    xlsx = os.path.join(T2_DIR, "goals", "Train", "Train_GC_GT.xlsx")
    write_labels_xlsx(xlsx, [(1, 0), (2, 1), (3, 1), (4, 0), (6, 1), (8, 0)])
    t0 = time.perf_counter()
    png = GoalClsSet.load(folder, xlsx, img_size=T2_HW)
    load_s = time.perf_counter() - t0
    centre = png.imgs[:, T2_HW // 2, T2_HW // 2].tolist()
    if (png.imgs.shape != (8, T2_HW, T2_HW, 3) or png.synthetic
            or png.labels.tolist() != [0, 1, 1, 0, 9, 1, 9, 0]
            or centre != [[10, 60, 200]] * 8):
        fail(f"task-2 PNG folder: {png.imgs.shape}, labels {png.labels.tolist()}, "
             f"centre pixels (BGR) {centre}")
    print(f"task2: GoalClsSet.load of 8 colour PNGs (800x1100, 1300x1200, 6 of 1120x1120) "
          f"with xlsx labels {png.labels.tolist()}: {load_s:.2f} s", flush=True)
    shutil.rmtree(T2_DIR, ignore_errors=True)
    print(f"task2: phase {time.perf_counter() - t_phase:.1f} s", flush=True)


DP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_dp")
DP_TIMEOUT_S = 300  # each child process, and each collective's group timeout
DP_HW = (320, 320)  # the DP batch's scans, cropped to TRAIN_HW by the augmentation


def _dp_model(drop_path_rate: float = 0.1):
    import torch

    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.models.layers import init_weights

    m = RegNet(get_model("stc_tt", TRAIN_NC, variant="train", drop_path_rate=drop_path_rate),
               out_channels=TRAIN_NC)
    return init_weights(m, torch.Generator().manual_seed(SEED))


def _dp_step(mesh, dtype, record: bool = False, random: bool = True):
    """A fresh seeded full-width stc_tt, its train step (every loss on,
    constant lr) on ``mesh`` or none, and the optimizer (which keeps the
    gradients it is given with ``record``).  ``random``: the augmentation,
    DropPath 0.1 and the boundary noise on; else all three off (pinned),
    so that the step is the same function of any order of the batch."""
    import torch

    from tcct_tpu_torch.train import AdamW, TrainConfig, build_train_step

    class Recording(AdamW):
        def update(self, params, grads):
            if record:
                self.seen = [g.detach().clone() for g in grads]
            return super().update(params, grads)

    model = _dp_model(0.1 if random else 0.0)
    opt = Recording(LR)
    cfg = TrainConfig(crop_hw=TRAIN_HW, n_class=TRAIN_NC, ds=True, udh=True, reg=True,
                      augment=random, dtype=dtype, pinned_reg_noise=not random)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = build_train_step(model, opt, cfg, device="cuda", generator=gen, mesh=mesh)
    return model, opt, step


def split_vs_one_launch(card, train):
    """(a) At every BN shape of the stc_tt train step, in bf16 and in f32
    (and the types the step calls it with): the two-phase path at one rank
    (sums, then normalize; backward sums, the weight gradients from them,
    then dx) bitwise the one-launch K3/K3b, and its device time a step
    against theirs and against SyncBatchNorm's library kernels
    (batch_norm_stats + batch_norm_elemt; batch_norm_backward_reduce +
    batch_norm_backward_elemt), replayed from CUDA graphs."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.ops.kernels import bnstats as B

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    tot = Counter()
    n_shapes = 0
    for (shape, leaky, kind), n in sorted(train["bn"].items()):
        for types in sorted({"bfloat16", "float32", kind}):
            xd, _, wd = types.partition("/")
            xd, wd = getattr(torch, xd), getattr(torch, wd or xd)
            C = shape[1]
            x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(xd)
            x = x.contiguous(memory_format=torch.channels_last)
            gy = torch.randn(shape, generator=gen, device="cuda").to(xd)
            gy = gy.contiguous(memory_format=torch.channels_last)
            w = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(wd)
            b = (torch.randn(C, generator=gen, device="cuda") * 0.1).to(wd)
            count = x.numel() // C
            y, m, v = B.bn_act_train(x, w, b, 1e-5, leaky)
            dx, dw, db = B.bn_act_train_backward(x, w, m, v, gy, 1e-5, leaky)
            y2, m2, v2 = B.bn_act_normalize(x, B.bn_act_sums(x, leaky), count, w, b, 1e-5, leaky)
            gs = B.bn_act_backward_sums(x, gy, leaky)
            dx2 = B.bn_act_backward_dx(x, w, m, v, gy, gs, count, 1e-5, leaky)
            dw2, db2 = B.bn_weight_grads(gs, m, v, 1e-5, w.dtype)
            torch.cuda.synchronize()
            same = [torch.equal(p, q) for p, q in ((y, y2), (m, m2), (v, v2), (dx, dx2),
                                                  (dw, dw2), (db, db2))]
            if not all(same):
                fail(f"dp (a): two-phase BN {list(shape)} {types} leaky={leaky}: not bitwise the "
                     f"one launch (y, mean, var, dx, dweight, dbias: {same})")
            n_shapes += 1
            if types != kind:
                continue  # timed at the step's own types
            nbytes = 2 * x.numel() * x.element_size()
            copies = [(x.clone(), gy.clone()) for _ in range(n_copies(nbytes))]
            t = F.leaky_relu(x, 0.01) if leaky else x
            w_x, b_x = w.to(xd), b.to(xd)
            invstd = torch.rsqrt(v + 1e-5)

            def one_fwd(xx, _g):
                return B.bn_act_train(xx, w, b, 1e-5, leaky)

            def split_fwd(xx, _g):
                return B.bn_act_normalize(xx, B.bn_act_sums(xx, leaky), count, w, b, 1e-5,
                                          leaky)

            def lib_fwd(xx, _g):
                tt = F.leaky_relu(xx, 0.01) if leaky else xx
                mean, inv = torch.batch_norm_stats(tt, 1e-5)
                return torch.batch_norm_elemt(tt, w_x, b_x, mean, inv, 1e-5)

            def one_bwd(xx, g):
                return B.bn_act_train_backward(xx, w, m, v, g, 1e-5, leaky)

            def split_bwd(xx, g):
                s2 = B.bn_act_backward_sums(xx, g, leaky)
                B.bn_weight_grads(s2, m, v, 1e-5, w.dtype)
                return B.bn_act_backward_dx(xx, w, m, v, g, s2, count, 1e-5, leaky)

            cnt = torch.tensor([count], dtype=torch.int32, device="cuda")

            def lib_bwd(_x, g):
                sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(g, t, m, invstd, w_x,
                                                                   True, True, True)
                return torch.batch_norm_backward_elemt(g, t, m, invstd, w_x, sdy, sdyx, cnt)

            for key, fn in (("one_fwd", one_fwd), ("split_fwd", split_fwd),
                            ("lib_fwd", lib_fwd), ("one_bwd", one_bwd),
                            ("split_bwd", split_bwd), ("lib_bwd", lib_bwd)):
                tot[key] += n * device_ms(fn, copies)
            del copies
    print(f"dp (a) [{card}]: the two-phase K3/K3b at one rank bitwise the one launch at "
          f"{n_shapes} (shape, types) cases of the stc_tt step's {len(train['bn'])} BN shapes", flush=True)
    print(f"dp (a) [{card}]: device ms a stc_tt step (its 53 BNs, replayed): forward one launch "
          f"{tot['one_fwd']:.4f}, two-phase {tot['split_fwd']:.4f}, SyncBatchNorm's "
          f"{tot['lib_fwd']:.4f}; backward one launch {tot['one_bwd']:.4f}, two-phase "
          f"{tot['split_bwd']:.4f} (with the weight gradients' small ops), SyncBatchNorm's "
          f"{tot['lib_bwd']:.4f}", flush=True)


def _state_bytes(model):
    import torch

    return torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8)
                      for t in model.state_dict().values()])


WITNESS_K = 2.0  # a DP gradient past the parity bound: at most this times 1p's distance from f64


def _f64_grads(imgs, labs):
    """The witness of the f32 DP check: the one-process step's gradients
    (by name) on the CPU in f64, from the same seeded stc_tt and batch, no
    random draws.  f64 masters and compute, and the step's three kernels by
    plain autograd in f64 (their plain versions sum in f32 inside): the
    train BatchNorms (:func:`_bn_autograd`), the depthwise 3x3 convs
    (``F.conv2d``), the MetaPool mixers (``F.avg_pool2d``).  The losses are
    taken in f32, as the step takes them."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.models import layers, mpvit
    from tcct_tpu_torch.train import AdamW, TrainConfig, build_train_step, trainable_parameters

    seen = []

    class Keep(AdamW):
        def update(self, params, grads):
            seen.extend(g.detach().clone() for g in grads)
            return super().update(params, grads)

    model = _dp_model(0.0).double()
    cfg = TrainConfig(crop_hw=TRAIN_HW, n_class=TRAIN_NC, ds=True, udh=True, reg=True,
                      augment=False, dtype=torch.float64, pinned_reg_noise=True)
    def dwconv(x, w, stride=1, bias=None, residual=False):  # NHWC x, [3, 3, C] taps
        xc = x.permute(0, 3, 1, 2)
        y = F.conv2d(xc, w.permute(2, 0, 1)[:, None], bias, stride, 1, groups=x.shape[3])
        return (y + xc if residual else y).permute(0, 2, 3, 1)

    raw = layers.bn_act_train, layers.dwconv3x3, mpvit.metapool_tokens
    layers.bn_act_train, layers.dwconv3x3 = _bn_autograd, dwconv
    mpvit.metapool_tokens = lambda x: F.avg_pool2d(x[:, None], 3, 1, 1,
                                                   count_include_pad=False)[:, 0] - x
    try:
        build_train_step(model, Keep(LR), cfg, device="cpu")(imgs, labs)
    finally:
        layers.bn_act_train, layers.dwconv3x3, mpvit.metapool_tokens = raw
    return dict(zip(trainable_parameters(model), seen))


def _f32_step_bounds(got, want, truth, sd0, names):
    """The f32 DP step against the one-process step at the bounds of
    ``check_train_f32_card_vs_cpu`` (tests/test_torch_train.py's): loss
    rtol 1e-5; BN statistics 1e-5 + 1e-4 |ref|; every parameter within 2.1
    lr, at most 2 % of elements more than 5 % of lr apart, the update's L2
    drift below 0.5; each gradient within max(2e-3 |ref|, 2e-4 global norm)
    of the one-process step's or, past that bound, no further from the f64
    step's (``truth``, :func:`_f64_grads`) than WITNESS_K times the
    one-process step's is.  On the card the one-process step's own f32
    weight gradients of the CrossCNN branch's high-resolution convs can lie
    bounds from f64 (cuDNN's f32 sums of terms that cancel), and a DP step
    sums them in another grouping: the f64 step tells which of the two
    is off.  Returns the measured numbers; fails past a bound."""
    import numpy as np

    def dist(a, b):
        return float((a.double().cpu() - b.double().cpu()).norm())

    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    gnorm = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in want["grads"].values())))
    worst = wit_worst = one_f64 = 0.0
    worst_k = wit_k = ""
    over = []
    for k, g in want["grads"].items():
        bound = max(2e-3 * float(g.double().norm()), 2e-4 * gnorm)
        share = dist(got["grads"][k], g) / bound
        one_f64 = max(one_f64, dist(g, truth[k]) / bound)
        if share > worst:
            worst, worst_k = share, k
        if share > 1.0:
            over.append(k)
            ratio = dist(got["grads"][k], truth[k]) / max(dist(g, truth[k]), 1e-300)
            if ratio > wit_worst:
                wit_worst, wit_k = ratio, k
    bs_worst = moved2 = drift2 = 0.0
    n_el = n_off = 0
    par_worst = 0.0
    for k, ref in want["state"].items():
        mine = got["state"][k]
        if "running" in k:
            bs_worst = max(bs_worst, float(((mine - ref).abs() / (1e-5 + 1e-4 * ref.abs())).max()))
            continue
        if k not in names:
            continue
        diff = (mine.double() - ref.double()).abs()
        par_worst = max(par_worst, float(diff.max()) / (2.1 * LR))
        n_el += diff.numel()
        n_off += int((diff > 0.05 * LR).sum())
        moved2 += float(((ref.double() - sd0[k].double()) ** 2).sum())
        drift2 += float(((mine.double() - ref.double()) ** 2).sum())
    drift = (drift2 / moved2) ** 0.5
    out = {"loss_rel": loss_rel, "grad_worst_of_parity_bound": worst,
           "grad_worst_tensor": worst_k, "tensors_over_parity_bound": over,
           "witness_worst": wit_worst, "witness_worst_tensor": wit_k,
           "one_process_vs_f64_worst_of_bound": one_f64, "tensors": len(want["grads"]),
           "bn_worst": bs_worst, "param_worst": par_worst, "off_share": n_off / n_el,
           "drift": drift}
    if (loss_rel > 1e-5 or wit_worst > WITNESS_K or bs_worst > 1.0 or par_worst > 1.0
            or n_off > 0.02 * n_el or drift >= 0.5):
        fail(f"dp (c): the f32 two-rank step against one process: {out}")
    return out


def dp_worker(rank: int, store: str, out: str) -> None:
    """(c) and (d), one of two ranks sharing cuda:0 over gloo: three
    augmented bf16 stc_tt steps (global batch 8, 4 rows a rank), the ranks'
    states bitwise equal after each; one f32 step against one process (rank
    0 runs it); the duke volume through ``load_predictor(mesh=)`` against
    the one-process predictor (rank 0).  Writes its numbers to ``out``."""
    import numpy as np
    import torch

    from tcct_tpu_torch.infer.predictor import load_predictor
    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.parallel import distributed as D
    from tcct_tpu_torch.parallel import init_distributed, make_mesh
    from tcct_tpu_torch.train import trainable_parameters

    init_distributed(f"file://{store}", 2, rank, timeout_s=DP_TIMEOUT_S)
    mesh = make_mesh(2)
    if mesh.backend != "gloo" or mesh.device != torch.device("cuda", 0):
        fail(f"dp (c): two ranks on one card want gloo on cuda:0, got {mesh}")
    calls = Counter()

    def counting(fn, kind):
        def wrapped(t, *a, **k):
            calls[kind] += 1
            calls[kind + " bytes"] += t.numel() * t.element_size()
            return fn(t, *a, **k)
        return wrapped

    D.all_reduce_ = counting(D.all_reduce_, "all_reduce")
    D.all_gather_rows = counting(D.all_gather_rows, "all_gather")
    res = {"rank": rank}
    imgs, labs = banded_batch(TRAIN_BATCH, DP_HW, TRAIN_NC, SEED)

    # (c) three bf16 steps, the ranks bitwise equal after each
    model, _, step = _dp_step(mesh, torch.bfloat16)
    times, losses, per_step = [], [], None
    for i in range(3):
        calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _ = step(imgs, labs)
        vals = {k: float(v) for k, v in metrics.items()}
        times.append((time.perf_counter() - t0) * 1e3)
        per_step = dict(calls)
        if not all(math.isfinite(v) for v in vals.values()):
            fail(f"dp (c): rank {rank} step {i}: non-finite loss {vals}")
        losses.append(vals["total"])
        both = mesh.all_gather_rows(_state_bytes(model)[None])
        if not torch.equal(both[0], both[1]):
            fail(f"dp (c): after step {i} the two ranks' states differ")
    res.update(bf16_ms=times, bf16_losses=losses, collectives=per_step,
               state_tensors=len(model.state_dict()))
    del model, step
    torch.cuda.empty_cache()

    # (c) one f32 step against one process on the same batch (256x256 scans,
    # no random draws), and past the parity bound against the step in f64
    imgs32, labs32 = banded_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_NC, SEED)

    def f32_step(m):
        model, opt, step = _dp_step(m, torch.float32, record=True, random=False)
        sd0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        metrics, _ = step(imgs32, labs32)
        names = list(trainable_parameters(model))
        got = {"loss": float(metrics["total"]), "grads": dict(zip(names, opt.seen)),
               "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
        return got, sd0, set(names)

    got, sd0, names = f32_step(mesh)
    if rank == 0:
        want, _, _ = f32_step(None)
        t0 = time.perf_counter()
        truth = _f64_grads(imgs32, labs32)
        res["f64_s"] = time.perf_counter() - t0
        res["f32"] = _f32_step_bounds(got, want, truth, sd0, names)
        res["f32_loss"] = (got["loss"], want["loss"])
        del want, truth
    del got, sd0
    torch.cuda.empty_cache()
    mesh.barrier("after the f32 step", DP_TIMEOUT_S)

    # (d) the duke volume, each rank its rows of each batch
    vol = duke_volume()
    pred = load_predictor(DB, batch_size=BATCH, dtype=torch.bfloat16, device="cuda",
                          seed=SEED, mesh=mesh)
    reset_counters()
    seg = pred.predict_scans(vol)
    torch.cuda.synchronize()
    counts = read_counters()
    n_batches = math.ceil(N_SCANS / BATCH)
    want_n = expected_launches(pred.model, BATCH // 2, get_geometry(DB).prep_hw, False)
    for k, n in counts.items():
        if n != n_batches * want_n.get(k, 0):
            fail(f"dp (d): rank {rank}: kernel {k}: {n} launches over {n_batches} batches, "
                 f"expected {n_batches * want_n.get(k, 0)}")
    both = mesh.all_gather_rows(torch.from_numpy(seg).cuda()[None])
    if not torch.equal(both[0], both[1]):
        fail("dp (d): the two ranks returned different class maps")
    res["predict_launches"] = counts
    if rank == 0:
        one = load_predictor(DB, batch_size=BATCH, dtype=torch.bfloat16, device="cuda",
                             seed=SEED).predict_scans(vol)
        res["maps_bitwise"] = bool(np.array_equal(seg, one))
        # cuDNN picks its conv algorithms by batch size (4 rows a rank, 8 in
        # one process), and bf16 rounds by them: drive_buckets' threshold
        res["maps_agree"] = held_agreement("dp (d): the two-rank predictor's bf16 maps vs one "
                                           "process's", seg, one, 0.999)
    mesh.barrier("end", DP_TIMEOUT_S)
    with open(out, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def _run_ranks(cmds, envs, what: str):
    """Start one process a rank, wait for each within DP_TIMEOUT_S, kill
    what is left; returns the outputs.  Fails if a rank failed."""
    procs = [subprocess.Popen(c, cwd=os.path.dirname(os.path.abspath(__file__)), env=e,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c, e in zip(cmds, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"{what}: a rank ran past {DP_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{what}: rank {r} exited {p.returncode}:\n{o[-3000:]}")
    return outs


def drive_distributed(report, card, train):
    """Data parallelism on the card (step 12 of the docstring): (a) the two-phase K3/K3b
    bitwise the one launch at the stc_tt step's BN shapes, timed; (b) NCCL
    with one rank: one augmented bf16 stc_tt step at full width on
    ``make_mesh(1)`` bitwise the step without a mesh (every state tensor),
    the launch counts read around it; (c) and (d) two ranks sharing the card
    over gloo (``dp_worker``); (e) the CLI with ``--pl`` under two
    processes.  Claims no speed: one card shows none."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from tcct_tpu_torch.parallel import init_distributed, make_mesh

    t_phase = time.perf_counter()
    split_vs_one_launch(card, train)

    # (b) NCCL, one rank
    shutil.rmtree(DP_DIR, ignore_errors=True)
    os.makedirs(DP_DIR)
    init_distributed(f"file://{DP_DIR}/store_b", 1, 0, timeout_s=DP_TIMEOUT_S)
    mesh = make_mesh(1)
    if mesh.backend != "nccl":
        fail(f"dp (b): one rank on one card wants nccl, got {mesh.backend}")
    imgs, labs = banded_batch(TRAIN_BATCH, DP_HW, TRAIN_NC, SEED)
    ends = []
    for m in (None, mesh):
        model, _, step = _dp_step(m, torch.bfloat16)
        torch.cuda.synchronize()
        reset_counters()
        metrics, _ = step(imgs, labs)
        torch.cuda.synchronize()
        counts = read_counters()
        ends.append(({k: v.detach().clone() for k, v in model.state_dict().items()}, counts,
                     float(metrics["total"])))
        del model, step
    (single, c1, l1), (dp, c2, l2) = ends
    off = [k for k in single if not torch.equal(single[k], dp[k])]
    print(f"dp (b) [{card}]: NCCL world size 1: one augmented bf16 stc_tt step on make_mesh(1) "
          f"(loss {l2:.6f}) against the step without a mesh (loss {l1:.6f}): "
          f"{len(single) - len(off)} of {len(single)} state tensors bitwise equal", flush=True)
    if off:
        fail(f"dp (b): {len(off)} state tensors differ ({', '.join(off[:6])} ...)")
    want = train_launches(_dp_model(), data_parallel=True)
    print(f"dp (b): launches of the mesh step {c2}", flush=True)
    for k, n in c2.items():
        if n != want.get(k, 0):
            fail(f"dp (b): kernel {k}: {n} launches in the mesh step, expected {want.get(k, 0)}")
    for e in report["kernels"]:
        if e["name"] in SPLIT_BN:
            e["launches"] = c2[e["name"]]
    del single, dp, ends
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (c), (d): two ranks sharing cuda:0
    t0 = time.perf_counter()
    me = os.path.abspath(__file__)
    outs = [os.path.join(DP_DIR, f"rank{r}.json") for r in range(2)]
    _run_ranks([[sys.executable, me, "--dp-worker", str(r), f"{DP_DIR}/store_c", outs[r]]
                for r in range(2)], [dict(os.environ)] * 2, "dp (c)")
    res = [json.load(open(o)) for o in outs]
    r0 = res[0]
    coll = r0["collectives"]
    print(f"dp (c) [{card}]: two ranks on one card over gloo, stc_tt full width, global batch "
          f"{TRAIN_BATCH} ({TRAIN_BATCH // 2} a rank), 3 augmented bf16 steps: losses "
          f"{', '.join(f'{v:.6f}' for v in r0['bf16_losses'])}, the ranks' "
          f"{r0['state_tensors']} state tensors bitwise equal after each; ms/step "
          f"{', '.join(f'{t:.1f}' for t in r0['bf16_ms'])} (two processes sharing one card: no "
          f"speed is claimed); collectives a step: {coll.get('all_reduce', 0)} all-reduces "
          f"({coll.get('all_reduce bytes', 0)} bytes), {coll.get('all_gather', 0)} all-gathers "
          f"({coll.get('all_gather bytes', 0)} bytes a rank)", flush=True)
    print(f"dp (c): f32 step (TF32 off), two ranks vs one process: loss {r0['f32_loss'][0]:.7f} "
          f"vs {r0['f32_loss'][1]:.7f}; the witness step in f64 on the CPU in "
          f"{r0['f64_s']:.1f} s; {r0['f32']}", flush=True)
    print(f"dp (d): the duke volume through load_predictor(mesh=) on two ranks: maps bitwise "
          f"the one-process predictor's: {r0['maps_bitwise']}, agreement {r0['maps_agree']:.6f}; "
          f"launches a rank {res[1]['predict_launches']} ({time.perf_counter() - t0:.1f} s "
          f"for (c) and (d))", flush=True)

    # (e) the CLI, --pl, two processes
    t0 = time.perf_counter()
    root = os.path.join(DP_DIR, "cli")
    envs = []
    for r in range(2):
        env = dict(os.environ, TCCT_COORDINATOR=f"file://{DP_DIR}/store_e",
                   TCCT_NUM_PROCESSES="2", TCCT_PROCESS_ID=str(r))
        envs.append(env)
    cmd = [sys.executable, "-m", "tcct_tpu_torch.cli.main", "--db", ENGINE_DB, "--bug", "true",
           "--bs", str(ENGINE_BATCH), "--ds", "true", "--pl", "true", "--root", root]
    logs = _run_ranks([cmd, cmd], envs, "dp (e)")
    line = f"DATA-PARALLEL: bs={ENGINE_BATCH} over 2/2 ranks"
    for r, log in enumerate(logs):
        if line not in log:
            fail(f"dp (e): rank {r} printed no '{line}':\n{log[-2000:]}")
    lines = [json.loads(x) for x in open(os.path.join(root, "metrics.jsonl"))]
    if len(lines) != 1 or not math.isfinite(lines[0].get("total", float("nan"))):
        fail(f"dp (e): want one metrics.jsonl line (rank 0's) with a finite total: {lines}")
    print(f"dp (e): {' '.join(cmd[1:])} under two processes (TCCT_*): '{line}', exit 0 in "
          f"{time.perf_counter() - t0:.1f} s, rank 0's log total {lines[0]['total']:.5f}",
          flush=True)
    print(f"dp [{card}]: data parallelism in {time.perf_counter() - t_phase:.1f} s", flush=True)


# --- the width-sharded predictor: a ('data', 'model') mesh --------------------------------

WS_MESH = (2, 2)  # (data, model) ranks of the phase's four processes
WS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_ws")


def ws_exchanges(model, fused: bool = False):
    """(halo exchanges, all-reduces) of one width-sharded forward of a
    registry model, from its config.  ReLayNet: its seven 7x3 convs.  An FTC
    model: the CNN branch's stem conv and five blocks, each one exchange
    with ``fused`` (K4 on a haloed block), else five exchanged convs (3x3,
    3x3; 1xk, 3x3; 3x3; MSCA adds its 5x5 and three 1xk); the MPViT stem's
    two convs, each patch embed, each block's ConvPosEnc and mixer (the
    MetaPool site, metapool2d's window, or the CRPE's convs, one a window
    of the refit head split) and each stage's ResBlock depthwise conv; the
    head and four decoder blocks' 3x3 conv and upsampling.  All-reduces:
    factor 3 a block (its softmax's max and sum, ``k^T v``), hydra 1."""
    from tcct_tpu_torch.models.mpvit import CRPE_MIXERS, _fit_crpe_window

    base = model.base
    if not hasattr(base, "vit_cfg"):
        return 7, 0
    n = 1 + 5 * (1 if fused else 5 + (4 if base.base_cnn.msca else 0)) + 1 + 8
    reduces = 0
    if base.flag_vit:
        cfg = base.vit_cfg
        n += 2
        for p, l, h in zip(cfg.num_path, cfg.num_layers, cfg.num_heads):
            mix = len(_fit_crpe_window(cfg.crpe_window, h)) if cfg.mixer in CRPE_MIXERS else 1
            n += p + p * l * (1 + mix) + 1
            reduces += p * l * {"factor": 3, "hydra": 1}.get(cfg.mixer, 0)
    return n, reduces


def bench_site_shards(report, card, sites):
    """(a) the site's shard entry point at duke's four site shapes, 4 rows
    a rank (a (2, M) mesh's), split M = 2 and 4 ways, bf16 and f32: each
    rank's call against its plain version (``check_site``'s bounds); the
    ranks' outputs reassembled bit for bit the one-launch site on the whole
    grid; timed against the plain version and the one-launch site on as
    many tokens, with its bound (x and the two halos read, y and n2
    written, over the memory rate).  Also the decoder's
    sharded upsampling against ``F.interpolate`` at its widest shape."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.models.mpvit import MPViTConfig
    from tcct_tpu_torch.ops.kernels.metapool import (
        metapool_block,
        metapool_block_flops,
        metapool_block_shard,
        metapool_block_shard_reference,
    )
    from tcct_tpu_torch.ops.resize import upsample2x_aligned_shard
    from tcct_tpu_torch.parallel.spatial import cut_halos

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    rows = BATCH // WS_MESH[0]
    grids = []  # (B, H, W, C) of each site of a serving batch's rank
    H, W = get_geometry(DB).prep_hw
    h, w = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    for i, C in enumerate(MPViTConfig().embed_dims):
        if i:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        grids.append((rows, h, w, C))
    if sorted((BATCH, hh * ww, C) for _, hh, ww, C in grids) != sorted(sites):
        fail(f"ws (a): site grids {grids} do not match the serving batch's sites {dict(sites)}")
    print(f"ws (a) [{card}]: the MetaPool site on a width shard (metapool_block_shard) vs its "
          f"plain version, reassembled vs the one-launch site:", flush=True)
    tot, max_err = Counter(), 0.0
    for B, hh, ww, C in grids:
        for M in (2, 4):
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                x, w1, b1, w2, b2 = _site_inputs((B, hh * ww, C), dtype, gen)
                affine = (w1, b1, w2, b2)
                xg = x.reshape(B, hh, ww, C)
                label = f"metapool_block_shard [{B},{hh}x{ww // M},{C}] of {M} {dn}"
                calls, err = [], 0.0
                with torch.inference_mode():
                    for m in range(M):
                        xs, lh, rh = cut_halos(xg, m, (ww // M,) * M, 1, 1, wrap=True)
                        calls.append((xs.reshape(B, -1, C).contiguous(),
                                      lh[:, :, 0].contiguous(), rh[:, :, 0].contiguous(),
                                      m == 0, m == M - 1) + affine)
                    outs = [metapool_block_shard(*a) for a in calls]
                    torch.cuda.synchronize()
                    for m, (a, got) in enumerate(zip(calls, outs)):
                        want = metapool_block_shard_reference(*a)
                        err = max(err, check_site(f"{label} rank {m}", got, want,
                                                  (a[0],) + affine, dn))
                    max_err = max(max_err, err)
                    whole = metapool_block(x, *affine)
                    for i in (0, 1):
                        got = torch.cat([o[i].reshape(B, hh, -1, C) for o in outs], 2)
                        if not torch.equal(got.reshape(B, -1, C), whole[i]):
                            fail(f"{label}: the reassembled shards differ from the one-launch "
                                 f"site ({'y' if i == 0 else 'n2'})")
                a = calls[1]  # rank 1: two exchanged halos where M = 4
                xs = a[0]
                nbytes = (3 * xs.numel() + 2 * a[1].numel() + 4 * C) * xs.element_size()
                copies = [(xs.clone(),) + a[1:] for _ in range(n_copies(nbytes))]
                site = [(c[0],) + affine for c in copies]
                t_k = device_ms(metapool_block_shard, copies)
                t_p = device_ms(metapool_block_shard_reference, copies)
                t_1 = device_ms(metapool_block, site)
                b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                b_ops = metapool_block_flops(xs.shape) / F32_FLOP_PER_S * 1e3
                bound = max(b_bytes, b_ops)
                print(f"  {label}: plain max_abs_err {err:.3e}, shards bitwise the one-launch "
                      f"site; one rank {t_k * 1e3:.1f} us, plain {t_p * 1e3:.1f} us, one-launch "
                      f"site on as many tokens {t_1 * 1e3:.1f} us, bound {bound * 1e3:.1f} us "
                      f"({'bytes' if b_bytes >= b_ops else 'operations'}), "
                      f"{b_bytes / t_k * 100:.0f}% of the byte bound", flush=True)
                if dtype == torch.bfloat16 and M == WS_MESH[1]:  # the main path's calls
                    tot["ms"] += t_k
                    tot["plain_ms"] += t_p
                    tot["one_launch_ms"] += t_1
                    tot["bound_ms"] += bound
                del copies, site, calls, outs
    report["kernels"].append({
        "name": "metapool_block_shard", "route": "cuda",
        "source": "tcct_tpu_torch/csrc/metapool.cu",
        "replaces": "tcct_tpu/ops/pallas/metapool.py:64", "launches": 0, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "one_launch_site_ms": tot["one_launch_ms"]})
    print(f"  a rank's bf16 batch on the {WS_MESH} mesh: 4 sites {tot['ms']:.4f} ms, plain "
          f"{tot['plain_ms']:.4f}, the one-launch site on as many tokens "
          f"{tot['one_launch_ms']:.4f}, bound {tot['bound_ms']:.4f} ms", flush=True)
    # the decoder's last upsampling, a rank's block of it
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((rows, 32, H // 2, W // 2), generator=gen, device="cuda").to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        want = F.interpolate(x, size=(H, W), mode="bilinear", align_corners=True)
        M = WS_MESH[1]
        outs = []
        for m in range(M):
            xs, lh, rh = cut_halos(x.permute(0, 2, 3, 1), m, (W // 2 // M,) * M, 1, 1)
            xs = xs.permute(0, 3, 1, 2)
            outs.append(upsample2x_aligned_shard(xs, lh, rh, m * xs.shape[3], W // 2))
        d = (torch.cat(outs, 3).float() - want.float()).abs()
        scale = float(x.float().abs().max())
        print(f"ws (a): the sharded 2x upsampling (align_corners=True) at {list(x.shape)} over "
              f"{M} {str(dtype)[6:]} vs F.interpolate on the card: max diff {float(d.max()):.3e} "
              f"({float(d.max()) / scale:.2e} of max|x|), {int((d > 0).sum())} of {d.numel()} "
              f"elements differ", flush=True)
        if float(d.max()) > (2.0 ** -20 if dtype == torch.float32 else 2.0 ** -7) * scale:
            fail("ws (a): the sharded upsampling is further from F.interpolate than an f32 "
                 "rounding (f32) or one bf16 step (bf16)")


def bench_k4_shards(report, card):
    """(c) K4 on a rank's haloed blocks at duke's five ``stc_tt`` levels, 4 rows
    a rank (a (2, M) mesh's), bf16 and f32: each block widened by ``k // 2 + 2``
    columns on every side that is not the image's edge (``cut_halos(...,
    clip=True)``), one launch, cropped (``fused_cross_block_shard``); the
    ranks' cropped maps reassembled bit for bit the one-launch K4 on the whole
    map, split 2 and 4 ways; rank 0's haloed launch of the 2-way split (the
    (2, 2) mesh's) against its plain version (``check_fused_block``'s
    bounds) and timed against the plain version and one K4 launch on as
    many columns without a halo, with its bound (x read, y written, the weights once over the
    memory rate; the haloed launch's operations over the type's peak)."""
    import torch

    from tcct_tpu_torch.models.crosscnn import (
        cross_block_halo,
        fused_cross_block_shard,
        seeded_cross_block,
    )
    from tcct_tpu_torch.ops.kernels.crosscnn_fused import (
        fused_cross_block,
        fused_cross_block_flops,
        fused_cross_block_reference,
    )
    from tcct_tpu_torch.parallel.spatial import cut_halos

    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rows = BATCH // WS_MESH[0]
    print(f"ws (c) [{card}]: K4 on a rank's haloed blocks (fused_cross_block_shard) vs the "
          f"one-launch K4 on the whole map:", flush=True)
    tot, max_err = Counter(), 0.0
    with torch.inference_mode():
        for i, (what, shape, cout, k, _, _) in enumerate(K4_SHAPES[:5]):
            _, Hh, W, cin = shape
            h = cross_block_halo(k)
            macs = 9 * cin * cout + 3 * 9 * cout * cout + k * cin * cout + k * cout * cout
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[-1]
                blk = seeded_cross_block(cin, cout, k, SEED + 30 + i).to("cuda", dtype)
                x = torch.randn((rows, Hh, W, cin), generator=gen, device="cuda").to(dtype)
                whole = fused_cross_block(x, blk)
                for M in (2, 4):
                    calls = [cut_halos(x, m, (W // M,) * M, h, h, clip=True) for m in range(M)]
                    outs = [fused_cross_block_shard(xs, blk, lh, rh) for xs, lh, rh in calls]
                    torch.cuda.synchronize()
                    if not torch.equal(torch.cat(outs, 2), whole):
                        d = float((torch.cat(outs, 2).float() - whole.float()).abs().max())
                        fail(f"ws (c): {what} {dn}: K4 on {M} haloed blocks differs from the "
                             f"one-launch K4 on the whole map (max diff {d:.3e})")
                    if M == 2:
                        xs, lh, rh = calls[0]
                        xe = torch.cat([lh, xs, rh], 2).contiguous()
                del calls, outs, whole
                label = f"K4 shard {list(xe.shape)} (rank 0 of 2: {xs.shape[2]} + {rh.shape[2]} " \
                        f"columns) -> {cout} k {k} {dn}"
                got = fused_cross_block(xe, blk)
                torch.cuda.synchronize()
                want = fused_cross_block_reference(xe, blk)
                truth = fused_cross_block_reference(xe[:1], blk, acc=torch.float64)
                err = check_fused_block(label, got, want, truth, dn)[0]
                max_err = max(max_err, err)
                del got, want, truth
                copies_e = [(xe.clone(),) for _ in range(n_copies(xe.numel() * xe.element_size()))]
                copies_s = [(c[0][:, :, :xs.shape[2]].contiguous(),) for c in copies_e]
                t_k = device_ms(lambda t: fused_cross_block(t, blk), copies_e, K4_ITERS)
                t_1 = device_ms(lambda t: fused_cross_block(t, blk), copies_s, K4_ITERS)
                t_p = device_ms(lambda t: fused_cross_block_reference(t, blk), copies_e,
                                K4_ITERS)
                nbytes = (xe.numel() + rows * Hh * xe.shape[2] * cout + macs) * xe.element_size()
                b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
                b_ops = fused_cross_block_flops(xe.shape, cin, cout, k) / rate * 1e3
                bound = max(b_bytes, b_ops)
                print(f"  {what}: {label}: the 2- and 4-way splits bitwise the whole map's K4; "
                      f"plain max_abs_err {err:.3e}; one rank {t_k * 1e3:.1f} us, plain "
                      f"{t_p:.3f} ms, one K4 on {xs.shape[2]} columns without a halo "
                      f"{t_1 * 1e3:.1f} us, bound "
                      f"{bound * 1e3:.1f} us ({'bytes' if b_bytes >= b_ops else 'operations'})"
                      f", {bound / t_k * 100:.1f}% of it", flush=True)
                if dtype == torch.bfloat16:
                    tot["ms"] += t_k
                    tot["plain_ms"] += t_p
                    tot["same_columns_ms"] += t_1
                    tot["bound_ms"] += bound
                del copies_e, copies_s, x, xe, blk
    for e in report["kernels"]:
        if e["name"] == "fused_cross_block":
            e.update({"ws_ms": tot["ms"], "ws_plain_ms": tot["plain_ms"],
                      "ws_same_columns_ms": tot["same_columns_ms"],
                      "ws_bound_ms": tot["bound_ms"], "ws_max_abs_err": max_err,
                      "ws_launches": 0})
    print(f"  a rank's bf16 batch on the {WS_MESH} mesh: 5 K4 launches on haloed blocks "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, one launch each on as many columns "
          f"{tot['same_columns_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms", flush=True)


# the paths a width shard serves beyond the MetaPool FTC family (key, net, mixer, cnn_impl),
# one duke batch each on WS_MESH; then heg's 672 columns on WS_HEG_MESH (blocks 176, 176, 160,
# 160)
WS_ZOO = (("factor", "stc_tt", "factor", "plain"), ("hydra", "stc_tt", "hydra", "plain"),
          ("metapool2d", "stc_tt", "metapool2d", "plain"), ("relay", "relay", "metapool", "plain"),
          ("msca", "msca", "metapool", "plain"), ("fused", "stc_tt", "metapool", "fused"))
WS_HEG = (("heg plain", "stc_tt", "metapool", "plain"),
          ("heg fused", "stc_tt", "metapool", "fused"))
WS_HEG_MESH = (1, 4)


def ws_serve_zoo(rank: int, mesh, db: str, cases, res) -> None:
    """(b), continued in one rank: one seeded batch of ``db`` through
    ``load_predictor(mesh=)`` for each case, bf16 and f32, the launch counts,
    exchanges and all-reduces set to 0 just before and read just after and
    held to the config's, every rank's maps equal; rank 0 then serves the
    batch in one process and records the agreement (the others wait)."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor

    H, W = get_geometry(db).prep_hw
    vol = np.random.default_rng(SEED + 16).integers(0, 256, (BATCH, H, W, 3), dtype=np.uint8)
    for key, net, mixer, impl in cases:
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            kw = dict(net=net, mixer=mixer, cnn_impl=impl, batch_size=BATCH, dtype=dtype,
                      device="cuda", seed=SEED)
            what = f"ws (b): rank {rank} {key} {db} {name}"
            pred = load_predictor(db, mesh=mesh, **kw)
            torch.cuda.synchronize()
            mesh.barrier(f"before {key} {name}", DP_TIMEOUT_S)
            reset_counters()
            pred.shard.stats.clear()
            t0 = time.perf_counter()
            seg = pred.predict_scans(vol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counters()
            want = expected_launches(pred.model, BATCH // mesh.data_size, (H, W), impl == "fused")
            want["metapool_block_shard"] = want.pop("metapool_block")
            for k, c in counts.items():
                if c != want.get(k, 0):
                    fail(f"{what}: kernel {k}: {c} launches, expected {want.get(k, 0)}")
            stats = dict(pred.shard.stats)
            got = (stats.get("exchanges", 0), stats.get("reduces", 0))
            if got != ws_exchanges(pred.model, impl == "fused"):
                fail(f"{what}: (exchanges, all-reduces) {got}, expected "
                     f"{ws_exchanges(pred.model, impl == 'fused')}")
            every = mesh.all_gather_rows(torch.from_numpy(seg).cuda()[None])
            if not all(torch.equal(every[0], every[r]) for r in range(mesh.size)):
                fail(f"{what}: the ranks returned different class maps")
            entry = {"counts": {k: c for k, c in counts.items() if c}, "stats": stats,
                     "blocks": list(pred.shard.blocks), "wall_s": wall}
            del pred
            if rank == 0:
                one = load_predictor(db, **kw).predict_scans(vol)
                entry.update(agree=float((seg == one).mean()),
                             bitwise=bool(np.array_equal(seg, one)),
                             classes=int(len(np.unique(one))))
            torch.cuda.empty_cache()
            mesh.barrier(f"after {key} {name}", DP_TIMEOUT_S)
            res["zoo"][f"{key} {name}"] = entry


def ws_worker(rank: int, store: str, out: str) -> None:
    """(b), one of four ranks sharing cuda:0 over gloo as a (2, 2) mesh: the
    duke volume through ``load_predictor(mesh=)`` in bf16 and in f32 (TF32
    off), a warm-up batch first, then the volume with the launch counts and
    the exchanges set to 0 just before and read just after, the counts held
    to the config's (per rank a batch: the shard site 4, K2 s1 9, K2 s2 3,
    the one-launch site 0), the ranks' maps equal; then one duke batch of each
    path of ``WS_ZOO`` on that mesh and one heg batch of each of ``WS_HEG`` on
    a (1, 4) mesh of the same ranks (``ws_serve_zoo``).  Writes its numbers
    to ``out`` and its maps beside it."""
    import numpy as np
    import torch

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import load_predictor
    from tcct_tpu_torch.parallel import init_distributed, make_mesh

    n = WS_MESH[0] * WS_MESH[1]
    init_distributed(f"file://{store}", n, rank, timeout_s=DP_TIMEOUT_S)
    mesh = make_mesh(n, ("data", "model"), shape=WS_MESH)
    if mesh.backend != "gloo" or mesh.device != torch.device("cuda", 0):
        fail(f"ws (b): four ranks on one card want gloo on cuda:0, got {mesh}")
    vol = duke_volume()
    n_batches = math.ceil(N_SCANS / BATCH)
    res = {"rank": rank, "coords": [mesh.data_rank, mesh.model_rank]}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        pred = load_predictor(DB, batch_size=BATCH, dtype=dtype, device="cuda", seed=SEED,
                              mesh=mesh)
        pred.predict_scans(vol[:BATCH])  # warm-up
        torch.cuda.synchronize()
        mesh.barrier(f"before the {name} volume", DP_TIMEOUT_S)
        reset_counters()
        pred.shard.stats.clear()
        t0 = time.perf_counter()
        seg = pred.predict_scans(vol)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counters()
        want = expected_launches(pred.model, BATCH // WS_MESH[0],
                                 get_geometry(DB).prep_hw, False)
        want["metapool_block_shard"] = want.pop("metapool_block")
        for k, c in counts.items():
            if c != n_batches * want.get(k, 0):
                fail(f"ws (b): rank {rank} {name}: kernel {k}: {c} launches over {n_batches} "
                     f"batches, expected {n_batches * want.get(k, 0)}")
        stats = dict(pred.shard.stats)
        if stats.get("exchanges") != n_batches * ws_exchanges(pred.model)[0]:
            fail(f"ws (b): rank {rank} {name}: {stats} exchanges over {n_batches} batches, "
                 f"expected {n_batches * ws_exchanges(pred.model)[0]}")
        every = mesh.all_gather_rows(torch.from_numpy(seg).cuda()[None])
        if not all(torch.equal(every[0], every[r]) for r in range(n)):
            fail(f"ws (b): {name}: the ranks returned different class maps")
        res[name] = {"counts": counts, "exchanges": stats, "wall_s": wall}
        if rank == 0:
            np.save(f"{out}.{name}.npy", seg)
        del pred
        torch.cuda.empty_cache()
    res["zoo"] = {}
    ws_serve_zoo(rank, mesh, DB, WS_ZOO, res)
    heg = make_mesh(n, ("data", "model"), shape=WS_HEG_MESH)
    ws_serve_zoo(rank, heg, "heg", WS_HEG, res)
    mesh.barrier("end", DP_TIMEOUT_S)
    with open(out, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def drive_width_sharded(report, card, sites, one_process_maps):
    """The width-sharded predictor on the card (step 13 of the docstring):
    (a) ``bench_site_shards``; (c) ``bench_k4_shards``; (b) four processes
    sharing the card over gloo as a (2, 2) ``('data', 'model')`` mesh
    (``--ws-worker``) serving the duke volume, bf16 and f32, against the
    one-process predictor's maps of step 3; then one batch of each path of
    ``WS_ZOO`` (duke, (2, 2)) and ``WS_HEG`` (heg, (1, 4)) against one
    process's maps of it (bf16 at least 99.9 % of pixels, f32 99.999 %; the
    fused branch's f32 maps bit for bit).  Claims no speed: ranks sharing one
    card show none."""
    import shutil

    import numpy as np

    t_phase = time.perf_counter()
    bench_site_shards(report, card, sites)
    bench_k4_shards(report, card)
    shutil.rmtree(WS_DIR, ignore_errors=True)
    os.makedirs(WS_DIR)
    t0 = time.perf_counter()
    me = os.path.abspath(__file__)
    n = WS_MESH[0] * WS_MESH[1]
    outs = [os.path.join(WS_DIR, f"rank{r}.json") for r in range(n)]
    _run_ranks([[sys.executable, me, "--ws-worker", str(r), f"{WS_DIR}/store", outs[r]]
                for r in range(n)], [dict(os.environ)] * n, "ws (b)")
    res = [json.load(open(o)) for o in outs]
    for name, threshold in (("bf16", 0.999), ("f32", 0.999)):
        seg = np.load(f"{outs[0]}.{name}.npy")
        one = one_process_maps[name]
        agree = held_agreement(f"ws (b) [{card}]: the {WS_MESH} width-sharded predictor's "
                               f"{name} maps vs one process's", seg, one, threshold)
        r0 = res[0][name]
        ex = r0["exchanges"]
        walls = ", ".join(f"{r[name]['wall_s']:.2f}" for r in res)
        print(f"ws (b): {name}: maps bitwise one process's: {bool(np.array_equal(seg, one))} "
              f"(agreement {agree:.6f}); launches a rank over {math.ceil(N_SCANS / BATCH)} "
              f"batches {r0['counts']}; halo exchanges a batch "
              f"{ex['exchanges'] // math.ceil(N_SCANS / BATCH)}, "
              f"{ex['bytes'] // math.ceil(N_SCANS / BATCH)} bytes a rank sent; volume "
              f"{walls} s by rank (four processes sharing one card over gloo: no speed is "
              f"claimed)",
              flush=True)
    zoo = res[0]["zoo"]
    for key, _, _, impl in WS_ZOO + WS_HEG:
        for name, threshold in (("bf16", 0.999), ("f32", 0.99999)):
            e = zoo[f"{key} {name}"]
            db = "heg" if key.startswith("heg") else DB
            mesh = WS_HEG_MESH if db == "heg" else WS_MESH
            if any(res[r]["zoo"][f"{key} {name}"]["stats"] != e["stats"] for r in range(n)):
                fail(f"ws (b): {key} {name}: the ranks counted different exchanges or "
                     f"all-reduces: {[res[r]['zoo'][f'{key} {name}']['stats'] for r in range(n)]}")
            if e["classes"] < 2:
                fail(f"ws (b): {key} {name}: the one-process maps hold {e['classes']} class")
            st = e["stats"]
            print(f"ws (b) [{card}]: {key} ({impl} CNN branch) {db} {name} batch {BATCH} on the "
                  f"{mesh} mesh, blocks {e['blocks']}: maps vs one process agree on "
                  f"{e['agree']:.6f} of pixels (threshold {threshold}), bitwise "
                  f"{e['bitwise']}; launches a rank {e['counts']}; halo exchanges "
                  f"{st.get('exchanges', 0)} ({st.get('bytes', 0)} bytes a rank sent), "
                  f"all-reduces {st.get('reduces', 0)} ({st.get('reduce_bytes', 0)} bytes); "
                  f"{e['wall_s']:.2f} s (four processes sharing one card: no speed is claimed)",
                  flush=True)
            if e["agree"] < threshold:
                fail(f"ws (b): {key} {name}: maps agree with one process's on {e['agree']}, "
                     f"below {threshold}")
            if impl == "fused" and name == "f32" and not e["bitwise"]:
                fail(f"ws (b): {key} f32: the fused shard's maps are not bitwise one "
                     f"process's (agreement {e['agree']})")
    for e in report["kernels"]:
        if e["name"] == "metapool_block_shard":
            e["launches"] = res[0]["bf16"]["counts"]["metapool_block_shard"]
            if e["launches"] == 0:
                fail("ws (b): the shard site was not launched on the width-sharded path")
        if e["name"] == "fused_cross_block":
            e["ws_launches"] = zoo["fused bf16"]["counts"].get("fused_cross_block", 0)
            if e["ws_launches"] != 5:
                fail(f"ws (b): K4 launched {e['ws_launches']} times a rank on the fused "
                     f"width-sharded batch, expected 5")
    print(f"ws [{card}]: the width-sharded predictor in {time.perf_counter() - t_phase:.1f} s "
          f"((b) {time.perf_counter() - t0:.1f} s)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        root = os.path.abspath(sys.argv[2])
    sys.path.insert(0, root)
    try:
        from tcct_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"run from the root of a checkout: cannot import tcct_tpu_torch ({e})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-exported":  # drive_export's fresh process
        serve_exported(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--dp-worker":  # drive_distributed's ranks
        dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0
    if len(sys.argv) == 5 and sys.argv[1] == "--ws-worker":  # drive_width_sharded's ranks
        ws_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
        return 0

    card = card_identity()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {build.sources()} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    if len(sys.argv) == 3 and sys.argv[1] == "--profile":
        serve_diagnostics(card)
        train_diagnostics(card)
        dispatch_diagnostics(card)
        return 0
    if len(sys.argv) >= 3 and sys.argv[1] == "--against":
        compare_against(sys.argv[2], card, sys.argv[3:])
        return 0
    if len(sys.argv) > 1:
        fail(f"usage: chip_smoke.py [--against DIR [NAME ...] | --profile DIR | "
             f"--serve-exported PROGRAM OUT | --dp-worker RANK STORE OUT | "
             f"--ws-worker RANK STORE OUT], not {sys.argv[1:]}")

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.models.mpvit import MPViTConfig, mpvit_small_config

    vit = MPViTConfig()
    serve = path_shapes(vit, BATCH, get_geometry(DB).prep_hw)
    serve_small = path_shapes(mpvit_small_config(), BATCH, get_geometry(DB).prep_hw)
    train, gtc, task2 = step_tables()
    report = {"per_batch_launches": {"metapool_block": sum(serve[0].values()),
                                     "dwconv3x3_s1": sum(serve[1].values()),
                                     "dwconv3x3_s2": sum(serve[2].values())}}
    train_counts = train_launches(_zoo_model("stc_tt"))
    print(f"kernels vs plain versions at the {DB} serving shapes (batch {BATCH}) and the "
          f"stc_tt and gtc_tt train-step shapes (batch {TRAIN_BATCH}, "
          f"{TRAIN_HW[0]}x{TRAIN_HW[1]}) [{card}]:", flush=True)
    bench_kernels(report, kernel_tables(serve, train, serve_small, gtc, task2))
    check_bn_capture()
    bench_convposenc_backward(report, card, cpe_shapes(vit, TRAIN_BATCH, TRAIN_HW))
    bench_dwconv_variants(card)
    bench_convposenc(report, card, cpe_shapes(vit, BATCH, get_geometry(DB).prep_hw),
                     cpe_shapes(mpvit_small_config(), BATCH, get_geometry(DB).prep_hw))
    bench_metapool_block(report, card, serve[0], serve_small[0])
    bench_fused_block(report, card)
    plain = drive_slice(report, card)
    one_process_maps = {"bf16": plain["seg"], "f32": plain["seg32"]}
    drive_export(card, plain)
    drive_fused(report, card, plain)
    del plain
    drive_both_ways("gtc_tb", card)
    drive_zoo(card)
    drive_buckets(card)
    check_train_f32_card_vs_cpu()
    drive_train(report, card, train_counts)
    check_train_trajectory()
    drive_engine(report, card, train_counts, report["per_batch_launches"])
    drive_gtc_train(report, card)
    drive_zoo_steps(card)
    drive_zoo_serving(card)
    drive_task2(report, card)
    drive_distributed(report, card, train)
    drive_width_sharded(report, card, serve[0], one_process_maps)

    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
