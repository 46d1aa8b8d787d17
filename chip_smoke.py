#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tcct_tpu_torch``) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``):

1. prints the card's name and power limit (``nvidia-smi``) and builds
   every kernel of ``tcct_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once);
2. holds each kernel (MetaPool forward and backward, depthwise 3x3
   forward and backward at strides 1 and 2, train BatchNorm) against its
   plain PyTorch version on the card, at every shape the duke serving
   path and the train step give it, in bf16 and in f32 (TF32 off), and
   times kernel, plain version and the one-call PyTorch yardstick on the
   device (CUDA-graph replay, inputs beyond L2);
3. serves a 20-scan seeded duke volume through ``load_predictor`` at full
   width (random-init weights, batch 8, bf16) with the launch counts set
   to 0 just before and read just after, checks the class maps (shape,
   dtype, agreement with the f32 predictor) and the f32 model against the
   CPU path on a small input, and times the steady state;
4. holds the f32 train step on the card against the CPU path on the
   golden 64x64 parity case (step-0 gradients, one AdamW step);
5. trains ``RegNet(stc_tt, 'train')`` at full width (bf16, batch 8 at
   256x256, seeded random weights and a seeded banded batch) for 5 steps
   with the launch counts read around the first, checks every loss is
   finite, and prints ms/step, peak memory and the profile of a sixth;
6. prints one JSON line of the kernels, then, as its last line,
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line.  Without a CUDA card, or
outside a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

# H100 SXM published peaks (NVIDIA data sheet), the denominators of bound_ms
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

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
    dwconv stride 2 [B,H,W,C])."""
    mp, s1, s2 = Counter(), Counter(), Counter()
    h, w = (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1  # after the stride-2 stem
    for i, C in enumerate(cfg.embed_dims):
        for p in range(cfg.num_path[i]):
            if i > 0 and p == 0:  # the stride-2 patch embed of a pooling stage
                s2[(batch, h, w, C)] += 1
                h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
            else:
                s1[(batch, h, w, C)] += 1
        s1[(batch, h, w, C)] += cfg.num_path[i] * cfg.num_layers[i] + 1  # cpe per block, InvRes
        mp[(batch, h * w, C)] += cfg.num_path[i] * cfg.num_layers[i]
    return mp, s1, s2


def check_close(name, got, want, dtype_name):
    import torch

    atol, rtol = TOL[dtype_name]
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


def train_shapes(cfg, batch: int, hw, n_class: int):
    """Launch counts per train step, by (input shape, dtype), of every kernel
    of the stc_tt train step with the MetaPool mixer, bf16 compute, loss
    heads on (udh, reg).  Forward and backward counts are equal: every
    launch of the forward is on the gradient's path.  Returns a dict of
    Counters: metapool [B,N,C], dwconv s1 / s2 [B,H,W,C] (NHWC inputs), and
    bn [B,C,H,W] with a leaky flag."""
    bf, f32 = "bfloat16", "float32"
    mp, s1, s2 = (Counter({(k, bf): n for k, n in c.items()}) for c in path_shapes(cfg, batch, hw))
    H, W = hw
    # RegNet loss heads at full resolution: lap_reg (C = n_class - 1) on the
    # bf16 logits and on the f32 one-hot; lap_map's two 1-channel convs on
    # both f32 column-softmax maps
    s1[((batch, H, W, n_class - 1), bf)] += 2
    s1[((batch, H, W, n_class - 1), f32)] += 2
    s1[((batch, H, W, 1), f32)] += 4
    bn = Counter()
    lvl = [(H, W)]  # after each stride-2 conv
    for _ in range(4):
        lvl.append(tuple((v - 1) // 2 + 1 for v in lvl[-1]))
    cnn = 32  # tiny CrossCNN: 32 channels at every level
    bn[((batch, cnn) + lvl[0], False, bf)] += 1  # cnn.1
    for i in range(5):
        bn[((batch, cnn) + (H >> i, W >> i), True, bf)] += 3  # LeakyReLU -> BN, fused
    ed = cfg.embed_dims
    bn[((batch, ed[0] // 2) + lvl[1], False, bf)] += 1  # stem
    bn[((batch, ed[0]) + lvl[1], False, bf)] += 1
    for i in range(cfg.num_stages):
        res = lvl[i + 1]
        bn[((batch, ed[i]) + res, False, bf)] += cfg.num_path[i] + 3  # patch embeds, InvRes
        out = ed[i + 1] if i + 1 < cfg.num_stages else ed[i]
        bn[((batch, out) + res, False, bf)] += 1  # aggregate
    for i in range(4):
        bn[((batch, cnn) + lvl[i + 1], False, bf)] += 2  # tran_vit / tran_cnn projections
    bn[((batch, cnn) + lvl[4], False, bf)] += 2  # head, dec1
    for i in (3, 2, 1):
        bn[((batch, cnn) + lvl[i], False, bf)] += 1  # dec2 .. dec4
    bn[((batch, 1, H, W), False, f32)] += 2  # lap_map's eps-1.0 BN, twice
    return {"mp": mp, "s1": s1, "s2": s2, "bn": bn}


def _table(name, src, replaces, rows):
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces, "rows": rows}


def kernel_tables(serve, train):
    """The kernels, each with its wrapper, plain version, one-call library
    yardstick, input maker, check, bytes and operations, and the shapes of
    the serving batch and of the train step."""
    import torch
    import torch.nn.functional as F

    from tcct_tpu_torch.ops.kernels.bnstats import (
        bn_act_train,
        bn_normalize_reference,
        bn_stats_reference,
    )
    from tcct_tpu_torch.ops.kernels.dwconv import (
        dwconv3x3,
        dwconv3x3_backward,
        dwconv3x3_backward_reference,
        dwconv3x3_reference,
    )
    from tcct_tpu_torch.ops.kernels.metapool import metapool_tokens, metapool_tokens_backward
    from tcct_tpu_torch.ops.pool import (
        metapool_tokens_backward_reference,
        metapool_tokens_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    def out_hw(shape, s):
        return (shape[1] - 1) // s + 1, (shape[2] - 1) // s + 1

    # --- K1 / K1b ------------------------------------------------------------
    def mp_args(shape, dtype):
        return (randn(shape, dtype),)

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

    def mp_cost(args):
        x = args[0]
        return 2 * x.numel() * x.element_size(), 11 * x.numel()

    # --- K2 / K2b ------------------------------------------------------------
    def dw_args(stride, bwd):
        def make(shape, dtype):
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
            dx, dw = dwconv3x3_backward(x, w, g, stride)
            torch.cuda.synchronize()
            rdx, _ = dwconv3x3_backward_reference(x, w, g, stride)
            err = check_close(name + " dx", dx, rdx, dn)
            # dw sums B*Ho*Wo products: 1e-5 of sum|x*g| per tap (summation
            # order), plus one bf16 rounding, against the plain version in f32
            ref32 = dwconv3x3_backward_reference(x.float(), w.float(), g.float(), stride)[1]
            mag = dwconv3x3_backward_reference(x.float().abs(), w.float(), g.float().abs(),
                                               stride)[1]
            lim = 1e-5 * mag + 1e-6 + (2.0 ** -7 * ref32.abs() if dn == "bfloat16" else 0)
            check_within(name + " dw", dw, ref32, lim)
            _, dw2 = dwconv3x3_backward(x, w, g, stride)
            if not torch.equal(dw, dw2):
                fail(f"{name}: dw differs between two runs")
            return err
        return check

    def dw_cost(stride):
        def cost(args):
            x = args[0]
            Ho, Wo = out_hw(x.shape, stride)
            n_out = x.shape[0] * Ho * Wo * x.shape[3]
            if len(args) == 2:
                return (x.numel() + n_out + 9 * x.shape[3]) * x.element_size(), 18 * n_out
            # x, g read; dx written; taps read, dw written; 18 flops each for dx and dw
            return (2 * x.numel() + n_out + 18 * x.shape[3]) * x.element_size(), 36 * n_out
        return cost

    # --- K3 --------------------------------------------------------------------
    def bn_args(leaky):
        def make(shape, dtype):
            C = shape[1]
            x = randn(shape, dtype, 2.0, 0.5).contiguous(memory_format=torch.channels_last)
            w = (torch.rand(C, generator=gen, device=dev) + 0.5).to(dtype)
            return (x, w, randn((C,), dtype, 0.1))
        return make

    def bn_kern(leaky):
        return lambda x, w, b: bn_act_train(x, w, b, 1e-5, leaky)

    def bn_plain(leaky):
        def f(x, w, b):
            mean, var = bn_stats_reference(x, leaky)
            return bn_normalize_reference(x, mean, var, w, b, 1e-5, leaky)
        return f

    def bn_lib(leaky):
        def f(x, w, b):
            t = F.leaky_relu(x, 0.01) if leaky else x
            return F.batch_norm(t, None, None, w, b, training=True, momentum=0.1, eps=1e-5)
        return f

    def bn_check(leaky):
        def check(name, args, dn):
            x, w, b = args
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
        return 2 * x.numel() * x.element_size() + 16 * x.shape[1], 8 * x.numel()

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
    bn_rows = [(bn_spec(leaky), Counter(), Counter({(shape, d): n}))
               for (shape, leaky, d), n in sorted(train["bn"].items())]
    return [
        _table("metapool_tokens", mp_src, "tcct_tpu/ops/pallas/metapool.py:64",
               [(mp_fwd, serve_rows(serve[0]), train["mp"])]),
        _table("dwconv3x3_s1", dw_src, "tcct_tpu/ops/pallas/dwconv.py:200",
               [(dw_fwd(1), serve_rows(serve[1]), train["s1"])]),
        _table("dwconv3x3_s2", dw_src, "tcct_tpu/ops/pallas/dwconv.py:380",
               [(dw_fwd(2), serve_rows(serve[2]), train["s2"])]),
        _table("metapool_tokens_backward", mp_src, "tcct_tpu/ops/pallas/metapool.py:64",
               [(mp_bwd, Counter(), train["mp"])]),
        _table("dwconv3x3_backward_s1", dw_src, "tcct_tpu/ops/pallas/dwconv.py:220",
               [(dw_bwd(1), Counter(), train["s1"])]),
        _table("dwconv3x3_backward_s2", dw_src, "tcct_tpu/ops/pallas/dwconv.py:420",
               [(dw_bwd(2), Counter(), train["s2"])]),
        _table("bn_act_train", "tcct_tpu_torch/csrc/bnstats.cu",
               "tcct_tpu/ops/pallas/bnstats.py:129", bn_rows),
    ]


def bench_kernels(report, tables):
    """Each kernel against its plain version, in bf16 and in f32 (TF32 off),
    at every shape of the serving batch and of the train step, timed
    against the plain version and the library yardstick.  The totals of a
    row weight each shape by its launches on its path, at the path's dtype:
    ``ms`` etc. per serving batch for the forward kernels of the serving
    path, per train step for the train-only kernels (``train_ms`` gives the
    forward kernels' train-step totals)."""
    import torch

    entries = []
    for t in tables:
        name = t["name"]
        tot = Counter()
        max_err = 0.0
        for sp, serve, train in t["rows"]:
            shapes = sorted({k[0] for k in serve} | {k[0] for k in train})
            for shape in shapes:
                for dtype in (torch.bfloat16, torch.float32):
                    dn = str(dtype).split(".")[-1]
                    n_serve, n_train = serve.get((shape, dn), 0), train.get((shape, dn), 0)
                    args = sp["make"](shape, dtype)
                    label = f"{name}{sp['tag']} {list(shape)} {dn}"
                    err = sp["check"](label, args, dn)
                    max_err = max(max_err, err)
                    nbytes, flops = sp["cost"](args)
                    copies = [tuple(a.clone() for a in args) for _ in range(n_copies(nbytes))]
                    t_k = device_ms(sp["kern"], copies)
                    t_p = device_ms(sp["plain"], copies)
                    t_l = device_ms(sp["lib"], copies)
                    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                    b_ops = flops / F32_FLOP_PER_S * 1e3
                    bound = max(b_bytes, b_ops)
                    per = (f" x{n_serve}/batch" if n_serve else "") + \
                          (f" x{n_train}/step" if n_train else "")
                    print(f"  {label}{per}: max_abs_err {err:.3e} kernel {t_k * 1e3:.1f} us, "
                          f"plain {t_p * 1e3:.1f} us, library {t_l * 1e3:.1f} us, "
                          f"bound {bound * 1e3:.1f} us "
                          f"({'bytes' if b_bytes >= b_ops else 'operations'}), "
                          f"{b_bytes / t_k * 100:.0f}% of the byte bound", flush=True)
                    for prefix, n in (("serve_", n_serve), ("train_", n_train)):
                        tot[prefix + "ms"] += n * t_k
                        tot[prefix + "plain_ms"] += n * t_p
                        tot[prefix + "library_ms"] += n * t_l
                        tot[prefix + "bound_ms"] += n * bound
                        tot[prefix + "bytes_ms"] += n * b_bytes
                        tot[prefix + "ops_ms"] += n * b_ops
                    del copies, args
        main = "serve_" if tot["serve_ms"] > 0 else "train_"
        entry = {
            "name": name, "route": t["route"], "source": t["source"], "replaces": t["replaces"],
            "launches": 0, "max_abs_err": max_err,
            "ms": tot[main + "ms"], "plain_ms": tot[main + "plain_ms"],
            "bound_ms": tot[main + "bound_ms"],
            "bound_by": "bytes" if tot[main + "bytes_ms"] >= tot[main + "ops_ms"] else "operations",
            "library_ms": tot[main + "library_ms"],
        }
        if main == "serve_":
            entry.update(train_ms=tot["train_ms"], train_plain_ms=tot["train_plain_ms"],
                         train_bound_ms=tot["train_bound_ms"],
                         train_library_ms=tot["train_library_ms"])
        entries.append(entry)
    report["kernels"] = entries


def _counted():
    """(row name, wrapper, attribute) of every launch count."""
    from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train
    from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3, dwconv3x3_backward
    from tcct_tpu_torch.ops.kernels.metapool import metapool_tokens, metapool_tokens_backward

    return [("metapool_tokens", metapool_tokens, "launches"),
            ("dwconv3x3", dwconv3x3, "launches"), ("dwconv3x3_s2", dwconv3x3, "launches_s2"),
            ("metapool_tokens_backward", metapool_tokens_backward, "launches"),
            ("dwconv3x3_backward", dwconv3x3_backward, "launches"),
            ("dwconv3x3_backward_s2", dwconv3x3_backward, "launches_s2"),
            ("bn_act_train", bn_act_train, "launches")]


def reset_counters() -> None:
    for _, fn, attr in _counted():
        setattr(fn, attr, 0)


def read_counters():
    """Launches by kernel row since the last reset (stride 1 = all - stride 2)."""
    raw = {name: getattr(fn, attr) for name, fn, attr in _counted()}
    return {
        "metapool_tokens": raw["metapool_tokens"],
        "dwconv3x3_s1": raw["dwconv3x3"] - raw["dwconv3x3_s2"],
        "dwconv3x3_s2": raw["dwconv3x3_s2"],
        "metapool_tokens_backward": raw["metapool_tokens_backward"],
        "dwconv3x3_backward_s1": raw["dwconv3x3_backward"] - raw["dwconv3x3_backward_s2"],
        "dwconv3x3_backward_s2": raw["dwconv3x3_backward_s2"],
        "bn_act_train": raw["bn_act_train"],
    }


def drive_slice(report, card):
    import numpy as np
    import torch

    from tcct_tpu_torch.infer.predictor import load_predictor

    t0 = time.perf_counter()
    pred = load_predictor(DB, batch_size=BATCH, dtype=torch.bfloat16, device="cuda", seed=SEED)
    H, W = pred.geo.prep_hw
    vol = np.random.default_rng(SEED).integers(0, 256, (N_SCANS, H, W, 3), dtype=np.uint8)
    print(f"slice: load_predictor({DB!r}) bf16 batch {BATCH}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the main path, with the launch counts read around it
    reset_counters()
    seg = pred.predict_scans(vol)
    torch.cuda.synchronize()
    counts = read_counters()
    n_batches = math.ceil(N_SCANS / BATCH)
    print(f"slice: launches over {n_batches} batches: {counts}", flush=True)
    for k, n in counts.items():
        want = n_batches * report["per_batch_launches"].get(k, 0)
        if n != want:
            fail(f"kernel {k}: {n} launches on the serving path, expected {want}")
    for e in report["kernels"]:
        if e["name"] in report["per_batch_launches"]:
            e["launches"] = counts[e["name"]]
    if seg.shape != (N_SCANS, H, W) or seg.dtype != np.uint8:
        fail(f"class map {seg.shape} {seg.dtype}, want {(N_SCANS, H, W)} uint8")
    if int(seg.max()) >= pred.geo.out_channels:
        fail(f"class index {int(seg.max())} out of range")

    # the f32 predictor on the same weights (TF32 off)
    pred32 = load_predictor(DB, batch_size=BATCH, dtype=torch.float32, device="cuda", seed=SEED)
    seg32 = pred32.predict_scans(vol)
    agree = float((seg == seg32).mean())
    print(f"slice: bf16 vs f32 class-map agreement {agree:.6f} (threshold 0.9)", flush=True)
    if agree <= 0.9:
        fail(f"bf16 vs f32 agreement {agree}")

    # the f32 model on the card against the CPU path (plain versions), small input
    model = pred32.model
    x = torch.from_numpy(np.random.default_rng(SEED + 1).random((2, 64, 128, 3), np.float32))
    with torch.inference_mode():
        got = [y.cpu() for y in model(x.cuda())]
    model.to("cpu")
    with torch.inference_mode():
        ref = model(x)
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float((g - r).abs().max())
        scale = float(r.abs().max())
        print(f"slice: f32 head {i} card vs CPU max abs err {err:.3e} (logit scale {scale:.1f})",
              flush=True)
        if not err <= 1e-3 + 1e-5 * scale:
            fail(f"head {i}: card vs CPU max abs err {err}")
    del pred32, model

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
    profile_device(lambda: pred._forward(xb), batch_ms, "one bf16 batch")


# kernel-name substrings -> the port's layer that launched them (first match)
_GROUPS = (
    ("metapool kernels (K1, K1b)", ("metapool_kernel",)),
    ("dwconv3x3 kernels (K2, K2b)", ("dwconv3x3_fwd_kernel", "dwconv3x3_bwd_kernel",
                                     "dw_finalize_kernel")),
    ("train BN kernel (K3)", ("bn_stats_kernel", "bn_finalize_kernel", "bn_norm_kernel")),
    ("layer_norm", ("layer_norm",)),
    ("bilinear upsample", ("upsample",)),
    ("max_pool", ("max_pool",)),
    ("sort (polarization bins)", ("sort", "radix")),
    ("index_add / scatter (polarization bins)", ("index", "scatter")),
    ("optimizer (foreach)", ("foreach", "multi_tensor")),
    ("reductions", ("reduce",)),
    ("cuDNN conv", ("conv", "xmma", "implicit_gemm", "nhwc", "winograd", "dgrad", "wgrad",
                    "cudnn")),
    ("matmul (Linear)", ("gemm", "cutlass", "cublas")),
    ("elementwise and copies", ("elementwise", "copy", "cat", "fill")),
)


def profile_device(fn, wall_ms: float, what: str) -> None:
    """Device time of one call of ``fn`` by kernel, grouped by layer, and the
    device's busy share of ``wall_ms``, the call's time without the
    profiler."""
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
        return
    groups = Counter()
    launches = Counter()
    for t, n, key in rows:
        low = key.lower()
        g = next((name for name, subs in _GROUPS if any(s in low for s in subs)), "other")
        groups[g] += t
        launches[g] += n
    print(f"profile: {what}: {sum(r[1] for r in rows)} kernels, device busy "
          f"{busy:.3f} ms = {busy / wall_ms * 100:.1f}% of {wall_ms:.3f} ms "
          f"(idle share {max(0.0, 1 - busy / wall_ms) * 100:.1f}%)", flush=True)
    for g, t in groups.most_common():
        print(f"  {t:8.3f} ms {t / busy * 100:5.1f}%  x{launches[g]:<5d} {g}", flush=True)
    print("profile: top kernels:", flush=True)
    for t, n, key in sorted(rows, reverse=True)[:12]:
        print(f"  {t:8.3f} ms {t / busy * 100:5.1f}%  x{n:<5d} {key[:100]}", flush=True)


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
    for k, n in counts.items():
        if n == 0:
            fail(f"kernel {k} was not launched on the train path")
        if n != train_counts[k]:
            fail(f"kernel {k}: {n} launches in one train step, expected {train_counts[k]}")
    for e in report["kernels"]:
        if e["name"] in report["per_batch_launches"]:
            e["train_launches"] = counts[e["name"]]
        else:
            e["launches"] = counts[e["name"]]
    steady = float(np.mean(times[2:]))
    print(f"train [{card}]: bf16 batch {TRAIN_BATCH} at {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
          f"steady state {steady:.2f} ms/step (mean of steps 2-{TRAIN_STEPS - 1}; "
          f"step 0 {times[0]:.1f} ms, step 1 {times[1]:.1f} ms), "
          f"{TRAIN_BATCH / steady * 1e3:.1f} B-scans/s; peak device memory {peak:.2f} GiB",
          flush=True)
    profile_device(lambda: step(imgs, labs), steady, "one bf16 train step")


def _port_slice(sd0, device):
    import torch

    from tcct_tpu_torch.models import RegNet, get_model

    m = RegNet(get_model("stc_tt", 5, variant="train", drop_path_rate=0.0), out_channels=5)
    m.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in sd0.items()}, strict=True)
    return m.to(device=device, memory_format=torch.channels_last)


def check_train_f32_card_vs_cpu() -> None:
    """The f32 train step on the card (kernels) against the CPU path (plain
    versions) on the golden 64x64 parity case: step-0 gradients per tensor
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
        TrainConfig,
        build_loss_fn,
        build_train_step,
        make_optimizer,
        trainable_parameters,
    )

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                        "train_parity.npz")
    g = np.load(path)
    sd0 = {k[len("sd0::"):]: g[k] for k in g.files if k.startswith("sd0::")}
    imgs = np.ascontiguousarray(np.moveaxis(g["x_u8"], 1, -1))
    labs = g["labels"]
    cfg = TrainConfig(n_class=5, crop_hw=(64, 64), ds=True, udh=True, reg=True, augment=False,
                      pinned_reg_noise=True)
    def step0(dev):
        m = _port_slice(sd0, dev).train()
        params = trainable_parameters(m)
        img = torch.from_numpy(imgs).to(dev).float() / 255.0
        true_oh = F.one_hot(torch.from_numpy(labs).to(dev).long(), 5).float()
        loss, _ = build_loss_fn(m, cfg)(params, dict(m.named_buffers()), img, true_oh)
        gr = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        return float(loss.detach()), {k: (torch.zeros_like(p) if x is None else x).cpu().double()
                                      .numpy() for (k, p), x in zip(params.items(), gr)}

    (loss_cpu, cpu), (loss_card, card) = step0("cpu"), step0("cuda")
    print(f"train f32 64x64: loss card {loss_card:.7f} CPU {loss_cpu:.7f}", flush=True)
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
    print(f"train f32 64x64: card step-0 gradients vs CPU: {n} tensors, worst {worst:.4f} of the "
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
        print(f"train f32 64x64: {what}: worst {worst:.4f} of the bound ({worst_k})", flush=True)

    sds = {}
    for dev in ("cpu", "cuda"):
        m = _port_slice(sd0, dev)
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
    print(f"train f32 64x64: one step card vs CPU: {n_off} of {n_el} elements more than "
          f"5% of lr apart, update L2 drift {drift:.4f}", flush=True)
    if n_off > 0.02 * n_el or drift >= 0.5:
        fail(f"f32 one step card vs CPU: {n_off}/{n_el} off, drift {drift}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from tcct_tpu_torch.ops.kernels import build
    except ImportError as e:
        fail(f"run from the root of a checkout: cannot import tcct_tpu_torch ({e})")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_identity()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {build.sources()} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build.ptxas_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.models.mpvit import MPViTConfig

    vit = MPViTConfig()
    serve = path_shapes(vit, BATCH, get_geometry(DB).prep_hw)
    train = train_shapes(vit, TRAIN_BATCH, TRAIN_HW, TRAIN_NC)
    report = {"per_batch_launches": {"metapool_tokens": sum(serve[0].values()),
                                     "dwconv3x3_s1": sum(serve[1].values()),
                                     "dwconv3x3_s2": sum(serve[2].values())}}
    per_step = {"mp": sum(train["mp"].values()), "s1": sum(train["s1"].values()),
                "s2": sum(train["s2"].values()), "bn": sum(train["bn"].values())}
    train_counts = {"metapool_tokens": per_step["mp"], "metapool_tokens_backward": per_step["mp"],
                    "dwconv3x3_s1": per_step["s1"], "dwconv3x3_backward_s1": per_step["s1"],
                    "dwconv3x3_s2": per_step["s2"], "dwconv3x3_backward_s2": per_step["s2"],
                    "bn_act_train": per_step["bn"]}
    print(f"kernels vs plain versions at the {DB} serving shapes (batch {BATCH}) and the "
          f"train-step shapes (batch {TRAIN_BATCH}, {TRAIN_HW[0]}x{TRAIN_HW[1]}) [{card}]:",
          flush=True)
    bench_kernels(report, kernel_tables(serve, train))
    drive_slice(report, card)
    check_train_f32_card_vs_cpu()
    drive_train(report, card, train_counts)

    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
