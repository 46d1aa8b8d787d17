"""Serving traffic: one client in a closed loop hands whole uint8 OCT
volumes to the program's ``VolumePredictor.predict_volume`` and waits for
their class maps.

Parameters (``traffic/<name>.json``): ``db`` (the dataset bucket), ``hw``
(its prepped height and width), ``scans`` (B-scans a volume), ``batch``,
``dtype``, ``cnn_impl``, ``variant``, ``pool`` (distinct seeded volumes,
served in turn), ``capture_volumes`` (volumes in the traced run's light
capture; ``capture.capture``) and
``sample_volumes`` (served volumes the check compares with the reference).
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import math
import random
import sys
import time

import numpy as np
import torch

from portbench import harness, scans
from portbench.reference import control, costs

STREAM_SCANS, STREAM_WEIGHTS = 1, 2
SERVES_VOLUMES = True


def build(cell: dict, seed: int, device):
    """The program's predictor with the benchmark's weights, the pool of
    volumes (uint8 numpy, [pool, scans, H, W, 3]) and the weights as the
    reference takes them (f32, on the host)."""
    from tcct_tpu_torch.data.geometry import get_geometry
    from tcct_tpu_torch.infer.predictor import VolumePredictor
    from tcct_tpu_torch.models import RegNet, get_model

    cfg, t = cell["config_file"], cell["traffic_file"]
    geo = get_geometry(t["db"])
    if tuple(geo.prep_hw) != tuple(t["hw"]):
        geo = dataclasses.replace(geo, prep_hw=tuple(t["hw"]))
    nc = geo.out_channels
    imgs, _ = scans.banded(t["pool"] * t["scans"], t["hw"], nc,
                           scans.generator(seed, STREAM_SCANS, device), device)
    weights = reference_weights(cell, seed, device, nc, imgs[:t["batch"]])
    model = RegNet(get_model(cfg["net"], nc, variant=t["variant"],
                             drop_path_rate=cfg["drop_path_rate"], mixer=cfg["mixer"]),
                   out_channels=nc)
    harness.load_weights(model, weights)
    pred = VolumePredictor(model, geo, batch_size=t["batch"], dtype=getattr(torch, t["dtype"]),
                           device=device, cnn_impl=t["cnn_impl"])
    pool = imgs.cpu().numpy().reshape((t["pool"], t["scans"]) + imgs.shape[1:])
    return pred, pool, nc, weights


def reference_weights(cell: dict, seed: int, device, nc: int, calib) -> dict:
    """The benchmark's weights: seeded (``scans.fill_weights``), the
    BatchNorm statistics calibrated on the uint8 NHWC batch ``calib`` in f32
    (the cell's reference's ``calibrate``), all rounded to the serving type.
    A state dict of f32 tensors on the host."""
    t, rm = cell["traffic_file"], cell["reference"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = rm.RegNet(cell["config_file"], nc, t["variant"]).to(device)
    scans.fill_weights(ref, scans.generator(seed, STREAM_WEIGHTS, device))
    rm.calibrate(ref, calib.permute(0, 3, 1, 2).float() / 255.0)
    dt = getattr(torch, t["dtype"])
    return {k: (v.to(dt).float() if v.is_floating_point() else v).cpu()
            for k, v in ref.state_dict().items()}


def reference(cell: dict, weights: dict, device, nc: int):
    ref = cell["reference"].RegNet(cell["config_file"], nc, cell["traffic_file"]["variant"])
    ref.load_state_dict(weights)
    return ref.to(device).eval()


class Served:
    """What the window served: every volume's latency, the counts, and a
    uniform sample of ``k`` completed volumes' maps drawn from the seed (a
    reservoir, so that the host holds ``k`` volumes' maps, not all)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.lat, self.sample = [], []
        self.done = self.failed = 0

    def add(self, idx: int, maps, seconds: float) -> None:
        self.lat.append(seconds)
        if maps is None:
            self.failed += 1
            return
        self.done += 1
        if len(self.sample) < self.k:
            self.sample.append((idx, maps))
        else:
            j = self.rng.randrange(self.done)
            if j < self.k:
                self.sample[j] = (idx, maps)


def serve(pred, pool, served: Served, seconds: float = None, n: int = None) -> float:
    """Serve volumes of ``pool`` in turn, ``n`` of them or for ``seconds``
    (no volume starts after the window's end); returns the seconds taken."""
    t0 = time.perf_counter()
    while (n is not None and n > 0) or (seconds is not None
                                        and time.perf_counter() - t0 < seconds):
        i = (served.done + served.failed) % len(pool)
        a = time.perf_counter()
        try:
            maps = pred.predict_volume(pool[i])
        except RuntimeError:
            maps = None
        served.add(i, maps, time.perf_counter() - a)
        n = None if n is None else n - 1
    return time.perf_counter() - t0


def flops_per_batch(cell: dict, nc: int) -> float:
    """The reference's forward operations of one batch (FlopCounterMode on
    the meta device)."""
    from torch.utils.flop_counter import FlopCounterMode

    t, rm = cell["traffic_file"], cell["reference"]
    with torch.device("meta"):
        ref = rm.RegNet(cell["config_file"], nc, t["variant"]).eval()
        x = torch.empty((t["batch"], 3) + tuple(t["hw"]))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.base.run(x, rm.Ctx())
    return float(fc.get_total_flops())


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None) -> dict:
    """One run: set-up, the window (traced or not), then the check."""
    from portbench import capture

    t = cell["traffic_file"]
    t_build = time.perf_counter()
    pred, pool, nc, weights = build(cell, seed, device)
    if fault is not None:
        fault(pred)
    cuda = pred.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    t_warm = time.perf_counter()
    for k in range(2):  # every shape the window uses: whole and padded batches
        pred.predict_volume(pool[k % len(pool)])
    flops = flops_per_batch(cell, nc) if trace else None
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: set-up {setup_s:.3f} s: imports, the card and the kernels "
          f"{t_build - t_start:.3f}, weights, pool and model {t_warm - t_build:.3f}, "
          f"warm-up {t_start + setup_s - t_warm:.3f}", file=sys.stderr)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    served = Served(t["sample_volumes"], seed)
    window = serve(pred, pool, served, seconds=seconds)
    done, lat = served.done, list(served.lat)
    print(f"portbench: {done} volumes in {window:.3f} s, median "
          f"{float(np.median(lat)) * 1e3:.2f} ms", file=sys.stderr)
    cap = None
    if trace:
        per = math.ceil(t["scans"] / t["batch"])
        cap = capture.capture(lambda: serve(pred, pool, served, n=1), t["capture_volumes"], per,
                              sync)
        cap.paced_units, cap.paced_s = done * per, window
        cap.flops_per_unit = flops
        cap.peak_flops = costs.PEAK_FLOPS[t["dtype"]]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    e2e = {"serve_bscans_per_s": done * t["scans"] / window,
           "volume_ms_p95": float(np.percentile(np.array(lat) * 1e3, 95)),
           "setup_s": setup_s}
    del pred
    if cuda:
        torch.cuda.empty_cache()
    readings = check(cell, device, pool, served.sample, nc, weights)
    return {"e2e": e2e, "capture": cap, "readings": readings,
            "attempted": served.done + served.failed, "failed": served.failed,
            "memory_peak_bytes": peak}


def check(cell: dict, device, pool, sample: list, nc: int, weights: dict, mode=None) -> dict:
    """The compared numbers of the sampled served maps (``sample``: (pool
    index, maps) pairs), by
    the reference's f32 logits: the share of pixels whose served class is not
    the reference's best (``map_mismatch_share``), and the gap by which the
    reference's logit of a served class lies below its best, in units of the
    reference logits' standard deviation, widest (``map_logit_gap``) and mean
    (``map_gap_mean``).  ``mode`` puts the reference computed in bf16
    (``'bf16'``) or the control (``'control'``, bf16 with fp8 convolutions and
    linear layers) in the served maps' place."""
    t, rm = cell["traffic_file"], cell["reference"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference(cell, weights, device, nc)
    low = None if mode is None else copy.deepcopy(ref).to(torch.bfloat16)
    ctx_low = rm.Ctx(control.fp8 if mode == "control" else None)
    gap = gsum = miss = 0.0
    s1 = s2 = n = 0.0
    with torch.no_grad():
        for idx, maps in sample:
            vol = pool[idx]
            for b in range(0, vol.shape[0], t["batch"]):
                x = torch.from_numpy(vol[b:b + t["batch"]]).to(device)
                x = x.permute(0, 3, 1, 2).float() / 255.0
                logits = ref.base.run(x, rm.Ctx())[0].double()  # [b, C, H, W]
                if low is None:
                    got = torch.from_numpy(maps[b:b + t["batch"]]).to(device).long()
                else:
                    got = low.base.run(x.to(torch.bfloat16), ctx_low)[0].argmax(1)
                best = logits.max(1).values
                g = best - torch.gather(logits, 1, got[:, None])[:, 0]
                gap = max(gap, float(g.max()))
                gsum += float(g.sum())
                miss += float((g > 0).sum())
                s1 += float(logits.sum())
                s2 += float((logits * logits).sum())
                n += logits.numel()
    if not n:
        return {"map_logit_gap": float("nan"), "map_gap_mean": float("nan"),
                "map_mismatch_share": float("nan")}
    std = math.sqrt(max(s2 / n - (s1 / n) ** 2, 0.0))
    pixels = n / nc
    return {"map_logit_gap": gap / std, "map_gap_mean": gsum / pixels / std,
            "map_mismatch_share": miss / pixels}
