"""Training traffic: the program's train step (``build_train_step``, the CLI's
step) driven on seeded banded batches, a new batch each step from a pool
on the device, for as long as the window lasts.

Parameters (``traffic/<name>.json``): ``db`` (the class count's dataset),
``hw`` (the crop), ``batch`` (the global batch), ``dtype`` (compute; the
masters are f32), ``variant``, ``lr``, ``weight_decay``, ``clip``, ``ds``,
``udh``, ``reg``, ``augment``, ``pool`` (distinct batches), ``capture_steps``
(steps in the traced run's light capture; ``capture.capture``) and
``check_steps`` (the first steps, which set-up drives and the reference
follows).

Set-up builds one train state, drives it from the seed through its first
``check_steps`` steps (each on its own batch) and hands that state to the
window.  Before each of them it keeps the step generator's state, so that the
reference draws the same DropPath masks and boundary noise; after the first
it keeps AdamW's first moment (the first clipped gradient times 1 - b1),
after the last the parameters and BN statistics.
"""

from __future__ import annotations

import gc
import math
import time

import torch
import torch.nn.functional as F

from portbench import harness, scans
from portbench.reference import control, costs, train as ref_train

STREAM_SCANS, STREAM_WEIGHTS, STREAM_STEP = 1, 2, 3
SERVES_VOLUMES = False
B1 = 0.9
# the decoder's leaves: the U-decoder, its head and the four logit heads
DECODER = ("base.dec", "base.head", "base.aux", "base.t32")


def reference_model(cell: dict, seed: int, device, nc: int):
    t = cell["traffic_file"]
    ref = cell["reference"].RegNet(cell["config_file"], nc, t["variant"]).to(device)
    scans.fill_weights(ref, scans.generator(seed, STREAM_WEIGHTS, device))
    return ref.train()


def n_class(t: dict) -> int:
    from tcct_tpu_torch.data.geometry import get_geometry

    return get_geometry(t["db"]).out_channels


def build(cell: dict, seed: int, device):
    """The program's model, optimizer and step (``build_train_step``), the
    step's generator and the pool of batches on the device."""
    from tcct_tpu_torch.models import RegNet, get_model
    from tcct_tpu_torch.train import AdamW, TrainConfig, build_train_step

    cfg, t = cell["config_file"], cell["traffic_file"]
    nc = n_class(t)
    model = RegNet(get_model(cfg["net"], nc, variant=t["variant"],
                             drop_path_rate=cfg["drop_path_rate"], mixer=cfg["mixer"]),
                   out_channels=nc)
    harness.load_weights(model, reference_model(cell, seed, device, nc).state_dict())
    opt = AdamW(t["lr"], weight_decay=t["weight_decay"], clip_norm=t["clip"])
    tc = TrainConfig(ds=t["ds"], udh=t["udh"], reg=t["reg"], augment=t["augment"],
                     dtype=getattr(torch, t["dtype"]), n_class=nc, crop_hw=tuple(t["hw"]))
    gen = scans.generator(seed, STREAM_STEP, device)
    step = build_train_step(model, opt, tc, device=device, generator=gen)
    imgs, labs = scans.banded(t["pool"] * t["batch"], t["hw"], nc,
                              scans.generator(seed, STREAM_SCANS, device), device)
    imgs = imgs.reshape((t["pool"], t["batch"]) + imgs.shape[1:])
    labs = labs.reshape((t["pool"], t["batch"]) + labs.shape[1:])
    return model, opt, step, gen, imgs, labs, nc


def first_steps(model, opt, step, gen, imgs, labs, n: int) -> dict:
    """Drive the state through its first ``n`` steps; what the check reads."""
    from tcct_tpu_torch.train.state import trainable_parameters

    names = list(trainable_parameters(model))
    state0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gens, losses = [], []
    grads1 = None
    for i in range(n):
        gens.append(gen.get_state())
        metrics, _ = step(imgs[i], labs[i])
        losses.append(metrics["total"])
        if i == 0:
            grads1 = handed_gradient(model, opt, float(metrics["grad_norm"]))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {"state0": state0, "state": state, "gens": gens, "losses": losses,
            "grads1": dict(zip(names, grads1))}


def handed_gradient(model, opt, norm: float) -> list:
    """The gradient the first step handed to the optimizer, before its clip,
    worked out from AdamW's first moment after that step (``(1 - b1) g``,
    clipped) and the global norm the step reports; zeros where the step
    made no moment."""
    from tcct_tpu_torch.train.state import trainable_parameters

    if opt.mu is None:
        return [torch.zeros_like(p) for p in trainable_parameters(model).values()]
    unclip = norm / opt.clip_norm if norm >= opt.clip_norm else 1.0
    return [m / (1 - B1) * unclip for m in opt.mu]


def flops_per_step(cell: dict, nc: int) -> float:
    """The reference's forward and backward operations of one step on the
    global batch (FlopCounterMode on the meta device)."""
    from torch.utils.flop_counter import FlopCounterMode

    t, rm = cell["traffic_file"], cell["reference"]
    with torch.device("meta"):
        ref = rm.RegNet(cell["config_file"], nc, t["variant"]).train()
        img = torch.empty((t["batch"],) + tuple(t["hw"]) + (3,))
        true = torch.empty((t["batch"],) + tuple(t["hw"]) + (nc,))
    params = list(rm.trained_parameters(ref).values())
    with FlopCounterMode(display=False) as fc:
        total = ref_train.train_loss(ref, img, true, rm.Ctx(train=True))
        torch.autograd.grad(total, params, allow_unused=True)
    return float(fc.get_total_flops())


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
        fault=None) -> dict:
    from portbench import capture

    t = cell["traffic_file"]
    model, opt, step, gen, imgs, labs, nc = build(cell, seed, device)
    if fault is not None:
        step = fault(step, opt)
    first = first_steps(model, opt, step, gen, imgs, labs, t["check_steps"])
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    flops = flops_per_step(cell, nc) if trace else None
    sync()
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = {"i": t["check_steps"], "failed": 0, "attempted": 0, "last": None}

    def run_steps(n=None, until=None):
        t0 = time.perf_counter()
        while (n is not None and n > 0) or (until is not None and time.perf_counter() - t0 < until):
            j = state["i"] % t["pool"]
            state["attempted"] += 1
            try:
                state["last"], _ = step(imgs[j], labs[j])
            except RuntimeError:
                state["failed"] += 1
            state["i"] += 1
            n = None if n is None else n - 1
        sync()
        return time.perf_counter() - t0

    window = run_steps(until=seconds)
    done = state["attempted"] - state["failed"]
    cap = None
    if trace:
        cap = capture.capture(lambda: run_steps(n=1), t["capture_steps"], 1, sync)
        cap.paced_units, cap.paced_s = done, window
        cap.flops_per_unit = flops
        cap.peak_flops = costs.PEAK_FLOPS[t["dtype"]]
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    last = state["last"]
    if last is None or not math.isfinite(float(last["total"])):
        state["failed"] += 1
    e2e = {"train_bscans_per_s": done * t["batch"] / window, "setup_s": setup_s}
    del model, opt, step
    if cuda:
        torch.cuda.empty_cache()
    readings = check(cell, seed, device, first, imgs, labs, nc)
    return {"e2e": e2e, "capture": cap, "readings": readings, "attempted": state["attempted"],
            "failed": state["failed"], "memory_peak_bytes": peak}


def leaf_gaps(got: dict, want: dict, keys) -> list:
    """(gap, name) of each leaf, smallest first: the gap between the norms
    of the program's and the reference's leaf, as a share of the larger of
    the reference leaf's norm and the median leaf's."""
    keys = list(keys)
    gn = {k: float(torch.linalg.vector_norm(got[k].double())) for k in keys}
    wn = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    med = sorted(wn.values())[len(wn) // 2] if wn else 0.0
    return sorted((abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30), k) for k in keys)


def leaf_gap(got: dict, want: dict, keys) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    gaps = leaf_gaps(got, want, keys)
    return gaps[-1][0] if gaps else float("nan")


def median_leaf_error(got: dict, want: dict, keys) -> float:
    """The median leaf's error: the norm of the difference between the
    program's and the reference's leaf over the reference leaf's norm."""
    errs = sorted(float(torch.linalg.vector_norm(got[k].double() - want[k].double())
                        / torch.linalg.vector_norm(want[k].double())) for k in keys)
    return errs[len(errs) // 2] if errs else float("nan")


def median_leaf_gap(got: dict, want: dict, keys) -> float:
    gaps = leaf_gaps(got, want, keys)
    return gaps[len(gaps) // 2][0] if gaps else float("nan")


def reference_steps(cell: dict, seed: int, device, first: dict, imgs, labs, nc: int,
                    mode: str = "f32") -> dict:
    """The reference from the program's start, on the same batches and
    draws: in f32 (``mode='f32'``), computed in bf16 with f32 masters as the
    program is (``'bf16'``), or the control, that with fp8 convolutions and
    linear layers (``'control'``)."""
    t = cell["traffic_file"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = cell["reference"].RegNet(cell["config_file"], nc, t["variant"]).to(device).train()
    ref.load_state_dict(first["state0"])
    low = {"f32": (None, None, torch.float32), "bf16": (None, None, torch.bfloat16),
           "control": (control.fp8, control.fp8_grad, torch.bfloat16)}[mode]
    tr = ref_train.Trainer(ref, t["lr"], t["weight_decay"], t["clip"], *low,
                           trained=cell["reference"].trained_parameters)
    gen = torch.Generator(device=device)
    out = {"losses": [], "grads1": None}
    for i in range(len(first["gens"])):
        gen.set_state(first["gens"][i])
        img = imgs[i].float() / 255.0
        true = F.one_hot(labs[i].long(), nc).float()
        r = tr.step(img, true, gen)
        out["losses"].append(r["total"])
        if i == 0:
            out["grads1"] = r["grads"]
    out["state"] = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    out["names"] = tr.names
    return out


def readings_of(first: dict, ref: dict, got_grads1: dict, got_state: dict) -> dict:
    """The numbers of a train cell: the steps' losses (the worst step's and
    the first step's relative gap), the first gradient handed to the
    optimizer by its worst and its median leaf, and the decoder's median
    leaf's relative error (the norm of the difference over the reference
    leaf's norm), the parameters' change over the checked steps by its worst
    and median leaf (leaves whose reference gradient is under a thousandth
    of the median leaf's left out of all but the BN statistics), and the BN
    running statistics' change by its worst leaf."""
    g_ref = ref["grads1"]
    gnorm = {k: float(torch.linalg.vector_norm(g_ref[k].double())) for k in ref["names"]}
    med = sorted(gnorm.values())[len(gnorm) // 2]
    names = moving = [k for k in ref["names"] if gnorm[k] >= 1e-3 * med]
    s0 = first["state0"]
    d_got = {k: got_state[k].double() - s0[k].double() for k in s0}
    d_ref = {k: ref["state"][k].double() - s0[k].double() for k in s0}
    bn = [k for k in s0 if k.endswith(("running_mean", "running_var"))]
    losses = [float(v) for v in first["losses"]]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
        "loss_gap_first": abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0]),
        "grad_gap": leaf_gap(got_grads1, g_ref, names),
        "change_gap": leaf_gap(d_got, d_ref, moving),
        "bn_gap": leaf_gap(d_got, d_ref, bn),
        "grad_gap_median": median_leaf_gap(got_grads1, g_ref, names),
        "grad_error_median": median_leaf_error(got_grads1, g_ref, names),
        "grad_gap_leaf": leaf_gaps(got_grads1, g_ref, names)[-1][1],
        "change_gap_median": median_leaf_gap(d_got, d_ref, moving),
        "change_gap_leaves": [[k, g, gnorm[k] / med]
                              for g, k in leaf_gaps(d_got, d_ref, moving)[-3:]],
        "decoder_grad_error": median_leaf_error(
            got_grads1, g_ref, [k for k in names if k.startswith(DECODER)]),
    }


def check(cell: dict, seed: int, device, first: dict, imgs, labs, nc: int) -> dict:
    ref = reference_steps(cell, seed, device, first, imgs, labs, nc)
    return readings_of(first, ref, first["grads1"], first["state"])


def control_readings(cell: dict, seed: int, device, first: dict, imgs, labs, nc: int) -> dict:
    """The reference computed in lower precision in the program's place,
    against the reference in f32: ``'control'`` (fp8) and ``'bf16'`` (the
    program's precision, a second witness of the program's readings)."""
    ref = reference_steps(cell, seed, device, first, imgs, labs, nc)
    out = {}
    for mode in ("control", "bf16"):
        low = reference_steps(cell, seed, device, first, imgs, labs, nc, mode)
        out[mode] = readings_of(dict(first, losses=low["losses"]), ref, low["grads1"],
                                low["state"])
    return out
