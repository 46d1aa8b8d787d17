"""Readings from which a cell's limits are set (not run by the benchmark's
runs).

    python3 portbench/control.py --workload <name> --seeds 1,2,... [--control-seeds 7,8,9]

For each seed of ``--seeds`` it drives the program as a run does, without the
measured window (serving: the sampled volumes, served at the cell's batch;
training: the first steps that set-up drives) and prints the compared numbers
of the check: the lower readings.  For each seed of ``--control-seeds`` it
prints the same numbers of the control, the reference computed in bf16 with
fp8 convolutions and linear layers in the program's place
(``reference/control.py``): the upper readings; of the reference computed in
bf16 alone, the program's precision: a second witness of the lower ones; and
for a training cell those of the program fed half of each batch (a fault).
One JSON line each.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def serve_readings(drv, cell, seed, device, low: bool) -> dict:
    pred, pool, nc, weights = drv.build(cell, seed, device)
    t = cell["traffic_file"]
    served = drv.Served(t["sample_volumes"], seed)
    drv.serve(pred, pool, served, n=t["sample_volumes"])
    del pred
    out = {"program": drv.check(cell, device, pool, served.sample, nc, weights)}
    if low:
        for mode in ("control", "bf16"):
            out[mode] = drv.check(cell, device, pool, served.sample, nc, weights, mode)
    return out


def train_readings(drv, cell, seed, device, low: bool) -> dict:
    t = cell["traffic_file"]
    model, opt, step, gen, imgs, labs, nc = drv.build(cell, seed, device)
    first = drv.first_steps(model, opt, step, gen, imgs, labs, t["check_steps"])
    out = {"program": drv.check(cell, seed, device, first, imgs, labs, nc)}
    del model, opt, step
    if low:
        out.update(drv.control_readings(cell, seed, device, first, imgs, labs, nc))
        model, opt, step, gen, imgs, labs, nc = drv.build(cell, seed, device)
        half = t["batch"] // 2

        def half_step(a, b):  # the fault: half of the batch left out
            return step(a[:half], b[:half])

        bad = drv.first_steps(model, opt, half_step, gen, imgs, labs, t["check_steps"])
        out["half_batch"] = drv.check(cell, seed, device, bad, imgs, labs, nc)
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    harness.fix_caches()
    cell = harness.load_cell(args.workload)
    if args.device == "cuda":
        from tcct_tpu_torch.ops.kernels.build import build_all

        build_all()
    drv = harness.driver(cell["traffic_file"]["driver"])
    fn = serve_readings if getattr(drv, "SERVES_VOLUMES", False) else train_readings
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, low in seeds:
        t0 = time.perf_counter()
        out = fn(drv, cell, seed, args.device, low)
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
