"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It loads and warms up the cell (set-up), measures for ``--seconds``, checks
what the timed path produced against the plain reference in
``portbench/reference/``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics from a profiler
capture), ``device`` (and traced ``breakdown``), and last ``checks``, each
compared number beside its limit.  The compared numbers are also the last
lines on standard error.

It runs only on NVIDIA cards: without as many as the cell asks for it exits
with code 1 and prints no result.  It exits with code 2, and no result, if
JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.fix_caches()
    harness.few_threads()
    try:
        cell = harness.load_cell(args.workload)
        line = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    except harness.CellError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    if line is None:
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}: the benchmark measures the PyTorch port "
              "alone", file=sys.stderr)
        return 2
    harness.print_checks(line["checks"])
    print(json.dumps(line), flush=True)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", fault=None):
    """One run of ``cell``: the result line, or None where the card check
    fails (``device='cuda'``).  Tests pass ``device='cpu'`` and a ``fault``
    that breaks the timed path."""
    chips = int(cell["chips"])
    if device == "cuda":
        why = harness.require_cards(chips)
        if why is not None:
            print(f"portbench: {why}", file=sys.stderr)
            return None
        from tcct_tpu_torch.ops.kernels.build import build_all

        build_all()
    drv = harness.driver(cell["traffic_file"]["driver"])
    out = drv.run(cell, seed, seconds, trace, device, t_start, fault=fault)
    if out["capture"] is not None:  # what readers that rebuild the program take
        out["capture"].cell, out["capture"].seed, out["capture"].device = cell, seed, device
    checks = harness.compare(out["readings"], cell["limits"])
    outcome = {"e2e": out["e2e"], "capture": out["capture"], "checks": checks,
               "correct": harness.passed(checks) and out["failed"] == 0,
               "attempted": out["attempted"], "failed": out["failed"],
               "device": harness.device_entry(chips, out["memory_peak_bytes"])}
    return harness.result_line(cell, outcome, trace)


if __name__ == "__main__":
    sys.exit(main())
