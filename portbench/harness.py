"""What every cell's run shares: finding the cell and its files by name,
the card check, the caches inside the checkout, the per-layer readers, the
guard against the JAX package, and the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its files are
found by name under ``portbench/``:

- ``configs/<config>.json`` - the model's sizes as they are run;
  ``reference`` names the module ``reference/<reference>.py`` of its plain
  reference (``model`` where the key is absent);
- ``traffic/<traffic>.json`` - the traffic mix: ``driver`` names a module of
  ``drivers/``, the rest are that driver's parameters;
- ``limits/<workload>.json`` - the limit of each number the correctness
  check compares, with the readings it was set from;
- ``metrics/<metric>.py`` - one reader per per-layer metric (or one that
  metrics differing only in their last dotted part share): ``read(capture)``
  returns the value, or None where the capture holds nothing to read.
  ``run.py`` hands each capture the run's ``cell``, ``seed`` and ``device``,
  for readers that rebuild the program (``spans.py``).

A reference module (``load_cell`` puts it in the cell as ``reference``) is
plain PyTorch that imports nothing of the program; it may import from the
other modules of ``reference/`` (a variant of ``model.py`` is a small file).
It offers what the drivers call:

- ``RegNet(cfg, n_class, variant)`` - the model, every state-dict name the
  program's (``load_weights`` raises where they differ); ``.base.run(x,
  ctx)`` runs its forward on NCHW ``x`` and returns ``(logits, ...)``;
- ``Ctx(quant=None, train=False, generator=None, quant_grad=None)`` - what a
  forward shares with its layers (the control's roundings, batch statistics);
- ``calibrate(model, x)`` - sets every BatchNorm's running statistics to
  those of its input in one train-mode forward of ``x``;
- for a train cell, ``trained_parameters(model)`` - the parameters a step
  moves, by name; ``reference/train.py`` builds ``model.py``'s ``Ctx``, so
  such a module keeps that one.

A driver that serves volumes says so (``SERVES_VOLUMES = True``): its traced
runs get the span passes, and ``control.py`` reads its cells as serving.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names the process must not hold once the window has
# closed: JAX and the JAX package (compared whole: the port's name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tcct_tpu")


class CellError(RuntimeError):
    """The cell, or one of its files, is missing or malformed."""


def _json(path: str) -> dict:
    if not os.path.isfile(path):
        raise CellError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its
    configuration, traffic, limits and the metrics it reports."""
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = dict(cells[workload])
    cell["config_file"] = _json(os.path.join(BENCH_DIR, "configs", cell["config"] + ".json"))
    cell["reference"] = reference(cell["config_file"].get("reference", "model"))
    cell["traffic_file"] = _json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"))
    cell["limits"] = _json(os.path.join(BENCH_DIR, "limits", workload + ".json"))
    cell["end_to_end"] = [m for m in bench["end_to_end"]
                          if workload in m.get("workloads", [workload])]
    e2e = {m["name"] for m in cell["end_to_end"]}
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if workload in m.get("workloads", [workload] if m["moves"] in e2e
                                              else [])]
    return cell


def reference(name: str):
    """The module ``reference/<name>.py``, imported as
    ``portbench.reference.<name>``."""
    if not name.isidentifier() or not os.path.isfile(
            os.path.join(BENCH_DIR, "reference", name + ".py")):
        raise CellError(f"no reference module reference/{name}.py")
    return importlib.import_module(f"portbench.reference.{name}")


def load_weights(model, weights: dict) -> None:
    """``model.load_state_dict(weights)``, where their names agree; else a
    :class:`CellError` naming the first of the model's names that
    ``weights`` lacks and of those it has beyond them."""
    have, want = set(weights), set(model.state_dict())
    if have != want:
        missing, unexpected = sorted(want - have), sorted(have - want)
        raise CellError(
            f"the reference's weights do not fit the program's model: {len(missing)} missing "
            f"(first {missing[:3]}), {len(unexpected)} unexpected (first {unexpected[:3]})")
    model.load_state_dict(weights)


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``, or where there is
    none, of the reader that ``<name>`` shares with its kin (``mfu.serve``
    and ``mfu.train``: ``metrics/mfu.py``)."""
    stem = name.rsplit(".", 1)[0]
    paths = [os.path.join(BENCH_DIR, "metrics", n + ".py") for n in (name, stem)]
    path = next((p for p in paths if os.path.isfile(p)), None)
    if path is None:
        raise CellError(f"no reader metrics/{name}.py or metrics/{stem}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    """The module ``drivers/<name>.py``."""
    path = os.path.join(BENCH_DIR, "drivers", name + ".py")
    if not os.path.isfile(path):
        raise CellError(f"no traffic driver drivers/{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_driver_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fix_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so that only a cell's first run there compiles.  The
    program's own kernels build into ``build/tcct_tpu_torch/`` beside its
    package.

    Python's bytecode too: where the interpreter may not write it beside
    the sources (``PYTHONDONTWRITEBYTECODE``, a read-only install), every
    run would compile PyTorch's 2,000-odd modules from source again, some
    seconds of set-up that follow the host's load.  It goes to
    ``build/portbench_cache/pycache`` from the first import after this
    call, in this process and in those it starts."""
    cache = os.path.join(ROOT, "build", "portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("PYTHONPYCACHEPREFIX", "pycache")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    sys.dont_write_bytecode = False


def few_threads() -> None:
    """Load from one process with few threads: the host's other cores are
    left to the dispatch thread and to whatever else the machine runs.
    Called before torch is imported."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "2"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cards(chips: int) -> Optional[str]:
    """None where this machine has ``chips`` CUDA cards, else the reason."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark runs on an NVIDIA card only"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards; torch.cuda.device_count() is " \
               f"{torch.cuda.device_count()}"
    return None


def compare(readings: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each compared number beside its limit; a number that is not finite
    fails."""
    out = {}
    for name, spec in limits["numbers"].items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": spec["limit"]}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def per_layer(cell: dict, capture) -> Dict[str, dict]:
    """The cell's per-layer metrics read from ``capture``; a reader that
    finds nothing leaves its metric out."""
    out = {}
    for m in cell["per_layer"]:
        v = reader(m["name"])(capture)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: dict, outcome: dict, trace: bool) -> dict:
    """The contract's last line: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and ``breakdown`` traced), the compared numbers
    last under ``checks``."""
    if trace:
        metrics = per_layer(cell, outcome["capture"])
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: {"value": outcome["e2e"][k], "unit": u} for k, u in units.items()}
    line = {"correct": outcome["correct"], "attempted": outcome["attempted"],
            "failed": outcome["failed"], "metrics": metrics, "device": outcome["device"]}
    if trace and outcome["capture"] is not None:
        line["device"] = dict(line["device"], busy_s=outcome["capture"].busy_s,
                              window_s=outcome["capture"].window_s)
        line["breakdown"] = outcome["capture"].breakdown()
    line["checks"] = outcome["checks"]
    return line


def print_checks(checks: Dict[str, dict]) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)


def device_entry(chips: int, memory_peak_bytes: int) -> dict:
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    return {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind, "count": chips,
            "memory_peak_bytes": int(memory_peak_bytes)}
