"""Shared fixtures of the benchmark's own tests (CPU, tiny shapes).

``tiny_root`` is a copy of ``portbench/`` in a temporary directory beside a
``BENCHMARK.json`` whose cells are the real cells' configurations on tiny
traffic: 64x64 scans, batches of 2, f32 unless a test asks otherwise, and
the train cell.  The limits are the real cells'."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY = {
    "volumes": dict(hw=[64, 64], scans=5, batch=2, pool=2, sample_volumes=1,
                    capture_volumes=1, dtype="float32"),
    "train": dict(hw=[64, 64], batch=2, pool=4, capture_steps=1, check_steps=3,
                  dtype="float32"),
}


# The train cell's files (drivers/train.py, traffic/goals-train.json, its
# limits) are kept, tested here, while BENCHMARK.json leaves the cell out until
# its rate holds a bound (PERF.md section 7); the tiny copy adds it back.
TRAIN_CELL = {"name": "stc_tt.goals-train", "config": "stc_tt", "traffic": "goals-train",
              "chips": 1, "why": "the CLI's train step"}
TRAIN_RATE = {"name": "train_bscans_per_s", "unit": "bscans/s", "better": "higher",
              "bound": 0.25, "source": "host_clock", "workloads": ["stc_tt.goals-train"]}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


def make_root(path, dtype=None) -> str:
    """A tiny copy of the benchmark at ``path``: its cells are the real
    ones', their traffic cut to :data:`TINY` (``dtype`` overrides the
    compute type)."""
    root = str(path)
    shutil.copytree(BENCH, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    if TRAIN_CELL["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(TRAIN_CELL)
        bench["end_to_end"].append(TRAIN_RATE)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    tdir = os.path.join(root, "portbench", "traffic")
    for f in os.listdir(tdir):
        p = os.path.join(tdir, f)
        with open(p) as fh:
            t = json.load(fh)
        t.update(TINY[t["driver"]])
        if dtype is not None:
            t["dtype"] = dtype
        with open(p, "w") as fh:
            json.dump(t, fh)
    return root


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """The tiny copy, importable as ``portbench`` ahead of the real one."""
    root = make_root(tmp_path)
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.syspath_prepend(root)
    for name in [m for m in sys.modules if m == "portbench" or m.startswith("portbench.")]:
        monkeypatch.delitem(sys.modules, name)
    return root
