"""The harness end to end on the CPU at tiny shapes: every traffic driver
through the program's plain paths, the contract's last line, a cell added
by files alone, the card requirement, and the faults the check must catch.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
SEED = 2 ** 33 + 12345  # wider than 32 bits, as a run's seed may be


def run_tiny(workload, trace=False, fault=None):
    from portbench import harness, run

    torch.manual_seed(0)
    cell = harness.load_cell(workload)
    return run.run_cell(cell, SEED, 1.0, trace, time.perf_counter(), device="cpu", fault=fault)


KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [("stc_tt.duke-volumes", False),
                                            ("stc_tt.duke-volumes", True),
                                            ("stc_tt.duke-volumes-fused", False),
                                            ("stc_tt.goals-train", False),
                                            ("stc_tt.goals-train", True)])
def test_cell_runs_and_is_correct(tiny_root, workload, trace):
    line = run_tiny(workload, trace)
    assert [k for k in line if k in KEYS] == KEYS
    assert list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    json.dumps(line)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert line["metrics"] == {}  # a CPU capture holds no device time: nothing is read
    else:
        units = {m: v["unit"] for m, v in line["metrics"].items()}
        assert "setup_s" in units and len(units) >= 2


def test_cell_added_by_files_alone(tiny_root):
    """A configuration, a traffic mix, limits, a per-layer reader and the
    BENCHMARK.json entries: the harness finds and runs the new cell by name."""
    b = os.path.join(tiny_root, "portbench")
    shutil.copy(os.path.join(b, "configs", "stc_tt.json"), os.path.join(b, "configs", "tt2.json"))
    with open(os.path.join(b, "traffic", "duke-volumes.json")) as f:
        t = json.load(f)
    t["scans"] = 3
    with open(os.path.join(b, "traffic", "short-volumes.json"), "w") as f:
        json.dump(t, f)
    shutil.copy(os.path.join(b, "limits", "stc_tt.duke-volumes.json"),
                os.path.join(b, "limits", "tt2.short-volumes.json"))
    with open(os.path.join(b, "metrics", "captured_units.serve.py"), "w") as f:
        f.write("def read(capture):\n    return None if capture is None else capture.units\n")
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tt2",
                                 file="portbench/configs/tt2.json"))
    bench["workloads"].append({"name": "tt2.short-volumes", "config": "tt2",
                               "traffic": "short-volumes", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "stc_tt.duke-volumes" in m["workloads"]:
            m["workloads"].append("tt2.short-volumes")
    bench["per_layer"].append({"name": "captured_units.serve", "unit": "batches",
                               "better": "higher", "source": "device_trace", "layer": "Device",
                               "moves": "serve_bscans_per_s",
                               "workloads": ["tt2.short-volumes"]})
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    line = run_tiny("tt2.short-volumes")
    assert line["correct"] and set(line["metrics"]) == {"serve_bscans_per_s", "setup_s"}
    traced = run_tiny("tt2.short-volumes", trace=True)
    assert traced["metrics"] == {"captured_units.serve": {"value": 2, "unit": "batches"}}


def _add_config(root, name, base, cell=None, **keys):
    """A configuration ``name``: ``base``'s file with ``keys`` changed, and
    its ``BENCHMARK.json`` entry; with ``cell``, a cell of it on ``cell``'s
    traffic mix, limits and metrics.  Returns the cell's name."""
    b = os.path.join(root, "portbench")
    with open(os.path.join(b, "configs", base + ".json")) as f:
        cfg = json.load(f)
    cfg.update(keys, name=name)
    with open(os.path.join(b, "configs", name + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"portbench/configs/{name}.json"))
    workload = None
    if cell is not None:
        traffic = cell.split(".", 1)[1]
        workload = f"{name}.{traffic}"
        shutil.copy(os.path.join(b, "limits", cell + ".json"),
                    os.path.join(b, "limits", workload + ".json"))
        bench["workloads"].append({"name": workload, "config": name, "traffic": traffic,
                                   "chips": 1, "why": "a test cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", []):
                m["workloads"].append(workload)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return workload


# A reference module added as a file: reference/model.py's model, noting
# each one it builds, so that a test sees which reference a run used.
SEEN_REFERENCE = '''"""reference/model.py's model, noting each one it builds."""

from . import model
from .model import Ctx, calibrate, trained_parameters  # noqa: F401

BUILT = []


class RegNet(model.RegNet):
    def __init__(self, cfg, n_class, variant):
        super().__init__(cfg, n_class, variant)
        BUILT.append(cfg["name"])
'''


def test_cell_with_its_own_reference_added_by_files_alone(tiny_root):
    """A configuration that names its own reference module, both added as
    files: the run builds the reference from that module and is correct."""
    with open(os.path.join(tiny_root, "portbench", "reference", "seen.py"), "w") as f:
        f.write(SEEN_REFERENCE)
    workload = _add_config(tiny_root, "tt_seen", "stc_tt", "stc_tt.duke-volumes",
                           reference="seen")
    line = run_tiny(workload)
    assert line["correct"], line["checks"]
    from portbench.reference import model, seen

    assert seen.BUILT == ["tt_seen", "tt_seen"]  # the weights' model and the check's
    assert not hasattr(model, "BUILT")


def test_missing_reference_module_is_a_cell_error(tiny_root):
    from portbench import harness

    workload = _add_config(tiny_root, "tt_nowhere", "stc_tt", "stc_tt.duke-volumes",
                           reference="nowhere")
    with pytest.raises(harness.CellError, match="reference/nowhere.py"):
        harness.load_cell(workload)


def test_program_model_the_reference_lacks_is_a_cell_error(tiny_root):
    """stc_st's model with factorized attention has weights (its attention's
    qkv and proj) that the MetaPool reference lacks: the build names them."""
    from portbench import harness

    workload = _add_config(tiny_root, "st_factor", "stc_st", "stc_st.duke-volumes",
                           mixer="factor")
    with pytest.raises(harness.CellError, match=r"att\.qkv"):
        run_tiny(workload)


def _altered_answer(pred):
    """The fault of a serving cell: an answer altered where it is produced,
    the first B-scan's class map of each batch shifted by one class."""
    forward = pred._forward

    def bad(x):
        seg = forward(x).clone()
        seg[0] = (seg[0] + 1) % 9
        return seg

    pred._forward = bad


def _unchanged_state(step, opt):
    """A step that leaves the parameters as they were."""
    opt.update = lambda params, grads: torch.zeros(())
    return step


def _half_batch(step, opt):
    """Half of the batch left out, the loss's mean taken over the rest."""
    return lambda imgs, labs: step(imgs[: imgs.shape[0] // 2], labs[: labs.shape[0] // 2])


@pytest.mark.parametrize("workload,fault", [("stc_tt.duke-volumes", _altered_answer),
                                            ("stc_tt.duke-volumes-fused", _altered_answer),
                                            ("stc_tt.goals-train", _unchanged_state),
                                            ("stc_tt.goals-train", _half_batch)])
def test_broken_timed_path_is_not_correct(tiny_root, workload, fault):
    line = run_tiny(workload, fault=fault)
    assert line["correct"] is False, line["checks"]


def test_needs_a_card():
    """On the CPU the measured path fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "stc_tt.duke-volumes", "--seed", str(SEED), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 1 and p.stdout.strip() == "", (p.stdout, p.stderr)
    assert "cuda" in p.stderr.lower()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    """One cell's whole run on the card at a short window: exit code 0, and
    the last line correct."""
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "stc_tt.duke-volumes", "--seed", str(SEED), "--seconds", "3",
                        "--trace", "0"], capture_output=True, text=True, timeout=900, cwd=REPO)
    assert p.returncode == 0, p.stderr[-4000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
