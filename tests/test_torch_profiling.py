"""The port's tracing and profiling utilities
(``tcct_tpu_torch/utils/profiling.py``) on the CPU: the operation counts of
the ``tcct::`` ops, a trace that names them, and NaN detection inside a
port function."""

import numpy as np
import pytest
import torch

from tcct_tpu_torch.ops.kernels.bnstats import bn_act_train, bn_act_train_flops
from tcct_tpu_torch.ops.kernels.dwconv import dwconv3x3, dwconv3x3_flops
from tcct_tpu_torch.ops.kernels.metapool import (
    metapool_block,
    metapool_block_flops,
    metapool_flops,
    metapool_tokens,
)
from tcct_tpu_torch.utils import cost_analysis, debug_nans, measured_traffic, trace


def _rand(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("stride", [1, 2])
def test_cost_of_dwconv3x3_is_its_formula(stride):
    """One K2 op: its formula's operations, and x, w and y's bytes (the op
    is counted once, not the plain version's ops inside it)."""
    x, w = _rand((2, 9, 10, 8), 1), _rand((3, 3, 8), 2)
    cost = cost_analysis(dwconv3x3, x, w, stride)
    Ho, Wo = (9 - 1) // stride + 1, (10 - 1) // stride + 1
    assert cost["flops"] == dwconv3x3_flops(x.shape, stride) == 18 * 2 * Ho * Wo * 8
    assert cost["bytes_accessed"] == 4 * (x.numel() + w.numel() + 2 * Ho * Wo * 8)
    assert cost["transcendentals"] == 0


def test_cost_of_metapool_ops_and_their_backward():
    x = _rand((2, 30, 8), 3)
    assert cost_analysis(metapool_tokens, x)["flops"] == metapool_flops(x.shape) == 11 * x.numel()
    with torch.no_grad():
        assert cost_analysis(metapool_block, x)["flops"] == metapool_block_flops(x.shape)
    xg = x.clone().requires_grad_()
    both = cost_analysis(lambda t: metapool_tokens(t).sum().backward(), xg)
    assert both["flops"] == 2 * metapool_flops(x.shape)  # forward and K1b (the sum counts none)


def test_cost_of_a_train_batchnorm_step():
    x = _rand((2, 4, 5, 6), 4).requires_grad_()
    w, b = torch.ones(4, requires_grad=True), torch.zeros(4, requires_grad=True)
    cost = cost_analysis(lambda: bn_act_train(x, w, b, 1e-5, True)[0].sum().backward())
    assert cost["flops"] == bn_act_train_flops(x.shape) + bn_act_train_flops(x.shape, True)


def test_transcendentals_are_counted():
    x = _rand((3, 7), 5)
    assert cost_analysis(lambda t: torch.exp(t) + torch.tanh(t), x)["transcendentals"] == 42


def test_trace_names_the_ops(tmp_path):
    """A CPU trace: no device time, the ``tcct::`` ops among the host ops."""
    x, w = _rand((1, 6, 6, 4), 6), _rand((3, 3, 4), 7)
    with trace(str(tmp_path)):
        with torch.no_grad():
            metapool_block(metapool_tokens(_rand((1, 12, 4), 8)))
            dwconv3x3(x, w, 2)
    got = measured_traffic(str(tmp_path))
    assert got["self_time_s"] == 0 and got["categories"] == {}
    for op in ("tcct::metapool_tokens", "tcct::metapool_block", "tcct::dwconv3x3"):
        assert op in got["host_ops"], sorted(got["host_ops"])
    with pytest.raises(FileNotFoundError):
        measured_traffic(str(tmp_path / "none"))


def test_debug_nans_raises_inside_a_port_function_only():
    """0 * inf inside the K2 op's plain version gives a NaN: the op raises
    inside the context, naming itself; outside, the NaN passes."""
    x = torch.zeros(1, 4, 4, 3)
    w = torch.ones(3, 3, 3)
    w[1, 1, 0] = float("inf")
    with debug_nans():
        dwconv3x3(x, torch.ones(3, 3, 3))  # finite: no complaint
        with pytest.raises(FloatingPointError, match="tcct.dwconv3x3"):
            dwconv3x3(x, w)
    assert bool(dwconv3x3(x, w).isnan().any())
    with debug_nans(False):
        assert bool(dwconv3x3(x, w).isnan().any())
