"""The ``out`` overloads of the serving ops (``ops/kernels/library.py::
define_out``) on the CPU: each writes, bit for bit, what its op returns (the
plain versions), refuses an output it cannot take, passes
``torch.library.opcheck``, and is recorded by the profiler under its op's
name with the op's arguments at the same positions, as the benchmark's
rooflines read them (``Input Dims``, ``Concrete Inputs``)."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tcct_tpu_torch.models.crosscnn import seeded_cross_block
from tcct_tpu_torch.ops.kernels import library
from tcct_tpu_torch.ops.kernels.crosscnn_fused import pack_cross_block

OPS = torch.ops.tcct
DTYPES = [torch.float32, torch.bfloat16]


def _rand(shape, dtype, seed, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dtype)


def _site(dtype, norms=True, residual=True):
    C = 8
    affine = [_rand((C,), dtype, 3 + i, 0.5, 1.0 - (i % 2)) for i in range(4)] if norms \
        else [None] * 4
    return OPS.metapool_block, (_rand((2, 15, C), dtype, 7), *affine, 1e-6, residual)


def _dwconv(dtype, stride=1, bias=True, residual=True):
    shape = (2, 7, 9, 6)
    b = _rand((shape[-1],), dtype, 13) if bias else None
    return OPS.dwconv3x3, (_rand(shape, dtype, 11), _rand((3, 3, shape[-1]), dtype, 12, 1 / 3),
                           b, stride, residual and stride == 1, 0)


def _fused(dtype, cin=16, cout=32, k=5):
    pk = pack_cross_block(seeded_cross_block(cin, cout, k, 31).to(dtype).eval(), dtype)
    return OPS.fused_cross_block, (_rand((1, 6, 7, cin), dtype, 32), pk.w, pk.vec, pk.wf,
                                   cin, cout, k)


CASES = {
    "site": _site,
    "site_no_norms": lambda dt: _site(dt, norms=False),
    "site_no_residual": lambda dt: _site(dt, residual=False),
    "dwconv_s1": _dwconv,
    "dwconv_s1_plain": lambda dt: _dwconv(dt, bias=False, residual=False),
    "dwconv_s2": lambda dt: _dwconv(dt, stride=2),
    "fused": _fused,
    "fused_k3": lambda dt: _fused(dt, 32, 32, 3),
}


def _outputs(op, args):
    got = library.OUT[op.default][1](*args)
    return got if isinstance(got, tuple) else (got,)


def test_the_serving_ops_have_out_overloads():
    assert set(library.OUT) == {OPS.metapool_block.default, OPS.dwconv3x3.default,
                                OPS.fused_cross_block.default}
    for op, (out, _) in library.OUT.items():
        assert out is getattr(OPS, op._opname).out
        assert [a.name for a in out._schema.arguments][:len(op._schema.arguments)] == \
            [a.name for a in op._schema.arguments]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_out_overload_writes_what_the_op_returns(case, dtype):
    op, args = CASES[case](dtype)
    want = op.default(*args)
    want = want if isinstance(want, tuple) else (want,)
    outs = _outputs(op, args)
    for o in outs:
        o.fill_(float("nan"))
    assert op.out(*args, *outs) is None
    assert len(outs) == len(want)
    for o, w in zip(outs, want):
        assert o.dtype == w.dtype and o.shape == w.shape and o.is_contiguous()
        assert torch.equal(o, w)


@pytest.mark.parametrize("case", ["site", "dwconv_s2", "fused"])
def test_out_overload_refuses_an_output_it_cannot_take(case):
    op, args = CASES[case](torch.float32)
    outs = list(_outputs(op, args))
    for bad in (outs[0][..., :1], outs[0].to(torch.bfloat16),
                outs[0].new_empty(outs[0].shape[::-1]).transpose(0, -1)):
        with pytest.raises(ValueError, match="out must be a contiguous"):
            op.out(*args, bad, *outs[1:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["site", "site_no_norms", "dwconv_s1", "dwconv_s2", "fused"])
def test_opcheck_out_overload(case, dtype):
    op, args = CASES[case](dtype)
    res = torch.library.opcheck(op.out, (*args, *_outputs(op, args)))
    assert set(res.values()) == {"SUCCESS"}, res


def _recorded(tmp_path, fn):
    """The outermost ``tcct::`` host op of a CPU profile of ``fn``: (name,
    Input Dims, Concrete Inputs), from its Chrome trace as the benchmark
    reads it (on the CPU an out call runs its op inside)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and e["name"].startswith("tcct::")), key=lambda e: (e["ts"], -e["dur"]))
    return ops[0]["name"], ops[0]["args"].get("Input Dims"), ops[0]["args"].get("Concrete Inputs")


@pytest.mark.parametrize("case", ["site", "dwconv_s1", "dwconv_s2", "fused"])
def test_profiler_records_out_overload_as_its_op(tmp_path, case):
    """An out call is recorded under the op's name; its input dims and
    concrete inputs begin with the op call's, so ``Input Dims[0]`` and (for
    the depthwise forward) the stride at ``Concrete Inputs[3]`` read as
    before."""
    op, args = CASES[case](torch.bfloat16)
    outs = _outputs(op, args)
    with torch.inference_mode():
        name, dims, concrete = _recorded(tmp_path, lambda: op.default(*args))
        name_out, dims_out, concrete_out = _recorded(tmp_path, lambda: op.out(*args, *outs))
    assert name == name_out == f"tcct::{op._qualified_op_name.split('::')[1]}"
    n = len(args)
    assert dims_out[:n] == dims and concrete_out[:n] == concrete
    assert dims_out[0] == list(args[0].shape)
    assert dims_out[n:] == [list(o.shape) for o in outs]
    if op is OPS.dwconv3x3:
        assert int(concrete_out[3]) == args[3]
