"""The port's serving artifact (``tcct_tpu_torch/infer/export.py``) against
the JAX package's (``tcct_tpu/infer/export.py``), and the ``tcct::`` custom
ops that carry the hand-written kernels into an exported program (CPU, f32).

``RegNet(stc_tt, 'infer')`` at 64x96 and ``relay`` (``tests/test_infer.py``'s
export model): the JAX model runs the MetaPool mixer through its Pallas
kernel (``metapool_pallas``, interpret mode on the CPU), the port's model
holds the same variables (``from_jax_variables``).  Each side exports its
eval forward with a symbolic batch; the port's program is loaded in a fresh
process.  Logits within 1e-3 of JAX's exported program's, argmax above
99.9 %, bitwise the port's eager module's, and a batch of 3 through the
program exported at batch 2.  Also: the ops in the exported graph, the
weights through npz files both ways, and ``torch.library.opcheck`` on
every op."""

import collections
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tcct_tpu.infer import export as jax_export
from tcct_tpu.infer.importer import import_torch_state
from tcct_tpu.models.layers import feats_gate
from tcct_tpu_torch.infer import load_into
from tcct_tpu_torch.infer.export import export_model, load_params_npz, save_params_npz
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.crosscnn import CrossResNet, cross_resnet_fused, seeded_cross_block
from tcct_tpu_torch.models.mpvit import MPViTConfig
from tcct_tpu_torch.ops.kernels import bnstats, crosscnn_fused
from tcct_tpu_torch.ops.kernels.bnstats import bn_stats_reference
from tcct_tpu_torch.ops.kernels.crosscnn_fused import fused_cross_block, pack_cross_block
from tcct_tpu_torch.ops.kernels.metapool import metapool_block
from tests.test_torch_zoo import HW, NC, pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = torch.ops.tcct


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_model(jv, name):
    """The port's eval model holding the JAX variables ``jv``."""
    m = RegNet(get_model(name, NC, variant="infer"), out_channels=NC)
    load_into(m, from_jax_variables(flatten_variables(jv)))
    return m.eval()


NAMES = ["stc_tt", "relay"]
_FRESH = {}


class _Site(torch.nn.Module):
    def forward(self, x):
        with torch.no_grad():
            return metapool_block(x)[0]


# the fresh process: first a load with no tcct:: op registered, then each
# program through load_exported on its input at batch 2 and 3
_FRESH_CODE = """
import collections, json, sys
import numpy as np, torch
try:
    torch.export.load(sys.argv[1])
    refused = False
except RuntimeError:
    refused = True
from tcct_tpu_torch.infer.export import load_exported
from tcct_tpu_torch.ops.kernels import dwconv, metapool
out = {"refused": refused}
for name in sys.argv[3:]:
    fn = load_exported(f"{sys.argv[2]}/{name}.pt2")
    x = np.load(f"{sys.argv[2]}/{name}.in.npy")
    x3 = np.concatenate([x, x[:1]], 0)
    before = metapool.metapool_block.launches + dwconv.dwconv3x3.launches
    got, got3 = (fn(torch.from_numpy(a)).numpy() for a in (x, x3))
    nodes = [n for n in fn.module.graph.nodes if n.op == "call_function"]
    np.savez(f"{sys.argv[2]}/{name}.out.npz", got=got, got3=got3)
    out[name] = {"launches": metapool.metapool_block.launches + dwconv.dwconv3x3.launches - before,
                 "targets": collections.Counter(str(n.target) for n in nodes),
                 "strides": collections.Counter(n.args[3] for n in nodes
                                                if str(n.target) == "tcct.dwconv3x3.default")}
print(json.dumps(out))
"""


def fresh(tmp_dir):
    """Both models: (port model, JAX net, JAX variables, input) and what a
    fresh process made of each exported program: logits at batch 2 and 3,
    the launches counted there, the graph's op targets and the depthwise
    ops' strides, and whether a program that calls a ``tcct::`` op (the
    site alone) loaded before the ops were registered (``refused``)."""
    if not _FRESH:
        for name in NAMES:
            _, net, jv, x = pair(name, "infer")
            m = _port_model(jv, name)
            export_model(m, torch.from_numpy(x), os.path.join(tmp_dir, f"{name}.pt2"))
            np.save(os.path.join(tmp_dir, f"{name}.in.npy"), x)
            _FRESH[name] = {"model": m, "net": net, "jv": jv, "x": x}
        bare = os.path.join(tmp_dir, "site.pt2")
        torch.export.save(torch.export.export(_Site(), (torch.zeros(1, 4, 8),)), bare)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        res = subprocess.run([sys.executable, "-c", _FRESH_CODE, bare, tmp_dir, *NAMES],
                             check=True, env=env, cwd=REPO, timeout=300, capture_output=True,
                             text=True)
        out = json.loads(res.stdout.strip().splitlines()[-1])
        for name in NAMES:
            with np.load(os.path.join(tmp_dir, f"{name}.out.npz")) as got:
                _FRESH[name].update(out[name], got=got["got"], got3=got["got3"],
                                    refused=out["refused"])
    return _FRESH


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("export"))


@pytest.mark.parametrize("name", NAMES)
def test_exported_program_matches_jax(name, tmp_dir):
    """Also: a process that has not registered the ``tcct::`` ops cannot
    load a program that calls one; ``load_exported`` registers them, so
    nothing degrades silently."""
    r = fresh(tmp_dir)[name]
    m, x, got, got3 = r["model"], r["x"], r["got"], r["got3"]
    assert r["refused"]
    with feats_gate(False):
        jpath = jax_export.export_model(r["net"], r["jv"], jnp.asarray(x),
                                        os.path.join(tmp_dir, f"{name}.stablehlo"))
    want = np.asarray(jax_export.load_exported(jpath)(jnp.asarray(x)))
    assert got.shape == want.shape == (2,) + HW + (NC,)
    assert np.abs(want).max() > 0.5  # a real test of an absolute tolerance
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999
    x3 = np.concatenate([x, x[:1]], 0)
    with torch.no_grad():
        eager = m(torch.from_numpy(x))[0].numpy()
        eager3 = m(torch.from_numpy(x3))[0].numpy()
    np.testing.assert_array_equal(got, eager)
    assert got3.shape == (3,) + HW + (NC,)
    np.testing.assert_array_equal(got3, eager3)
    assert r["launches"] == 0  # CPU tensors: the plain versions, no kernel


def _targets(program):
    return collections.Counter(str(n.target) for n in program.graph.nodes
                               if n.op == "call_function")


def test_stc_graph_holds_the_site_and_depthwise_ops(tmp_dir):
    """The exported stc_tt graph, as the fresh process loaded it, runs every
    MetaPool block's token pass as one site op and every depthwise conv as
    the K2 op, as many as ``chip_smoke.path_shapes`` derives for a serving
    batch, and no LayerNorm."""
    r = fresh(tmp_dir)["stc_tt"]
    sites, s1, s2 = chip_smoke.path_shapes(MPViTConfig(), 2, HW)
    targets = r["targets"]
    assert targets["tcct.metapool_block.default"] == sum(sites.values()) == 4
    assert r["strides"] == {"1": sum(s1.values()), "2": sum(s2.values())}
    assert not [t for t in targets if "layer_norm" in t]
    assert not [t for t in targets if "metapool_tokens" in t]


def test_fused_pyramid_exports_one_op_a_block():
    """A narrow CrossResNet through ``cross_resnet_fused``: one
    ``tcct::fused_cross_block`` a block in the exported graph, the pack
    formed from the parameters inside it; the program equals the eager
    pyramid bit for bit on the CPU and counts no launch."""
    net = CrossResNet(tiny=True).eval()
    for i, blk in enumerate(net.path_estan):
        cin, cout = blk.block12[0].weight.shape[1], blk.block12[0].weight.shape[0]
        k = blk.block34[0].weight.shape[3]
        blk.load_state_dict(seeded_cross_block(cin, cout, k, 50 + i).state_dict())

    class Pyramid(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.cnn = net

        def forward(self, x):
            return tuple(cross_resnet_fused(x, self.cnn))

    x = torch.from_numpy(np.random.default_rng(5).random((2, 32, 48, 3)).astype(np.float32))
    with torch.no_grad():
        program = torch.export.export(
            Pyramid(), (x,), dynamic_shapes=({0: torch.export.Dim("batch", min=1)},))
        want = cross_resnet_fused(x, net)
    assert _targets(program)["tcct.fused_cross_block.default"] == len(net.path_estan)
    before = fused_cross_block.launches
    with torch.inference_mode():
        got = program.module()(x)
    assert fused_cross_block.launches == before
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --- weights through npz files ---------------------------------------------------------


def test_npz_roundtrip_is_bitwise(tmp_path):
    m, _, _, _ = pair("relay", "infer")
    path = save_params_npz(m, str(tmp_path / "w.npz"))
    back = load_params_npz(path)
    sd = m.state_dict()
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


@pytest.mark.parametrize("name", ["stc_tt", "relay"])
def test_jax_npz_loads_into_the_port(name, tmp_path):
    """A file written by the JAX package's ``save_params_npz`` gives the
    state dict ``from_jax_variables`` gives for the same variables."""
    _, _, jv, _ = pair(name, "infer")
    path = jax_export.save_params_npz(jv, str(tmp_path / "jax.npz"))
    got = load_params_npz(path)
    want = from_jax_variables(flatten_variables(jv))
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k


@pytest.mark.parametrize("name", ["stc_tt", "relay"])
def test_port_npz_maps_back_onto_the_jax_variables(name, tmp_path):
    """The port's npz, read as numpy and handed to the JAX package's
    ``import_torch_state``, gives back the JAX variables bit for bit.  The
    JAX importer leaves ReLayNet's bare PReLU slopes alone (its own gap,
    which ``pair`` fills by hand too): they are the only untouched leaves."""
    _, _, jv, _ = pair(name, "infer")
    m = _port_model(jv, name)
    path = save_params_npz(m, str(tmp_path / "port.npz"))
    with np.load(path) as data:
        sd = {k: data[k] for k in data.files}
    zeros = jax.tree_util.tree_map(np.zeros_like, jv)
    back, report = import_torch_state(sd, zeros)
    assert all(p.endswith("/prelu") for p in report.untouched_target)
    want, got = flatten_variables(jv), flatten_variables(back)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        if k not in report.untouched_target:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(a), err_msg=k)


# --- torch.library.opcheck on every op ---------------------------------------------------

DTYPES = [torch.float32, torch.bfloat16]


def _rand(shape, dtype, seed, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(dtype)


def _opcheck(op, args):
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 8), (1, 9, 3)])
def test_opcheck_metapool(shape, dtype):
    x = _rand(shape, dtype, 1).requires_grad_()
    _opcheck(OPS.metapool_tokens.default, (x,))
    _opcheck(OPS.metapool_tokens_backward.default, (_rand(shape, dtype, 2),))


@pytest.mark.parametrize("norms", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 8), (1, 9, 3)])
def test_opcheck_metapool_block(shape, dtype, norms):
    C = shape[-1]
    affine = [_rand((C,), dtype, 3 + i, 0.5, 1.0 - (i % 2)) for i in range(4)] if norms \
        else [None] * 4
    _opcheck(OPS.metapool_block.default, (_rand(shape, dtype, 7), *affine, 1e-6, norms))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 6, 4, 3)])
def test_opcheck_dwconv3x3(shape, dtype, stride):
    x = _rand(shape, dtype, 11).requires_grad_()
    w = _rand((3, 3, shape[-1]), dtype, 12, 1 / 3).requires_grad_()
    b = _rand((shape[-1],), dtype, 13).requires_grad_()
    _opcheck(OPS.dwconv3x3.default, (x, w, b, stride, stride == 1, 0))
    _opcheck(OPS.dwconv3x3.default, (x, w, None, stride, False, 0))
    B, H, W, C = shape
    g = _rand((B, (H - 1) // stride + 1, (W - 1) // stride + 1, C), dtype, 14)
    for bias, need_dx in ((True, True), (False, False)):
        _opcheck(OPS.dwconv3x3_backward.default,
                 (x.detach(), w.detach(), g, stride, bias, stride == 1, need_dx))


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 8, 5, 6), (3, 4, 3, 3)])
def test_opcheck_bn_act_train(shape, dtype, leaky):
    C = shape[1]
    x = _rand(shape, dtype, 21, 2.0, 0.5).requires_grad_()
    w = (_rand((C,), torch.float32, 22).abs() + 0.5).requires_grad_()
    b = _rand((C,), torch.float32, 23, 0.1).requires_grad_()
    _opcheck(OPS.bn_act_train.default, (x, w, b, 1e-5, leaky))
    mean, var = bn_stats_reference(x.detach(), leaky)
    _opcheck(OPS.bn_act_train_backward.default,
             (x.detach(), w.detach(), mean, var, _rand(shape, dtype, 24), 1e-5, leaky))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout,k,shape", [(16, 32, 5, (1, 6, 7)), (32, 32, 3, (2, 4, 5))])
def test_opcheck_fused_cross_block(cin, cout, k, shape, dtype):
    blk = seeded_cross_block(cin, cout, k, 31).to(dtype).eval()
    pk = pack_cross_block(blk, dtype)
    assert (pk.wf is not None) == (dtype == torch.bfloat16)
    x = _rand(shape + (cin,), dtype, 32)
    _opcheck(OPS.fused_cross_block.default, (x, pk.w, pk.vec, pk.wf, cin, cout, k))


def test_ops_without_a_backward_refuse_a_gradient():
    """The site and K4 have no backward: asked for one, they raise (the op
    itself, not only the wrapper); without it they run."""
    x = _rand((1, 4, 8), torch.float32, 41).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        OPS.metapool_block.default(x, None, None, None, None, 1e-6, True)
    with torch.no_grad():
        OPS.metapool_block.default(x, None, None, None, None, 1e-6, True)
    blk = seeded_cross_block(16, 32, 3, 42).eval()
    pk = pack_cross_block(blk, torch.float32)
    xk = _rand((1, 4, 4, 16), torch.float32, 43).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        OPS.fused_cross_block.default(xk, pk.w, pk.vec, pk.wf, 16, 32, 3)
    with pytest.raises(ValueError, match="no backward"):
        crosscnn_fused.fused_cross_block(xk, blk)


def test_stats_and_weight_gradients_are_outputs_of_their_own():
    """K3's statistics and K3b's weight gradients come out of their ops as
    one [2, C] tensor each, not aliasing any input; the public functions
    return its rows, with the statistics outside autograd."""
    x = _rand((2, 4, 3, 3), torch.float32, 51).requires_grad_()
    w = torch.ones(4, requires_grad=True)
    b = torch.zeros(4, requires_grad=True)
    y, mean, var = bnstats.bn_act_train(x, w, b)
    assert y.requires_grad and not mean.requires_grad and not var.requires_grad
    stats = OPS.bn_act_train.default(x.detach(), w.detach(), b.detach(), 1e-5, False)[1]
    assert stats.shape == (2, 4) and torch.equal(stats[0], mean) and torch.equal(stats[1], var)
