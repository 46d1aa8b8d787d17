"""Training of the FTC zoo in the port vs the JAX package (CPU, 64x64):
step-0 gradients of every trainable registry model and mixer, the dtypes
of the bf16 train forward after a gated fusion (f32, as JAX's), the gated
step repeated and resumed bit for bit, and each model's trained set
against the JAX train state's ``params`` tree.

The gradient reference is the JAX package's loss function run in f64
(``jax.enable_x64``, ``TrainConfig.dtype = float64``), its f32 casts read
as f64 too (:func:`jax_f64`), on images centred on 0.  At a
random init an f32 step is not accurate enough for the bound on [0, 1]
images: the first BatchNorm after the image conv sees a mean far above its
spread, and ``E[x^2] - E[x]^2`` in f32 loses the difference.  Measured here
(64x64, seed 0, [0, 1] images): the JAX package's f32 step is 2.0 bounds
from its f64 step for ``stc_tt`` with the factor mixer, 3.5 for ``pnnu``,
4.3 for ``stc_tb``, and the port's f32 step 1.18 bounds from its own f64
step for ``stc_sb``; on centred images the port's f32 step is within
0.03-0.22 of the bound of its f64 step.  The bound is
``tests/test_torch_train.py``'s: per tensor ``max(2e-3 * |ref|, 2e-4 *
global norm)``.  The golden cases (``stc_tt``, ``gtc_tt`` on the parity
goldens' weights and batch) are held against JAX's f32 step in
``tests/test_torch_train.py``.  ``stc_st`` and ``stc_sb`` run MPViT-small at
one block a stage here (its paths, widths and heads kept; full depth in
``tests/test_torch_zoo.py``'s logits and ``test_chip_smoke_train_launches_
match_the_model``).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tcct_tpu.losses.boundary as jax_boundary
import tcct_tpu.losses.polar as jax_polar
import tcct_tpu.models.layers as jax_layers
import tcct_tpu.models.regnet as jax_regnet
import tcct_tpu.train.step as jax_step
from tcct_tpu.infer.importer import export_torch_state, import_torch_state
from tcct_tpu.models import RegNet as JaxRegNet
from tcct_tpu.models import get_model as jax_get_model
from tcct_tpu.train import TrainConfig as JaxTrainConfig
from tcct_tpu.train.state import create_train_state
from tcct_tpu.train.state import make_optimizer as jax_make_optimizer
from tcct_tpu.train.step import build_loss_fn as jax_build_loss_fn
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.train import (
    TrainConfig,
    build_loss_fn,
    build_train_step,
    make_optimizer,
    trainable_parameters,
)
from tcct_tpu_torch.train.precision import cast_floating

HW, NC = 64, 5


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def variant_of(name: str) -> str:
    return "t32" if name == "tcct32" else "train"


# MPViT-small's models at one block a stage (its paths, widths, heads and MLP
# ratios kept): the gradient tests' JAX compile at full depth costs a minute
SHALLOW = {"stc_st": True, "stc_sb": False}  # name -> tiny CNN branch


def port_model(name: str, mixer: str = "metapool", drop_path_rate: float = 0.0,
               seed: int = 0, shallow: bool = False) -> RegNet:
    if shallow and name in SHALLOW:
        from tcct_tpu_torch.models import FTC
        from tcct_tpu_torch.models.mpvit import mpvit_small_config

        cfg = dataclasses.replace(mpvit_small_config(drop_path_rate=drop_path_rate, mixer=mixer),
                                  num_layers=(1, 1, 1, 1))
        base = FTC(cfg, cnn_tiny=SHALLOW[name], out_channels=NC, variant="train")
    else:
        base = get_model(name, NC, variant=variant_of(name), drop_path_rate=drop_path_rate,
                         mixer=mixer)
    m = RegNet(base, out_channels=NC)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(memory_format=torch.channels_last)


def jax_net(name: str, mixer: str = "metapool", shallow: bool = False):
    if shallow and name in SHALLOW:
        from tcct_tpu.models.ftc import FTC as JaxFTC
        from tcct_tpu.models.mpvit import mpvit_small_config as jax_small

        cfg = dataclasses.replace(jax_small(drop_path_rate=0.0, mixer=mixer),
                                  num_layers=(1, 1, 1, 1))
        base = JaxFTC(vit_cfg=cfg, cnn_tiny=SHALLOW[name], out_channels=NC, variant="train")
    else:
        base = jax_get_model(name, NC, variant=variant_of(name), drop_path_rate=0.0,
                             mixer=mixer)
    return JaxRegNet(base=base, out_channels=NC)


def jax_state_shapes(net):
    return jax.eval_shape(lambda: create_train_state(
        net, jax_make_optimizer(steps_per_epoch=1, lr=1e-4), jax.random.PRNGKey(0),
        jnp.zeros((1, HW, HW, 3)), jnp.zeros((1, HW, HW, NC))))


def _prelus(tree):
    """(path, leaf) of ReLayNet's bare PReLU params in a flax tree."""
    return [(k, v) for k, v in flatten_variables(tree).items() if k.endswith("/prelu")]


def jax_variables(m: RegNet, net):
    """The port model's weights as the JAX train state's variables (f32
    numpy), through the JAX package's own importer.  ReLayNet's PReLU
    slopes, which that importer leaves untouched, are set by path."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jax_state_shapes(net).variables())
    sd = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    jv, report = import_torch_state(sd, zeros)
    assert [k for k in report.untouched_target if "prelu" not in k] == []
    for path, _ in _prelus(jv):
        node = jv
        *heads, leaf = path.split("/")
        for h in heads:
            node = node[h]
        torch_name = ".".join(heads[1:]) + ".prelu.weight"
        node[leaf] = sd[torch_name].copy()
    return jv, sd


def batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    imgs = rng.random((2, HW, HW, 3)).astype(np.float32) - 0.5
    labs = np.sort(rng.integers(0, NC, (2, HW, HW)), axis=1)  # layered label maps
    return imgs, labs


def loss_cfg(name: str, **kw):
    gated = name.startswith("gtc")
    return dict(n_class=NC, crop_hw=(HW, HW), ds=True, coff_ds=0.5, udh=True, reg=True,
                epl=gated, augment=False, pinned_reg_noise=True, pinned_gate_noise=gated, **kw)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def jax_f64():
    """The JAX package evaluated in f64: ``jax.enable_x64``, the f32 casts
    of its layers (the BatchNorm statistics), loss heads and losses read as
    f64, and the train step's cast of the logits to f32 skipped."""
    mp = pytest.MonkeyPatch()
    for mod in (jax_layers, jax_regnet, jax_boundary, jax_polar):
        mp.setattr(mod, "jnp", _Float64Numpy())
    mp.setattr(jax_step, "to_f32", lambda tree: tree)
    try:
        with jax.enable_x64(True):
            yield
    finally:
        mp.undo()


def jax_step0_f64(net, jv, name, imgs, labs):
    """JAX's step-0 gradients of the training loss, in f64, as a
    torch-named dict of f64 arrays; ReLayNet's PReLU gradients by path."""
    with jax_f64():
        def f64(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

        cfg = JaxTrainConfig(dtype=jnp.float64, **loss_cfg(name))
        k = jax.random.PRNGKey(0)
        true_oh = jax.nn.one_hot(jnp.asarray(labs), NC, dtype=jnp.float64)
        grads, _ = jax.jit(jax.grad(jax_build_loss_fn(net, cfg), has_aux=True))(
            f64(jv["params"]), f64(jv["batch_stats"]), f64(jv["prototypes"]),
            jnp.asarray(imgs, jnp.float64), true_oh, {"gate": k, "droppath": k}, None)
        grads = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), grads)
    return grads


def port_step0(m, name, imgs, labs):
    m.train()
    params = trainable_parameters(m)
    true_oh = torch.nn.functional.one_hot(torch.from_numpy(labs).long(), NC).float()
    loss, _ = build_loss_fn(m, TrainConfig(**loss_cfg(name)))(
        params, dict(m.named_buffers()), torch.from_numpy(imgs), true_oh)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: (np.zeros(p.shape) if g is None else g.double().numpy())
            for (k, p), g in zip(params.items(), grads)}


def check_step0_gradients(name: str, mixer: str = "metapool"):
    """Every trained tensor's step-0 gradient within the bound of JAX's
    (f64); returns the number held.  MPViT-small's models at one block a
    stage (``SHALLOW``)."""
    m, net = port_model(name, mixer, shallow=True), jax_net(name, mixer, shallow=True)
    jv, sd = jax_variables(m, net)
    imgs, labs = batch()
    jg = jax_step0_f64(net, jv, name, imgs, labs)
    ref, report = export_torch_state({"params": jg}, sd)
    ref = {k: np.asarray(ref[k], np.float64) for k in report.filled}
    for path, v in _prelus({"params": jg}):
        ref[".".join(path.split("/")[1:-1]) + ".prelu.weight"] = np.asarray(v, np.float64)
    mine = port_step0(m, name, imgs, labs)
    assert set(mine) <= set(ref), sorted(set(mine) - set(ref))[:5]
    gnorm = np.sqrt(sum(float((ref[k] ** 2).sum()) for k in mine))
    for k, g in mine.items():
        err = np.linalg.norm(g - ref[k])
        bound = max(2e-3 * np.linalg.norm(ref[k]), 2e-4 * gnorm)
        assert err <= bound, (name, mixer, k, err, bound)
    return len(mine)


@pytest.mark.parametrize("name", ["gtc_tb", "stc_tb", "stc_st", "stc_sb", "cnnu", "pnnu"])
def test_step0_gradients_match_jax(name):
    """gtc_tt's are held in tests/test_torch_train.py, on the gated golden."""
    assert check_step0_gradients(name) > 60


# --- dtypes after the gate -----------------------------------------------------------

def _bf16_train_logits_port(name, mixer="metapool"):
    m = port_model(name, mixer, drop_path_rate=0.1).train()
    variables = cast_floating({**dict(m.named_parameters()), **dict(m.named_buffers())},
                              torch.bfloat16)
    from tcct_tpu_torch.models.layers import train_pass
    from tcct_tpu_torch.train.step import _call

    with torch.no_grad(), train_pass(m, torch.Generator().manual_seed(0)):
        pyr = _call(m, variables, (torch.rand(2, HW, HW, 3).bfloat16(),))
    return [p.dtype for p in pyr]


def _bf16_train_logits_jax(name):
    from tcct_tpu.train.precision import cast_floating as jax_cast

    net = jax_net(name)
    shapes = jax_state_shapes(net)
    k = jax.random.PRNGKey(0)

    def fwd(variables):
        (pyr, _), _ = net.apply(jax_cast(variables, jnp.bfloat16),
                                jnp.zeros((2, HW, HW, 3), jnp.bfloat16), train=True,
                                rngs={"gate": k, "droppath": k}, mutable=["batch_stats"])
        return pyr

    return [p.dtype for p in jax.eval_shape(fwd, shapes.variables())]


@pytest.mark.parametrize("name,want", [("gtc_tt", torch.float32), ("stc_tt", torch.bfloat16),
                                       ("relay", torch.float32)])
def test_bf16_train_logits_have_the_jax_dtype(name, want):
    """A bf16 train forward after a trained gate returns f32 logits, as the
    JAX package's does (its alpha map is f32 and widens every map after the
    fusion); stc_tt's stay bf16.  ReLayNet's f32 pooling masks widen its
    decoder in both packages too."""
    jax_dtypes = {str(d) for d in _bf16_train_logits_jax(name)}
    assert jax_dtypes == {str(want).replace("torch.", "")}
    assert set(_bf16_train_logits_port(name)) == {want}


def test_stc_tt_bf16_train_forward_promotes_nothing():
    """Simple fusion keeps the bf16 path as it was: every conv and
    BatchNorm of a bf16 stc_tt train forward sees bf16 inputs and bf16
    weights (no promotion), and the alpha-map code is not reached."""
    from tcct_tpu_torch.models.layers import BatchNorm2d, Conv2d, train_pass
    from tcct_tpu_torch.train.step import _call

    m = port_model("stc_tt", drop_path_rate=0.1).train()
    seen = []
    hooks = [mod.register_forward_pre_hook(lambda mod, args: seen.append(args[0].dtype))
             for mod in m.base.modules() if isinstance(mod, (Conv2d, BatchNorm2d))]
    variables = cast_floating({**dict(m.named_parameters()), **dict(m.named_buffers())},
                              torch.bfloat16)
    import tcct_tpu_torch.models.ftc as ftc

    calls = []
    real = ftc.gate_alpha
    ftc.gate_alpha = lambda *a: calls.append(a) or real(*a)
    try:
        with torch.no_grad(), train_pass(m, torch.Generator().manual_seed(0)):
            _call(m, variables, (torch.rand(2, HW, HW, 3).bfloat16(),))
    finally:
        ftc.gate_alpha = real
        for h in hooks:
            h.remove()
    assert len(seen) > 100 and set(seen) == {torch.bfloat16} and calls == []


# --- the gated step: generator order, repeat, resume ----------------------------------

def _gtc_step(m, gen, pinned=False):
    cfg = TrainConfig(n_class=NC, crop_hw=(48, 48), ds=True, udh=True, reg=True, augment=True,
                      dtype=torch.bfloat16, pinned_gate_noise=pinned)
    return build_train_step(m, make_optimizer(1, lr=1e-4), cfg, "cpu", gen)


def test_gated_bf16_step_repeats_bit_for_bit():
    """Two runs of two bf16 steps of gtc_tt (augmentation, gate, DropPath
    0.1, boundary noise) from one seed give bitwise-equal state, generator
    and losses; the gate draws from the step's generator (pinned alphas
    give another loss).  The resume is in tests/test_torch_engine.py."""
    imgs = np.random.default_rng(1).integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)
    labs = np.sort(np.random.default_rng(2).integers(0, NC, (2, HW, HW)), 1).astype(np.uint8)

    def run(pinned=False):
        m = port_model("gtc_tt", drop_path_rate=0.1)
        gen = torch.Generator().manual_seed(5)
        step = _gtc_step(m, gen, pinned)
        totals = [float(step(imgs, labs)[0]["total"]) for _ in range(2)]
        return m, gen, totals

    a, gen_a, ta = run()
    b, gen_b, tb = run()
    assert ta == tb and all(np.isfinite(ta))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))
    assert torch.equal(gen_a.get_state(), gen_b.get_state())
    assert run(pinned=True)[2][0] != ta[0]


def test_gated_train_forward_needs_a_generator_or_pinning():
    m = get_model("gtc_tt", NC, variant="train", drop_path_rate=0.0).train()
    with pytest.raises(ValueError, match="pinned_gate"):
        m(torch.rand(1, 32, 32, 3))
    from tcct_tpu_torch.models.ftc import pinned_gate

    with pinned_gate(), torch.no_grad():
        assert m(torch.rand(1, 32, 32, 3))[0].dtype == torch.float32


# --- the trained set --------------------------------------------------------------------

@pytest.mark.parametrize("name,mixer", [("gtc_tt", "metapool"), ("msca", "metapool"),
                                        ("tcct32", "metapool"), ("relay", "metapool"),
                                        ("stc_tt", "factor"), ("stc_tt", "hydra"),
                                        ("stc_tt", "metapool2d")])
def test_trainable_set_is_the_jax_params_tree(name, mixer):
    """As tests/test_torch_train.py's test of the same name, for the new
    models and mixers: the CRPE convs are trained with factor and hydra,
    and not otherwise; ReLayNet's feats heads and PReLUs are trained."""
    net = jax_net(name, mixer)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   jax_state_shapes(net).params)
    want = set(from_jax_variables(flatten_variables({"params": zeros})))
    m = port_model(name, mixer)
    shared = {k for k, _ in m.named_parameters(remove_duplicate=False)} - set(
        dict(m.named_parameters()))
    got = set(trainable_parameters(m))
    assert got == want - shared
    assert any("crpe" in k for k in got) == (mixer in ("factor", "hydra"))


# --- chip_smoke.py's launch tables for the zoo --------------------------------------------

ZOO = [("gtc_tt", "metapool"), ("gtc_tb", "metapool"), ("stc_tb", "metapool"),
       ("stc_st", "metapool"), ("stc_sb", "metapool"), ("cnnu", "metapool"),
       ("pnnu", "metapool"), ("vitu", "metapool"), ("msca", "metapool"), ("tcct32", "metapool"),
       ("relay", "metapool"), ("stc_tt", "factor"), ("stc_tt", "hydra"),
       ("stc_tt", "metapool2d"), ("stc_tt", "metapool")]


@pytest.mark.parametrize("name,mixer", ZOO)
def test_chip_smoke_train_launches_match_the_model(monkeypatch, name, mixer):
    """chip_smoke.py's per-step launch table, derived from a model's modules
    (``train_shapes``: each kernel's calls by input shape and types, and
    ``train_launches``, their sums), is the calls one CPU train step makes
    of each kernel's plain version, forward and backward, shape by shape
    (bf16, the loss heads on, the depthwise stride split as the card counts
    it, the weights' type where it differs from the input's); and its
    per-batch serving counts (``expected_launches``) are an eval
    forward's."""
    from collections import Counter

    import chip_smoke
    import tcct_tpu_torch.ops.kernels.bnstats as bs
    import tcct_tpu_torch.ops.kernels.dwconv as dw
    import tcct_tpu_torch.ops.kernels.metapool as mp

    seen, in_site = Counter(), []

    def types(x, w=None):
        dn = str(x.dtype).split(".")[-1]
        return dn if w is None or w.dtype == x.dtype else dn + "/" + str(w.dtype).split(".")[-1]

    def counted(mod, fn_name, key):
        real = getattr(mod, fn_name)

        def wrapped(*a, **k):
            if not any(in_site):  # the serving site's plain version runs K1's inside
                seen[key(*a, **k)] += 1
            in_site.append(fn_name == "metapool_block_reference")
            try:
                return real(*a, **k)
            finally:
                in_site.pop()

        monkeypatch.setattr(mod, fn_name, wrapped)

    counted(mp, "metapool_tokens_reference",
            lambda x: ("metapool_tokens", tuple(x.shape), types(x)))
    counted(mp, "metapool_tokens_backward_reference",
            lambda g: ("metapool_tokens_backward", tuple(g.shape), types(g)))
    counted(mp, "metapool_block_reference", lambda *a, **k: ("metapool_block",))
    counted(dw, "dwconv3x3_reference",
            lambda x, w, s: (f"dwconv3x3_s{s}", tuple(x.shape), types(x)))
    counted(dw, "dwconv3x3_backward_reference",
            lambda x, w, g, s, **k: (f"dwconv3x3_backward_s{s}", tuple(x.shape), types(x)))
    counted(bs, "bn_normalize_reference",
            lambda x, m, v, w, b, eps=1e-5, leaky=False:
            ("bn_act_train", tuple(x.shape), leaky, types(x, w)))
    counted(bs, "bn_act_train_backward_reference",
            lambda x, w, m, v, g, eps=1e-5, leaky=False:
            ("bn_act_train_backward", tuple(x.shape), leaky, types(x, w)))
    m = port_model(name, mixer, drop_path_rate=0.1)
    cfg = TrainConfig(n_class=NC, crop_hw=(32, 32), ds=True, udh=True, reg=True, augment=False,
                      dtype=torch.bfloat16)
    step = build_train_step(m, make_optimizer(1), cfg, "cpu", torch.Generator().manual_seed(0))
    imgs = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    labs = np.sort(np.random.default_rng(1).integers(0, NC, (2, 32, 32)), 1).astype(np.uint8)
    step(imgs, labs)
    table = chip_smoke.train_shapes(m, 2, (32, 32))
    want = Counter()
    for part, kernels in (("mp", ("metapool_tokens", "metapool_tokens_backward")),
                          ("s1", ("dwconv3x3_s1", "dwconv3x3_backward_s1")),
                          ("s2", ("dwconv3x3_s2", "dwconv3x3_backward_s2")),
                          ("bn", ("bn_act_train",)), ("bnb", ("bn_act_train_backward",))):
        for key, n in table[part].items():
            for kernel in kernels:
                want[(kernel,) + key] += n
    assert seen == want
    per_kernel = Counter()
    for key, n in seen.items():
        per_kernel[key[0]] += n
    assert dict(per_kernel) == {k: n for k, n in chip_smoke.train_launches(m).items() if n}
    seen.clear()
    with torch.inference_mode():
        m.eval()(torch.rand(2, 32, 64, 3))
    serve = chip_smoke.expected_launches(m, 2, (32, 64), False)
    per_kernel = Counter()
    for key, n in seen.items():
        per_kernel[key[0]] += n
    assert dict(per_kernel) == {k: n for k, n in serve.items() if n}
