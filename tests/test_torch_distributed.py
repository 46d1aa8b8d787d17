"""Data parallelism of the port (``tcct_tpu_torch/parallel``) on the CPU:
two real processes over gloo, each with one thread, against one process on
the same global batch.

The children run :func:`_child` (``python -c``, this file imported from
``tests/``), meet through a ``FileStore`` in ``tmp_path``, run every case
in one go and write their results with ``torch.save``; every
``communicate`` has a timeout and a child still running after it is
killed, and the process group's own timeout bounds each collective.  The
one-process references run in this process, at one thread too.

What is held (tolerances beside each check):
- the mesh helpers against the JAX package's rules (``pick_dp_devices``,
  ``make_mesh``'s errors, ``P('data')``'s rows, the Trainer's check);
- the two-phase train BatchNorm: its plain versions at one rank are the
  one-launch plain K3/K3b bit for bit; on two ranks (4 rows each) its y,
  running statistics, dx and summed dweight/dbias are one process's on
  the 8 rows;
- one train step of a narrow ``relay``, a narrow ``stc_tt`` (DropPath on,
  MetaPool mixer) and its gated ``gtc_tt`` form (augmentation and every
  loss on), global batch 8, crop 32: loss, every gradient, BN running
  statistics, parameters after AdamW; the two ranks bitwise equal;
- teeth: per-rank BN statistics, the base model's gradients averaged
  instead of summed (the gather's backward unscaled), and DropPath masks
  drawn at the local shape each miss by far more than the tolerance;
- the DP step of ``relay`` against the JAX package's step on its 8-device
  virtual CPU mesh (same weights, augmentation off, pinned noise);
- ``Trainer(mesh=)``: 2 epochs of 4 steps against one process (rtol 5e-4,
  the JAX test's bound), rank 0 alone writing, a bitwise resume;
- ``VolumePredictor(mesh=)``: the one-process predictor's maps.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tcct_tpu_torch.models import FTC, RegNet, get_model
from tcct_tpu_torch.models.layers import BatchNorm2d, init_weights, train_pass
from tcct_tpu_torch.models.mpvit import MPViTConfig
from tcct_tpu_torch.ops.kernels import bnstats
from tcct_tpu_torch.parallel import make_mesh, pick_dp_devices, shard_batch
from tcct_tpu_torch.parallel.distributed import row_range
from tcct_tpu_torch.train import AdamW, TrainConfig, build_train_step, trainable_parameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, BATCH, CROP, NC, LR = 2, 8, 32, 5, 1e-3
CHILD_TIMEOUT_S = 240

# --- models and batches, built alike in the children and here ---------------------------


def relay_model(seed: int = 0) -> RegNet:
    m = RegNet(get_model("relay", NC, filters=16), out_channels=NC)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(memory_format=torch.channels_last)


def stc_model(seed: int = 0, gate: bool = False) -> RegNet:
    """``stc_tt``'s structure (CrossCNN tiny, MPViT with the MetaPool mixer,
    train variant) at narrow widths, DropPath at 0.5; ``gate``: ``gtc_tt``'s
    gated fusion (its alpha maps drawn for the global batch)."""
    cfg = MPViTConfig(embed_dims=(16, 24, 32, 40), num_heads=(2, 2, 2, 2), drop_path_rate=0.5)
    m = RegNet(FTC(cfg, cnn_tiny=True, out_channels=NC, variant="train", flag_gate=gate),
               out_channels=NC)
    init_weights(m, torch.Generator().manual_seed(seed))
    return m.to(memory_format=torch.channels_last)


MODELS = {"relay": relay_model, "stc": stc_model,
          "gtc": lambda seed=0: stc_model(seed, gate=True)}


def batch(seed: int = 0, hw: int = 48):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (BATCH, hw, hw, 3), dtype=np.uint8)
    labs = np.zeros((BATCH, hw, hw), np.uint8)  # banded layers, as OCT labels are
    for c in range(1, NC):
        labs[:, c * hw // NC - 2 + rng.integers(0, 3):, :] = c
    return imgs, labs


def step_cfg(augment: bool = True, pinned: bool = False) -> TrainConfig:
    return TrainConfig(n_class=NC, crop_hw=(CROP, CROP), ds=True, udh=True, reg=True,
                       augment=augment, pinned_reg_noise=pinned)


class RecordingAdamW(AdamW):
    """AdamW that keeps the gradients it is given (after any reduction)."""

    def update(self, params, grads):
        self.seen = [g.detach().clone() for g in grads]
        return super().update(params, grads)


def one_step(name: str, mesh=None, seed: int = 0):
    """One augmented train step of model ``name`` on :func:`batch`; returns
    the loss, the gradients, the new BN statistics and the parameters."""
    model = MODELS[name](seed)
    opt = RecordingAdamW(LR)
    step = build_train_step(model, opt, step_cfg(), device="cpu",
                            generator=torch.Generator().manual_seed(seed + 1), mesh=mesh)
    metrics, new_bs = step(*batch(seed))
    names = list(trainable_parameters(model))
    return {"loss": metrics["total"].clone(), "grads": dict(zip(names, opt.seen)),
            "bs": {k: v.clone() for k, v in new_bs.items()},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def bn_case(mesh=None, leaky: bool = True, dtype=torch.float32, split_stats: bool = True):
    """A train BN (6 channels, 8 rows of 5x7) forward and backward: y, the
    new running statistics, dx, dweight, dbias, for this rank's rows."""
    gen = torch.Generator().manual_seed(5)
    x = (torch.randn(BATCH, 6, 5, 7, generator=gen) * 2 + 0.5).to(dtype)
    gy = torch.randn(BATCH, 6, 5, 7, generator=gen).to(dtype)
    bn = BatchNorm2d(6).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(6, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(6, generator=gen))
    rows = None
    if mesh is not None:
        rows = mesh.rows(BATCH)
        x, gy = x[rows.start:rows.stop], gy[rows.start:rows.stop]
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    with train_pass(bn, None, mesh if split_stats else None, rows if split_stats else None) as st:
        y = bn(x, leaky=leaky)
    dx, dw, db = torch.autograd.grad(y, [x, bn.weight, bn.bias], gy)
    mean, var = st[bn]
    return {"y": y.detach(), "mean": mean, "var": var, "dx": dx, "dw": dw, "db": db}


# --- the children ----------------------------------------------------------------------


def _trainer_case(mesh, root: str, seed: int = 7):
    """2 epochs of 4 steps with val (debug); then a second Trainer resumes
    the last checkpoint, and both train one epoch more."""
    from tcct_tpu_torch.data import EyeSet
    from tcct_tpu_torch.train import Trainer
    from tcct_tpu_torch.train import state as state_mod

    saves = []
    real_save = torch.save

    def counting_save(obj, path, *a, **kw):
        saves.append(str(path))
        return real_save(obj, path, *a, **kw)

    dataset = EyeSet.load("goals", root="")
    cfg = TrainConfig(n_class=dataset.out_channels, crop_hw=(CROP, CROP), ds=True)

    def trainer():
        net = RegNet(get_model("relay", dataset.out_channels, filters=16),
                     out_channels=dataset.out_channels)
        tr = Trainer(net, dataset, cfg, root=root, bs=BATCH, device="cpu", debug=True,
                     seed=seed, mesh=mesh)
        tr.steps_per_epoch = 4
        return tr

    state_mod.torch.save = counting_save
    try:
        tr = trainer()
        tr.fit(2)
    finally:
        state_mod.torch.save = real_save
    tr2 = trainer()
    tr2.resume("last")
    tr.train_epoch(2)
    tr2.train_epoch(2)
    s1, s2 = tr.state.state_dict(), tr2.state.state_dict()
    same = all(torch.equal(s1["model"][k], s2["model"][k]) for k in s1["model"])
    same &= all(torch.equal(a, b) for a, b in zip(s1["optimizer"]["mu"] + s1["optimizer"]["nu"],
                                                  s2["optimizer"]["mu"] + s2["optimizer"]["nu"]))
    same &= torch.equal(s1["generator"], s2["generator"])
    return {"saves": saves, "resume_bitwise": bool(same), "model": s1["model"]}


def _predictor_case(mesh):
    from tcct_tpu_torch.data.geometry import DatasetGeometry
    from tcct_tpu_torch.infer.predictor import VolumePredictor

    geo = DatasetGeometry("tiny", NC, 0, 64, "resize", (64, 64))
    pred = VolumePredictor(relay_model(3), geo, batch_size=4, dtype=torch.float32,
                           device="cpu", mesh=mesh)
    vol = np.random.default_rng(4).integers(0, 255, (10, 64, 64, 3), dtype=np.uint8)
    return pred.predict_scans(vol)


def _jax_case(mesh, weights: str):
    """The DP step of relay from the given weights, augmentation off, noise
    pinned, on the unaugmented 32x32 batch."""
    model = RegNet(get_model("relay", NC, filters=16), out_channels=NC)
    model.load_state_dict(torch.load(weights), strict=False)
    model = model.to(memory_format=torch.channels_last)
    step = build_train_step(model, AdamW(LR), step_cfg(augment=False, pinned=True),
                            device="cpu", mesh=mesh)
    metrics, new_bs = step(*batch(0, CROP))
    return {"loss": metrics["total"], "bs": new_bs}


def _teeth(kind: str):
    """A deliberately wrong data-parallel step, for the teeth cases."""
    import contextlib
    import inspect

    from tcct_tpu_torch.models import layers
    from tcct_tpu_torch.parallel import distributed as D

    @contextlib.contextmanager
    def patched(obj, name, value):
        old = inspect.getattr_static(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, old)

    if kind == "local_bn":  # each rank normalizes its rows by their own statistics
        return patched(layers, "bn_act_train_split",
                       lambda x, w, b, eps, leaky, count, reduce: bnstats.bn_act_train(
                           x, w, b, eps, leaky))
    if kind == "averaged_grads":  # the gather's backward unscaled: the base model's
        # per-rank shares are averaged where they should be summed (DDP's rule)
        def unscaled(ctx, g):
            return g[ctx.rows[0]:ctx.rows[1]], None, None, None
        return patched(D._GatherRows, "backward", staticmethod(unscaled))
    if kind == "local_droppath":  # masks drawn at this rank's shape
        def forward(self, x):
            if not self.training or self.rate == 0.0:
                return x
            keep = 1.0 - self.rate
            shape = (x.shape[0],) + (1,) * (x.dim() - 1)
            mask = torch.rand(shape, generator=self.train_pass.generator) < keep
            return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype))
        return patched(layers.DropPath, "forward", forward)
    raise ValueError(kind)


def _child(rank: int, world: int, store: str, out: str, weights: str, root: str) -> None:
    torch.set_num_threads(1)
    from tcct_tpu_torch.parallel import init_distributed

    init_distributed(f"file://{store}", world, rank, backend="gloo", device="cpu",
                     timeout_s=CHILD_TIMEOUT_S // 2)
    mesh = make_mesh(world)
    res = {"bn": {str(l): bn_case(mesh, leaky=l) for l in (False, True)},
           "bn_local": bn_case(mesh, split_stats=False)}
    for name in MODELS:
        res[name] = one_step(name, mesh)
    for kind, name in (("local_bn", "relay"), ("averaged_grads", "relay"),
                       ("local_droppath", "stc")):
        with _teeth(kind):
            res[kind] = one_step(name, mesh)
    res["jax"] = _jax_case(mesh, weights)
    res["predictor"] = _predictor_case(mesh)
    os.environ["TCCT_SYNTH_N"], os.environ["TCCT_SYNTH_HW"] = "8", "64x96"
    res["trainer"] = _trainer_case(mesh, root)
    torch.save(res, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


# --- the parent ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's relay step on its 8-device ('data',) mesh (the
    virtual CPU devices of tests/conftest.py), from its own init; the port
    gets the same weights through ``from_jax_variables``."""
    import jax
    import jax.numpy as jnp

    from tcct_tpu.infer.importer import export_torch_state
    from tcct_tpu.models import RegNet as JaxRegNet
    from tcct_tpu.models import get_model as jax_get_model
    from tcct_tpu.parallel import make_mesh as jax_make_mesh
    from tcct_tpu.parallel import replicate, shard_batch as jax_shard_batch
    from tcct_tpu.train import TrainConfig as JaxTrainConfig
    from tcct_tpu.train import build_train_step as jax_build_train_step
    from tcct_tpu.train.state import create_train_state
    from tcct_tpu.train.state import make_optimizer as jax_make_optimizer
    from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables

    net = JaxRegNet(base=jax_get_model("relay", NC, filters=16), out_channels=NC)
    cfg = JaxTrainConfig(n_class=NC, crop_hw=(CROP, CROP), ds=True, udh=True, reg=True,
                         augment=False, pinned_reg_noise=True)
    opt = jax_make_optimizer(steps_per_epoch=1, lr=LR)
    state = create_train_state(net, opt, jax.random.PRNGKey(3), jnp.zeros((1, CROP, CROP, 3)),
                               jnp.zeros((1, CROP, CROP, NC)))
    weights = str(tmp_path_factory.mktemp("jax") / "relay.pt")
    torch.save(from_jax_variables(flatten_variables(state.variables())), weights)
    imgs, labs = batch(0, CROP)
    mesh = jax_make_mesh(8, ("data",))
    step = jax_build_train_step(net, opt, cfg, mesh=mesh)
    with mesh:
        state1, metrics = step(replicate(mesh, state), *jax_shard_batch(mesh, (imgs, labs)))
    sd0 = {k: v.numpy() for k, v in relay_model().state_dict().items()}
    return {"weights": weights, "loss": float(metrics["total"]),
            "bs": export_torch_state({"batch_stats": state1.batch_stats}, sd0)[0]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_ref):
    """Both children's results (a list by rank)."""
    tmp = tmp_path_factory.mktemp("dp")
    out = str(tmp / "res")
    code = (f"import sys; sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]\n"
            "from test_torch_distributed import _child\n"
            "_child(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("TCCT_NUM_PROCESSES", "TCCT_PROCESS_ID", "TCCT_COORDINATOR",
                        "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(WORLD),
                               str(tmp / "store"), out, jax_ref["weights"], str(tmp / "root")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(WORLD)]


def _cat(ranks, *path):
    def get(r):
        v = r
        for k in path:
            v = v[k]
        return v
    return torch.cat([get(r) for r in ranks])


# (a) the mesh helpers -----------------------------------------------------------------


def test_pick_dp_devices_as_jax():
    assert pick_dp_devices(8, 8) == 8
    assert pick_dp_devices(2, 8) == 2
    assert pick_dp_devices(6, 8) == 6
    assert pick_dp_devices(3, 8) == 3
    assert pick_dp_devices(7, 4) == 1
    assert pick_dp_devices(8, 1) == 1


def test_make_mesh_errors_and_rows():
    mesh = make_mesh()  # no process group: this process alone
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1})
    with pytest.raises(RuntimeError, match="need 2 devices, only 1 visible"):
        make_mesh(2)
    with pytest.raises(ValueError, match=r"mesh shape \(2,\) != 1 devices"):
        make_mesh(1, shape=(2,))
    x = torch.arange(8)
    assert torch.equal(shard_batch(mesh, x), x)
    with pytest.raises(ValueError, match="does not split"):
        row_range(6, 4, 0)


def test_shard_batch_rows_are_jax_p_data_layout():
    """Rank d of a 4-rank mesh holds the rows that the JAX package's
    ``shard_batch`` puts on device d of its 4-device ('data',) mesh."""
    from tcct_tpu.parallel import make_mesh as jax_make_mesh
    from tcct_tpu.parallel import shard_batch as jax_shard_batch
    from tcct_tpu_torch.parallel.mesh import DataMesh

    jmesh = jax_make_mesh(4, ("data",))
    arr = jax_shard_batch(jmesh, np.arange(12))
    by_device = {s.device: s.index[0] for s in arr.addressable_shards}
    x = torch.arange(12)
    for d, dev in enumerate(jmesh.devices.flat):
        want = by_device[dev]
        mesh = DataMesh(("data",), {"data": 4}, 4, d, None, torch.device("cpu"), "gloo")
        assert mesh.rows(12) == (want.start, want.stop, 12)
        assert torch.equal(shard_batch(mesh, (x, x))[1], x[want])
    assert torch.equal(shard_batch(mesh, x[:6]), x[:6])  # 6 rows do not split: whole


def test_model_axis_refused():
    """A 'model' axis of 1 is a data mesh; a larger one (width sharding)
    needs a rank a device like any mesh, and shards the width for serving
    only: the train step refuses it."""
    from tcct_tpu_torch.parallel.mesh import DataMesh

    mesh = make_mesh(1, ("data", "model"), shape=(1, 1))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.width_shard(96) is None
    with pytest.raises(RuntimeError, match="need 8 devices, only 1 visible"):
        make_mesh(8, ("data", "model"), shape=(2, 4))
    wide = DataMesh(("data", "model"), {"data": 2, "model": 4}, 8, 5, None,
                    torch.device("cpu"), "gloo", 4)
    assert (wide.data_rank, wide.model_rank, wide.rows(8)) == (1, 1, (4, 8, 8))
    with pytest.raises(NotImplementedError, match="serving only"):
        build_train_step(relay_model(), AdamW(LR), step_cfg(augment=False), device="cpu",
                         mesh=wide)


def test_init_distributed_refuses_before_starting(monkeypatch):
    """NCCL for ranks without a card each is refused (NCCL refuses two ranks
    on one device), and so is a launch that names no rank count; neither
    starts a process group."""
    from tcct_tpu_torch.parallel import init_distributed
    from tcct_tpu_torch.parallel.distributed import is_initialized, launched_processes

    for k in ("TCCT_NUM_PROCESSES", "TCCT_PROCESS_ID", "TCCT_COORDINATOR", "WORLD_SIZE",
              "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert launched_processes() == 1
    with pytest.raises(ValueError, match="give num_processes"):
        init_distributed()
    with pytest.raises(ValueError, match="nccl needs a card for each rank"):
        init_distributed("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launched_processes() == 4
    assert not is_initialized()


def test_init_distributed_wants_a_card_unless_the_cpu_is_named(monkeypatch):
    """No device, or ``cuda``, asks for a card: where none is visible it
    raises before starting a process group, and only ``device='cpu'``
    runs on the CPU."""
    from tcct_tpu_torch.parallel import init_distributed
    from tcct_tpu_torch.parallel.distributed import is_initialized

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no card is visible; pass device='cpu'"):
            init_distributed("127.0.0.1:1", 2, 0, device=device)
    assert not is_initialized()


def test_trainer_refuses_a_batch_the_mesh_does_not_divide(tmp_path, monkeypatch):
    from tcct_tpu_torch.data import EyeSet
    from tcct_tpu_torch.parallel.mesh import DataMesh
    from tcct_tpu_torch.train import Trainer

    monkeypatch.setenv("TCCT_SYNTH_N", "4")
    monkeypatch.setenv("TCCT_SYNTH_HW", "32x32")
    mesh = DataMesh(("data",), {"data": 4}, 4, 0, None, torch.device("cpu"), "gloo")
    dataset = EyeSet.load("goals", root="")
    with pytest.raises(ValueError, match=r"batch size 6 must be divisible by the 4-device"):
        Trainer(relay_model(), dataset, TrainConfig(n_class=dataset.out_channels),
                root=str(tmp_path), bs=6, device="cpu", mesh=mesh)


# (b) the two-phase train BatchNorm ----------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("leaky", [False, True])
def test_split_plain_versions_are_the_one_launch_plain_versions(leaky, dtype):
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn(3, 8, 5, 6, generator=gen) * 3 + 1).to(dtype)
    gy = torch.randn(3, 8, 5, 6, generator=gen).to(dtype)
    w, b = torch.rand(8, generator=gen) + 0.5, torch.randn(8, generator=gen)
    n = x.numel() // 8
    y, mean, var = bnstats.bn_act_train(x, w, b, 1e-5, leaky)
    y2, mean2, var2 = bnstats.bn_act_normalize(x, bnstats.bn_act_sums(x, leaky), n, w, b,
                                               1e-5, leaky)
    for a, c in ((y, y2), (mean, mean2), (var, var2)):
        assert torch.equal(a, c)
    dx, dw, db = bnstats.bn_act_train_backward(x, w, mean, var, gy, 1e-5, leaky)
    sums = bnstats.bn_act_backward_sums(x, gy, leaky)
    assert torch.equal(bnstats.bn_act_backward_dx(x, w, mean, var, gy, sums, n, 1e-5, leaky), dx)
    dw2, db2 = bnstats.bn_weight_grads(sums, mean, var, 1e-5, w.dtype)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_autograd_at_one_rank_is_bitwise(dtype):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, 4, 3, generator=gen).to(dtype).requires_grad_()
    w = (torch.rand(5, generator=gen) + 0.5).requires_grad_()
    b = torch.randn(5, generator=gen).requires_grad_()
    gy = torch.randn(2, 5, 4, 3, generator=gen).to(dtype)
    one = bnstats.bn_act_train(x, w, b, 1e-5, True)
    two = bnstats.bn_act_train_split(x, w, b, 1e-5, True)
    assert all(torch.equal(p, q) for p, q in zip(one, two))
    g1 = torch.autograd.grad(one[0], [x, w, b], gy)
    g2 = torch.autograd.grad(two[0], [x, w, b], gy)
    assert all(torch.equal(p, q) for p, q in zip(g1, g2))


def test_split_ops_opcheck():
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 4, 3, 5, generator=gen).to(dtype)
        gy = torch.randn(2, 4, 3, 5, generator=gen).to(dtype)
        w, b = torch.rand(4, generator=gen) + 0.5, torch.randn(4, generator=gen)
        sums = bnstats.bn_act_sums(x, True)
        mean, var = bnstats.stats_from_sums(sums, 60)
        gs = bnstats.bn_act_backward_sums(x, gy, True)
        ops = torch.ops.tcct
        for op, args in ((ops.bn_act_sums.default, (x, True)),
                         (ops.bn_act_normalize.default, (x, sums, 60, w, b, 1e-5, True)),
                         (ops.bn_act_backward_sums.default, (x, gy, True)),
                         (ops.bn_act_backward_dx.default, (x, w, mean, var, gy, gs, 60, 1e-5,
                                                           True))):
            res = torch.library.opcheck(op, args)
            assert set(res.values()) == {"SUCCESS"}, (op, res)


@pytest.mark.parametrize("leaky", [False, True])
def test_dp_batchnorm_is_the_whole_batch_bn(ranks, one_thread, leaky):
    """Two ranks of 4 rows against one process's 8 (f32): y, dx within
    2e-6 of the largest element (the sums added in another order), the
    running statistics rtol 1e-5 / atol 1e-6, dweight and dbias summed over
    the ranks rtol 1e-5 / atol 1e-6."""
    want = bn_case(None, leaky=leaky)
    got = [r["bn"][str(leaky)] for r in ranks]
    for k in ("y", "dx"):
        have = torch.cat([g[k] for g in got])
        assert (have - want[k]).abs().max() <= 2e-6 * want[k].abs().max(), k
    for k in ("mean", "var"):
        for g in got:
            torch.testing.assert_close(g[k], want[k], rtol=1e-5, atol=1e-6)
        assert torch.equal(got[0][k], got[1][k])
    for k in ("dw", "db"):
        torch.testing.assert_close(got[0][k] + got[1][k], want[k], rtol=1e-5, atol=1e-6)


def test_teeth_per_rank_bn_statistics_miss(ranks, one_thread):
    """Each rank normalizing by its own rows' statistics: y off by far more
    than the bound above."""
    want = bn_case(None)
    have = torch.cat([r["bn_local"]["y"] for r in ranks])
    assert (have - want["y"]).abs().max() > 1e3 * 2e-6 * want["y"].abs().max()


# (c) one train step on two ranks against one process ----------------------------------


GRAD_RTOL, GRAD_GTOL = 1e-4, 1e-6  # per tensor: |err| <= RTOL |ref| + GTOL |global ref|


def _step_errors(got, want):
    """The worst ratio of each quantity's error to its bound: loss (rtol
    1e-5), gradients (per tensor, ``GRAD_RTOL |ref| + GRAD_GTOL |global|``
    in L2), BN statistics (atol 1e-5 + rtol 1e-4, tests/test_torch_train.py's),
    parameters after AdamW (2.1 lr, an Adam step's sign flips)."""
    out = {"loss": abs(float(got["loss"]) - float(want["loss"]))
           / (1e-5 * abs(float(want["loss"])))}
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in want["grads"].values())))
    out["grads"] = max(float((got["grads"][k].double() - g.double()).norm())
                       / (GRAD_RTOL * float(g.double().norm()) + GRAD_GTOL * gnorm)
                       for k, g in want["grads"].items())
    out["bs"] = max(float(((got["bs"][k] - v).abs() / (1e-5 + 1e-4 * v.abs())).max())
                    for k, v in want["bs"].items())
    out["params"] = max(float((got["params"][k] - v).abs().max()) / (2.1 * LR)
                        for k, v in want["params"].items())
    return out


@pytest.fixture(scope="module")
def single(one_thread):
    return {name: one_step(name) for name in MODELS}


@pytest.mark.parametrize("name", list(MODELS))
def test_dp_step_matches_one_process(ranks, single, name):
    errs = _step_errors(ranks[0][name], single[name])
    assert max(errs.values()) <= 1.0, errs


@pytest.mark.parametrize("name", list(MODELS))
def test_dp_step_ranks_bitwise_equal(ranks, name):
    a, b = ranks[0][name], ranks[1][name]
    assert torch.equal(a["loss"], b["loss"])
    for part in ("grads", "bs", "params"):
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)


# (d) teeth ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind, name, what", [("local_bn", "relay", "grads"),
                                              ("averaged_grads", "relay", "grads"),
                                              ("local_droppath", "stc", "grads")])
def test_teeth_wrong_dp_steps_miss_by_far(ranks, single, kind, name, what):
    """Per-rank BN statistics, the base model's per-rank gradient shares
    averaged where they add (DDP's rule; here the gather's backward
    without its factor of the rank count), DropPath masks drawn at the
    rank's shape: each misses its bound by 100x or more."""
    errs = _step_errors(ranks[0][kind], single[name])
    assert errs[what] > 100.0, errs


# (e) against the JAX package's data-parallel step ---------------------------------------


def test_dp_step_matches_jax_mesh_step(ranks, jax_ref):
    """Loss rtol 1e-5; the new BN running statistics rtol 1e-4 / atol 1e-5
    (tests/test_torch_train.py's bounds)."""
    for r in ranks:
        np.testing.assert_allclose(float(r["jax"]["loss"]), jax_ref["loss"], rtol=1e-5)
        for k, v in jax_ref["bs"].items():
            if "running" not in k:
                continue
            np.testing.assert_allclose(r["jax"]["bs"][k].numpy(), np.asarray(v), rtol=1e-4,
                                       atol=1e-5, err_msg=k)


# (f) the Trainer ----------------------------------------------------------------------


def test_trainer_dp_matches_one_process(ranks, one_thread, tmp_path, monkeypatch):
    """The epochs' summed losses within rtol 5e-4 (the JAX test's bound);
    rank 0 alone wrote checkpoints and the log; a resume on two ranks
    continues bit for bit."""
    import json

    monkeypatch.setenv("TCCT_SYNTH_N", "8")
    monkeypatch.setenv("TCCT_SYNTH_HW", "64x96")
    single = _trainer_case(None, str(tmp_path))
    assert single["resume_bitwise"]
    assert all(r["trainer"]["resume_bitwise"] for r in ranks)
    assert ranks[0]["trainer"]["saves"] and not ranks[1]["trainer"]["saves"]
    assert len(ranks[0]["trainer"]["saves"]) == len(single["saves"])

    def losses(root):
        with open(os.path.join(root, "metrics.jsonl")) as f:
            return [json.loads(line)["los_epoch"] for line in f]

    dp_root = os.path.dirname(os.path.dirname(ranks[0]["trainer"]["saves"][0]))
    dp, one = losses(dp_root), losses(str(tmp_path))
    assert len(dp) == len(one) == 2  # rank 0 alone logged
    np.testing.assert_allclose(dp, one, rtol=5e-4)
    for k, v in ranks[0]["trainer"]["model"].items():
        assert torch.equal(v, ranks[1]["trainer"]["model"][k]), k


# (g) the predictor --------------------------------------------------------------------


def test_dp_predictor_matches_one_process(ranks, one_thread):
    want = _predictor_case(None)
    for r in ranks:
        np.testing.assert_array_equal(r["predictor"], want)


def test_predictor_refuses_a_batch_the_mesh_does_not_divide():
    from tcct_tpu_torch.data.geometry import DatasetGeometry
    from tcct_tpu_torch.infer.predictor import VolumePredictor
    from tcct_tpu_torch.parallel.mesh import DataMesh

    mesh = DataMesh(("data",), {"data": 4}, 4, 0, None, torch.device("cpu"), "gloo")
    geo = DatasetGeometry("tiny", NC, 0, 64, "resize", (64, 64))
    with pytest.raises(ValueError, match="does not split"):
        VolumePredictor(relay_model(), geo, batch_size=6, dtype=torch.float32, device="cpu",
                        mesh=mesh)


# chip_smoke.py's launch table of a data-parallel step --------------------------------


def test_chip_smoke_dp_launch_table_is_the_dp_steps_calls(monkeypatch):
    """``chip_smoke.train_launches(model, data_parallel=True)`` is the calls a
    step on a mesh (one rank, no process group) makes of the two-phase
    entry points' plain versions, shape by shape as ``train_shapes`` gives
    the BNs (bf16, every loss on, DropPath on): each BN one sums and one
    normalize, each backward one sums and one dx, the loss heads' too; and
    no call of the one-launch backward."""
    from collections import Counter

    import chip_smoke

    seen = Counter()

    def counted(fn_name, key):
        real = getattr(bnstats, fn_name)

        def wrapped(*a, **k):
            seen[key(*a, **k)] += 1
            return real(*a, **k)

        monkeypatch.setattr(bnstats, fn_name, wrapped)

    def types(x, w=None):
        dn = str(x.dtype).split(".")[-1]
        return dn if w is None or w.dtype == x.dtype else dn + "/" + str(w.dtype).split(".")[-1]

    counted("bn_sums_reference", lambda x, leaky=False: ("bn_act_sums", tuple(x.shape), leaky))
    counted("bn_normalize_reference", lambda x, m, v, w, b, eps=1e-5, leaky=False:
            ("bn_act_normalize", tuple(x.shape), leaky, types(x, w)))
    counted("bn_backward_sums_reference",
            lambda x, g, leaky=False: ("bn_act_backward_sums", tuple(x.shape), leaky))
    counted("_dx_from_sums", lambda x, w, m, v, g, s, n, eps, leaky:
            ("bn_act_backward_dx", tuple(x.shape), leaky, types(x, w)))
    counted("bn_act_train_backward_reference", lambda *a, **k: ("bn_act_train_backward",))
    m = stc_model()
    cfg = TrainConfig(n_class=NC, crop_hw=(32, 32), ds=True, udh=True, reg=True, augment=False,
                      dtype=torch.bfloat16)
    step = build_train_step(m, AdamW(LR), cfg, "cpu", torch.Generator().manual_seed(0),
                            mesh=make_mesh(1))
    imgs, labs = batch(0, 32)
    step(imgs[:2], labs[:2])
    table = chip_smoke.train_shapes(m, 2, (32, 32))
    want = Counter()
    for (shape, leaky, t), n in table["bn"].items():
        want[("bn_act_sums", shape, leaky)] += n
        want[("bn_act_normalize", shape, leaky, t)] += n
    for (shape, leaky, t), n in table["bnb"].items():
        want[("bn_act_backward_sums", shape, leaky)] += n
        want[("bn_act_backward_dx", shape, leaky, t)] += n
    assert seen == want
    per_kernel = Counter()
    for key, n in seen.items():
        per_kernel[key[0]] += n
    table = chip_smoke.train_launches(m, data_parallel=True)
    assert dict(per_kernel) == {k: table[k] for k in chip_smoke.SPLIT_BN}
    assert table["bn_act_train"] == table["bn_act_train_backward"] == 0
    assert chip_smoke.train_launches(m)["bn_act_train"] == table["bn_act_sums"] == 53
