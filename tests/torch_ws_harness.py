"""Shared parts of the width-shard rank tests (``tests/test_torch_width_shard_*.py``):
gloo processes on the CPU, one thread each, serving width-sharded models through
``VolumePredictor(mesh=)``, and the references they are held to (the one-process
port, the JAX package's predictor sharded on its 8-device virtual mesh).

A test module defines a child function ``child(rank, world, store, out, weights)``
that serves its cases and ``torch.save``s a dict to ``f"{out}.{rank}"``;
:func:`run_ranks` starts one process a rank (``python -c``, the module imported from
``tests/``), computes the parent's references while they run, and returns both.
Every ``communicate`` has a timeout, a child still running after it is killed, and
the process group's own timeout bounds each collective.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from tcct_tpu_torch.data.geometry import DatasetGeometry
from tcct_tpu_torch.infer.predictor import VolumePredictor
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.parallel.mesh import shard_batch
from tcct_tpu_torch.parallel.spatial import width_blocks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 400
LAUNCHER_ENV = ("TCCT_NUM_PROCESSES", "TCCT_PROCESS_ID", "TCCT_COORDINATOR", "WORLD_SIZE",
                "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def volume(n: int, hw, seed: int = 5) -> np.ndarray:
    """``n`` seeded uint8 scans [n, H, W, 3]."""
    return np.random.default_rng(seed).integers(0, 255, (n,) + tuple(hw) + (3,), dtype=np.uint8)


def geometry(hw, nc: int) -> DatasetGeometry:
    return DatasetGeometry(f"ws{hw[0]}x{hw[1]}", nc, 0, hw[0], "resize", tuple(hw))


def build(name: str, mixer: str, nc: int) -> RegNet:
    """The registry's ``name`` (its default variant) with ``mixer``."""
    return RegNet(get_model(name, nc, mixer=mixer), out_channels=nc)


def seeded(name: str, mixer: str, nc: int, seed: int, hw) -> RegNet:
    """:func:`build` with seeded weights and BN statistics calibrated on a
    seeded volume (``tests/test_torch_models.calibrate_bn``)."""
    from tests.test_torch_models import calibrate_bn

    m = build(name, mixer, nc)
    init_weights(m, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        calibrate_bn(m, torch.from_numpy(volume(2, hw, seed=seed + 100).astype(np.float32) / 255.0))
    return m


def serve(model, geo, batch: int, mesh, cnn_impl: str, vol) -> dict:
    """The f32 predictor's maps of ``vol`` (one bucket-sized batch), the
    main head's logits of this rank's block of it (rows and columns), and
    the shard's exchange and reduction counts."""
    pred = VolumePredictor(model, geo, batch_size=batch, dtype=torch.float32, device="cpu",
                           cnn_impl=cnn_impl, mesh=mesh)
    maps = pred.predict_scans(vol)
    block = torch.from_numpy(np.ascontiguousarray(shard_batch(mesh, vol[:batch])))
    stats = dict(pred.shard.stats) if pred.shard is not None else {}
    return {"maps": maps, "logits": pred.logits(block), "stats": stats}


def one_process(model, geo, batch: int, cnn_impl: str, vol) -> dict:
    """The one-process predictor's logits of ``vol`` and maps."""
    pred = VolumePredictor(model, geo, batch_size=batch, dtype=torch.float32, device="cpu",
                           cnn_impl=cnn_impl)
    return {"logits": pred.logits(torch.from_numpy(vol[:batch])), "maps": pred.predict_scans(vol)}


def block_of(t: torch.Tensor, coords, shape) -> torch.Tensor:
    """Rank (d, m)'s rows and columns of a whole [B, H, W, ...] tensor in the
    width shard's layout (``parallel.spatial.width_blocks``)."""
    (d, m), (D, M) = coords, shape
    b, blocks = t.shape[0] // D, width_blocks(t.shape[2], M)
    start = sum(blocks[:m])
    return t[d * b:(d + 1) * b, :, start:start + blocks[m]]


def init_child(rank: int, world: int, store: str):
    """One thread, the gloo group over the file store ``store``."""
    torch.set_num_threads(1)
    from tcct_tpu_torch.parallel import init_distributed

    init_distributed(f"file://{store}", world, rank, backend="gloo", device="cpu",
                     timeout_s=CHILD_TIMEOUT_S // 2)


def run_ranks(module: str, world: int, tmp, weights: str, references):
    """Start ``world`` processes running ``module.child``, call
    ``references()`` here while they run, wait for them; returns (the
    children's results by rank, the references)."""
    out = str(tmp / "res")
    code = (f"import sys; sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tests')!r}]\n"
            f"from {module} import child\n"
            "child(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])\n")
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world),
                               str(tmp / "store"), out, weights],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        refs = references()
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)], refs


def jax_sharded_maps(model, name: str, mixer: str, nc: int, hw, vol, batch: int) -> np.ndarray:
    """The JAX package's ``VolumePredictor`` on its (2, 4) ``('data',
    'model')`` mesh of 8 virtual CPU devices (GSPMD's width shard), f32, on
    the port model's weights: the maps of ``vol``."""
    import jax
    import jax.numpy as jnp

    from tcct_tpu.data.geometry import DatasetGeometry as JaxGeometry
    from tcct_tpu.infer.importer import import_torch_state
    from tcct_tpu.infer.predictor import VolumePredictor as JaxVolumePredictor
    from tcct_tpu.models import RegNet as JaxRegNet
    from tcct_tpu.models import get_model as jax_get_model
    from tcct_tpu.models.layers import feats_gate
    from tcct_tpu.parallel import make_mesh, replicate

    variant = "t32" if name == "tcct32" else "infer"  # the port's registry defaults
    net = JaxRegNet(base=jax_get_model(name, nc, variant=variant, mixer=mixer), out_channels=nc)
    with feats_gate(False):
        shapes = jax.eval_shape(lambda: net.init({"params": jax.random.PRNGKey(0)},
                                                 jnp.zeros((1,) + tuple(hw) + (3,)),
                                                 train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    jv, report = import_torch_state(sd, zeros)
    for path in report.untouched_target:  # ReLayNet's bare PReLU slopes
        node, (*heads, leaf) = jv, path.split("/")
        for h in heads:
            node = node[h]
        node[leaf] = sd[".".join(heads[1:]) + ".prelu.weight"].copy()
    mesh = make_mesh(8, ("data", "model"), shape=(2, 4))
    jgeo = JaxGeometry(f"ws{hw[0]}x{hw[1]}", nc, 0, hw[0], "resize", tuple(hw))
    pred = JaxVolumePredictor(net, replicate(mesh, jv), jgeo, batch_size=batch,
                              dtype=jnp.float32, mesh=mesh)
    return pred.predict_scans(vol)
