"""The width-sharded predictor of the port on the CPU: four gloo processes,
one thread each, as ``('data', 'model')`` meshes of shape (1, 4) and (2, 2),
against one process and against the JAX package's unsharded predictor.

The children run :func:`child` through ``tests/torch_ws_harness.py::run_ranks``
(``python -c``, this file imported from ``tests/``), meet through a
``FileStore`` in ``tmp_path``, run every case in one go and write their
results with ``torch.save``; the references run in this process while the
children run.

What is held (the JAX test ``tests/test_sharding.py::
test_spatial_sharded_predictor_matches`` is the model): ``stc_tt``
``infer`` at full width, f32, a 64x256 bucket, batch 4, JAX's seed-5 uint8
volume, calibrated BN statistics (``tests/test_torch_models.calibrate_bn``),
the same weights in every rank, in the one-process port and in JAX
(``tcct_tpu/infer/importer.py::import_torch_state``):
- every rank returns the whole volume's maps, equal on every rank;
- the main head's logits of each rank's block within 1e-4 of the
  one-process port's at those rows and columns; the maps on > 0.999 of
  pixels (JAX's bound for its own sharded predictor);
- against the JAX predictor: maps on > 0.999 of pixels, logits within
  1e-3 (the port's parity bound);
- a narrow ``stc_tb`` (the wide CNN branch: 1xk convs up to k = 13) at
  (1, 4), likewise against the one-process port;
- the halo exchanges a batch, counted on every rank;
- the errors: ``make_mesh`` for a shape that does not match the ranks, the
  predictor for a width that does not split.

The rest of the zoo on a width shard is ``tests/test_torch_width_shard_zoo.py``'s.
"""

import os

import numpy as np
import pytest
import torch

import torch_ws_harness as H
from tcct_tpu_torch.data.geometry import DatasetGeometry
from tcct_tpu_torch.infer.predictor import VolumePredictor
from tcct_tpu_torch.models import RegNet, get_model
from tcct_tpu_torch.models.layers import init_weights
from tcct_tpu_torch.models.mpvit import MPViTConfig
from tcct_tpu_torch.models.ftc import FTC
from tcct_tpu_torch.parallel.mesh import DataMesh

WORLD, NC, BATCH = 4, 5, 4
GEO = DatasetGeometry("wide", NC, 0, 64, "resize", (64, 256))
MESHES = ((1, 4), (2, 2))


def volume() -> np.ndarray:
    """The JAX test's volume: 4 uint8 scans, 64x256, seed 5."""
    return H.volume(BATCH, (64, 256))


def stc_tt() -> RegNet:
    return RegNet(get_model("stc_tt", NC), out_channels=NC)


def stc_tb_narrow() -> RegNet:
    """``stc_tb``'s structure (the wide CNN branch, 32..256 channels, 1xk
    convs k = 13 .. 5) with a narrow MPViT."""
    cfg = MPViTConfig(embed_dims=(16, 24, 32, 40), num_heads=(2, 2, 2, 2))
    return RegNet(FTC(cfg, cnn_tiny=False, out_channels=NC), out_channels=NC)


MODELS = {"stc_tt": stc_tt, "stc_tb": stc_tb_narrow}
# halo exchanges of one stc_tt forward: the CNN branch's stem conv and five
# blocks of five exchanged convs (3x3, 3x3; 1xk, 3x3; 3x3); the MPViT stem's
# two convs, a stage's patch embed, ConvPosEnc, MetaPool site and ResBlock
# depthwise conv (four stages); the head and four decoder blocks' 3x3 conv
# and upsampling
STC_TT_EXCHANGES = (1 + 5 * 5) + (2 + 4 * 4) + (1 + 4 * 2)


def _serve(model, mesh):
    """The predictor's maps of the volume, the main head's logits of this
    rank's block (rows and columns) of its one batch, the exchanges."""
    got = H.serve(model, GEO, BATCH, mesh, "plain", volume())
    got["exchanges"] = got.pop("stats")
    return got


def _load(name: str, weights: str) -> RegNet:
    model = MODELS[name]()
    model.load_state_dict(torch.load(os.path.join(weights, name + ".pt")))
    return model


def child(rank: int, world: int, store: str, out: str, weights: str) -> None:
    from tcct_tpu_torch.parallel import make_mesh

    H.init_child(rank, world, store)
    res = {}
    try:
        make_mesh(world, ("data", "model"), shape=(2, 3))
    except ValueError as e:
        res["shape_error"] = str(e)
    for shape in MESHES:
        mesh = make_mesh(world, ("data", "model"), shape=shape)
        res[shape] = {"coords": (mesh.data_rank, mesh.model_rank)}
        res[shape].update(_serve(_load("stc_tt", weights), mesh))
    res["stc_tb"] = _serve(_load("stc_tb", weights),
                           make_mesh(world, ("data", "model"), shape=(1, 4)))
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
def weights(tmp_path_factory):
    """Both models with seeded weights and calibrated BN statistics, and the
    folder of their state dicts."""
    from tests.test_torch_models import calibrate_bn

    folder = tmp_path_factory.mktemp("ws")
    models = {}
    for seed, (name, make) in enumerate(MODELS.items()):
        m = make()
        init_weights(m, torch.Generator().manual_seed(seed))
        calibrate_bn(m, torch.from_numpy(volume().astype(np.float32) / 255.0))
        torch.save(m.state_dict(), str(folder / f"{name}.pt"))
        models[name] = m
    return models, str(folder)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights, one_thread):
    """Every child's results (a list by rank), and the references computed
    here while they ran: the one-process port's logits and maps, stc_tb's,
    and the JAX predictor's maps and logits on the same weights."""
    return H.run_ranks("test_torch_width_shard_ranks", WORLD, tmp_path_factory.mktemp("ws_ranks"),
                       weights[1], lambda: _references(weights[0]))


def _references(models):
    import jax
    import jax.numpy as jnp

    from tcct_tpu.data.geometry import DatasetGeometry as JaxGeometry
    from tcct_tpu.infer.importer import import_torch_state
    from tcct_tpu.infer.predictor import VolumePredictor as JaxVolumePredictor
    from tcct_tpu.models import RegNet as JaxRegNet
    from tcct_tpu.models import get_model as jax_get_model

    vol = volume()
    x = torch.from_numpy(vol)
    refs = {}
    for name, m in models.items():
        one = VolumePredictor(m, GEO, batch_size=BATCH, dtype=torch.float32, device="cpu")
        refs[name] = {"logits": one.logits(x), "maps": one.predict_scans(vol)}
    model = models["stc_tt"]
    net = JaxRegNet(base=jax_get_model("stc_tt", NC, variant="infer", mixer="metapool_pallas"),
                    out_channels=NC)
    v = jax.jit(lambda: net.init({"params": jax.random.PRNGKey(0)},
                                 jnp.zeros((1, 64, 256, 3)), train=False))()
    v, _ = import_torch_state({k: t.numpy() for k, t in model.state_dict().items()}, v)
    jgeo = JaxGeometry("wide", NC, 0, 64, "resize", (64, 256))
    refs["jax_maps"] = JaxVolumePredictor(net, v, jgeo, batch_size=BATCH,
                                          dtype=jnp.float32).predict_scans(vol)
    ys, _ = jax.jit(lambda v, x: net.apply(v, x, train=False))(v, vol.astype(np.float32) / 255.0)
    refs["jax_logits"] = torch.from_numpy(np.array(ys[0]))
    return refs


@pytest.mark.parametrize("shape", MESHES)
def test_width_sharded_stc_tt_matches_one_process(ranks, shape):
    """Logits within 1e-4 of one process at each rank's block, maps on
    > 0.999 of pixels, and every rank returns the same whole-volume maps."""
    res, refs = ranks
    for r in range(WORLD):
        got = res[r][shape]
        assert got["maps"].shape == (BATCH, 64, 256) and got["maps"].dtype == np.uint8
        np.testing.assert_array_equal(got["maps"], res[0][shape]["maps"])
        want = H.block_of(refs["stc_tt"]["logits"], got["coords"], shape)
        torch.testing.assert_close(got["logits"], want, atol=1e-4, rtol=0)
    assert len(np.unique(refs["stc_tt"]["maps"])) > 1
    assert (res[0][shape]["maps"] == refs["stc_tt"]["maps"]).mean() > 0.999


@pytest.mark.parametrize("shape", MESHES)
def test_width_sharded_stc_tt_matches_jax(ranks, shape):
    """Against the JAX package's unsharded predictor on the same weights:
    maps on > 0.999 of pixels, logits within 1e-3."""
    res, refs = ranks
    assert (res[0][shape]["maps"] == refs["jax_maps"]).mean() > 0.999
    for r in range(WORLD):
        got = res[r][shape]
        want = H.block_of(refs["jax_logits"], got["coords"], shape)
        torch.testing.assert_close(got["logits"], want, atol=1e-3, rtol=0)


def test_width_sharded_stc_tb_matches_one_process(ranks):
    """The wide CNN branch (1x13 .. 1x5 halos, 32..256 channels) at (1, 4)."""
    res, refs = ranks
    for r in range(WORLD):
        got = res[r]["stc_tb"]
        np.testing.assert_array_equal(got["maps"], res[0]["stc_tb"]["maps"])
        want = H.block_of(refs["stc_tb"]["logits"], (0, r), (1, 4))
        torch.testing.assert_close(got["logits"], want, atol=1e-4, rtol=0)
    assert len(np.unique(refs["stc_tb"]["maps"])) > 1
    assert (res[0]["stc_tb"]["maps"] == refs["stc_tb"]["maps"]).mean() > 0.999


def test_halo_exchanges_are_counted_alike(ranks):
    """Every rank of a 'model' group makes the same exchanges (a collective
    issued by some ranks only would hang): the counts agree, and stc_tt's
    batch makes one for each exchanged conv, site and upsampling."""
    res, _ = ranks
    for shape in MESHES:
        counts = [res[r][shape]["exchanges"]["exchanges"] for r in range(WORLD)]
        assert len(set(counts)) == 1 and counts[0] > 0
    assert res[0][(1, 4)]["exchanges"]["exchanges"] == STC_TT_EXCHANGES  # the one batch


def test_make_mesh_refuses_a_shape_that_does_not_match(ranks):
    res, _ = ranks
    assert all("mesh shape (2, 3) != 4 devices" in res[r]["shape_error"] for r in range(WORLD))


def _mesh(shape, rank: int = 0) -> DataMesh:
    """A (D, M) mesh's view from ``rank``, without a process group: what the
    predictor checks before any collective."""
    return DataMesh(("data", "model"), {"data": shape[0], "model": shape[1]},
                    shape[0] * shape[1], rank, None, torch.device("cpu"), "gloo", shape[1])


def test_predictor_refuses_a_width_that_does_not_split():
    """A width that is not a multiple of M raises naming JAX's rule (96
    columns over 5 ranks); so does one whose 16-column units are fewer than
    the ranks (48 over 4: a rank would hold none).  96 over 4 serves
    (blocks 32, 32, 16, 16; ``tests/test_torch_width_shard_zoo.py``)."""
    geo = DatasetGeometry("odd", NC, 0, 64, "resize", (64, 96))  # 96 = 16 x 6
    with pytest.raises(ValueError, match="NamedSharding wants a sharded dimension divisible"):
        VolumePredictor(stc_tt(), geo, batch_size=4, dtype=torch.float32, device="cpu",
                        mesh=_mesh((1, 5)))
    narrow = DatasetGeometry("narrow", NC, 0, 64, "resize", (64, 48))
    with pytest.raises(ValueError, match="a rank would hold no columns"):
        VolumePredictor(stc_tt(), narrow, batch_size=4, dtype=torch.float32, device="cpu",
                        mesh=_mesh((1, 4)))
    pred = VolumePredictor(stc_tt(), geo, batch_size=4, dtype=torch.float32, device="cpu",
                           mesh=_mesh((1, 4), rank=2))
    assert pred.shard.blocks == (32, 32, 16, 16) and pred.shard.level(16) == (64, 96)


@pytest.mark.parametrize("net,mixer,cnn_impl", [
    ("stc_tt", "factor", "plain"), ("stc_tt", "hydra", "plain"),
    ("stc_tt", "metapool2d", "plain"), ("relay", "metapool", "plain"),
    ("stc_tt", "metapool", "fused")])
def test_predictor_builds_what_a_shard_once_refused(net, mixer, cnn_impl):
    """The attention and spatial-pool mixers, ReLayNet and the fused CNN
    branch build on a (2, 2) mesh (they are served on four ranks in
    ``tests/test_torch_width_shard_zoo.py``)."""
    model = RegNet(get_model(net, NC, mixer=mixer), out_channels=NC)
    pred = VolumePredictor(model, GEO, batch_size=4, dtype=torch.float32, device="cpu",
                           cnn_impl=cnn_impl, mesh=_mesh((2, 2)))
    assert pred.shard.blocks == (128, 128)


def test_width_shard_does_not_train():
    from tcct_tpu_torch.train import AdamW, TrainConfig, build_train_step

    with pytest.raises(NotImplementedError, match="serving only"):
        build_train_step(stc_tt(), AdamW(1e-3), TrainConfig(n_class=NC, augment=False),
                         device="cpu", mesh=_mesh((2, 2)))


@pytest.mark.parametrize("entry", ["build_eval_step", "build_eval_epoch", "train_pass"])
def test_width_shard_does_not_eval_rows(entry):
    """The entry points that split rows only refuse a 'model' axis above 1
    (they would gather every row block once per 'model' rank)."""
    from tcct_tpu_torch.models.layers import train_pass
    from tcct_tpu_torch.train import TrainConfig, build_eval_epoch, build_eval_step

    mesh, cfg = _mesh((2, 2)), TrainConfig(n_class=NC, augment=False)
    with pytest.raises(NotImplementedError, match=f"{entry}: a 'model' axis of 2"):
        if entry == "train_pass":
            with train_pass(stc_tt(), mesh=mesh):
                pass
        else:
            {"build_eval_step": build_eval_step, "build_eval_epoch": build_eval_epoch}[entry](
                stc_tt(), cfg, device="cpu", mesh=mesh)
