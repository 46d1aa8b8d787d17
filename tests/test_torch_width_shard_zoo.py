"""The rest of the zoo on a width shard, on the CPU: four gloo processes, one
thread each, as ``('data', 'model')`` meshes of shape (1, 4) and (2, 2), serving
the paths a width shard gained after the MetaPool FTC family, against one
process and against the JAX package's predictor on its (2, 4) mesh of 8 virtual
devices (GSPMD's width shard) at both widths; the harness is
``tests/torch_ws_harness.py``.

The paths, each at full width in f32 with seeded weights and calibrated BN
statistics (the same in every rank, in the one-process port and in JAX):
``stc_tt`` with the ``factor``, ``hydra`` and ``metapool2d`` mixers, ``relay``,
``msca`` and ``stc_tt`` with ``cnn_impl='fused'`` (K4's plain version on haloed
blocks); each on a 32x128 bucket (even blocks) and a 32x96 one (blocks 32, 32, 16,
16 at M = 4), batch 4.  Then, at (1, 4): ``stc_tt`` with the fused branch on heg's 672
columns (blocks 176, 176, 160, 160) and ``msca`` on duke's 576 (the 1x21 strip conv's 10-column
halo reaches past the 9 columns a rank holds at the deepest level), 32 rows; and every
other name of the registry (its default variant, the MetaPool mixer: the FTC family, by
both of its names for ``stc_tt``, and ``tcct32``; ``stc_tt`` with ``metapool_pallas``) on
the 32x96 bucket.

Held: every rank returns the same whole maps; each rank's f32 logits within 1e-4
of the one-process port's at its rows and columns; the maps on > 0.999 of pixels
of one process's and of the JAX sharded predictor's; the exchanges and
all-reduces each rank counts equal across the ranks and
``chip_smoke.py::ws_exchanges``'s count from the config.
"""

import os
import sys

import numpy as np
import pytest
import torch

import torch_ws_harness as H

NC, BATCH, ROWS = 5, 4, 32
WORLD = 4
MESHES = ((1, 4), (2, 2))
WIDTHS = (128, 96)  # 96 = 6 x 16 columns: blocks 32, 32, 16, 16 over M = 4
# key: (registry name, mixer, cnn_impl)
CASES = {"factor": ("stc_tt", "factor", "plain"), "hydra": ("stc_tt", "hydra", "plain"),
         "metapool2d": ("stc_tt", "metapool2d", "plain"), "relay": ("relay", "metapool", "plain"),
         "msca": ("msca", "metapool", "plain"), "fused": ("stc_tt", "metapool", "fused")}
# key: (a key of CASES, input width), served at (1, 4) only: bucket widths of the registry
WIDE = {"heg": ("fused", 672), "msca_duke": ("msca", 576)}
# key: (registry name, mixer), served plain at (1, 4) and 32x96 only
NAMES = {name: (name, "metapool") for name in
         ("stc_tt", "tcct", "stc_tb", "stc_st", "stc_sb", "gtc_tt", "gtc_tb", "cnnu", "pnnu",
          "vitu", "tcct32")}
NAMES["stc_tt_pallas"] = ("stc_tt", "metapool_pallas")
NAMES_HW = (ROWS, 96)
JAX_MIXER = {"metapool": "metapool_pallas", "metapool_pallas": "metapool"}


def _load(key: str, weights: str, cases=CASES):
    name, mixer = cases[key][:2]
    m = H.build(name, mixer, NC)
    m.load_state_dict(torch.load(os.path.join(weights, key + ".pt")))
    return m


def child(rank: int, world: int, store: str, out: str, weights: str) -> None:
    from tcct_tpu_torch.parallel import make_mesh

    H.init_child(rank, world, store)
    res = {}
    meshes = {shape: make_mesh(world, ("data", "model"), shape=shape) for shape in MESHES}
    for key, (_, _, cnn_impl) in CASES.items():
        for shape, mesh in meshes.items():
            for W in WIDTHS:
                hw = (ROWS, W)
                got = H.serve(_load(key, weights), H.geometry(hw, NC), BATCH, mesh, cnn_impl,
                              H.volume(BATCH, hw))
                got["coords"] = (mesh.data_rank, mesh.model_rank)
                res[key, shape, W] = got
    for key, (case, W) in WIDE.items():
        hw = (ROWS, W)
        res[key] = H.serve(_load(case, weights), H.geometry(hw, NC), BATCH, meshes[(1, 4)],
                           CASES[case][2], H.volume(BATCH, hw))
    for key in NAMES:
        res["name", key] = H.serve(_load(key, weights, NAMES), H.geometry(NAMES_HW, NC), BATCH,
                                   meshes[(1, 4)], "plain", H.volume(BATCH, NAMES_HW))
    torch.save(res, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every child's results (by rank) and the references: the one-process
    port's logits and maps of each case, name and width, and the JAX sharded
    predictor's maps."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    folder = tmp_path_factory.mktemp("ws_zoo")
    models = {}
    for seed, (key, (name, mixer, _)) in enumerate(CASES.items()):
        models[key] = H.seeded(name, mixer, NC, seed, (ROWS, 96))
        torch.save(models[key].state_dict(), str(folder / f"{key}.pt"))
    for seed, (key, (name, mixer)) in enumerate(NAMES.items()):
        models[key] = H.seeded(name, mixer, NC, 20 + seed, NAMES_HW)
        torch.save(models[key].state_dict(), str(folder / f"{key}.pt"))

    def references():
        refs = {}
        for key, (name, mixer, cnn_impl) in CASES.items():
            for W in WIDTHS:
                hw = (ROWS, W)
                refs[key, W] = H.one_process(models[key], H.geometry(hw, NC), BATCH, cnn_impl,
                                             H.volume(BATCH, hw))
                refs[key, W, "jax"] = H.jax_sharded_maps(
                    models[key], name, JAX_MIXER.get(mixer, mixer), NC, hw, H.volume(BATCH, hw),
                    BATCH)
        for key, (case, W) in WIDE.items():
            hw = (ROWS, W)
            refs[key] = H.one_process(models[case], H.geometry(hw, NC), BATCH, CASES[case][2],
                                      H.volume(BATCH, hw))
        vol = H.volume(BATCH, NAMES_HW)
        for key, (name, mixer) in NAMES.items():
            refs["name", key] = dict(
                H.one_process(models[key], H.geometry(NAMES_HW, NC), BATCH, "plain", vol),
                jax=H.jax_sharded_maps(models[key], name, JAX_MIXER[mixer], NC, NAMES_HW, vol,
                                       BATCH))
        return refs

    try:
        yield H.run_ranks("test_torch_width_shard_zoo", WORLD, tmp_path_factory.mktemp("run"),
                          str(folder), references)
    finally:
        torch.set_num_threads(n)


def _held(res, want, shape, what):
    """Every rank's maps equal; each rank's logits within 1e-4 of one
    process's at its block; the maps on > 0.999 of one process's."""
    for r in range(WORLD):
        got = res[r]
        np.testing.assert_array_equal(got["maps"], res[0]["maps"], err_msg=what)
        coords = got.get("coords", (0, r))
        torch.testing.assert_close(got["logits"], H.block_of(want["logits"], coords, shape),
                                   atol=1e-4, rtol=0, msg=what)
    assert len(np.unique(want["maps"])) > 1, what
    assert (res[0]["maps"] == want["maps"]).mean() > 0.999, what


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("shape", MESHES, ids=["1x4", "2x2"])
@pytest.mark.parametrize("key", list(CASES))
def test_width_shard_serves_like_one_process(ranks, key, shape, W):
    res, refs = ranks
    _held([res[r][key, shape, W] for r in range(WORLD)], refs[key, W], shape,
          f"{key} {shape} W {W}")


@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("key", list(CASES))
def test_width_shard_serves_like_jax_sharded(ranks, key, W):
    """The port's maps at (1, 4) and (2, 2) on > 0.999 of pixels of the JAX
    predictor's on its (2, 4) mesh (at 32x96 the port's blocks are 32, 32,
    16, 16 over 4 ranks, JAX's 24 each)."""
    res, refs = ranks
    for shape in MESHES:
        assert (res[0][key, shape, W]["maps"] == refs[key, W, "jax"]).mean() > 0.999, shape


@pytest.mark.parametrize("key", list(WIDE))
def test_width_shard_serves_registry_widths(ranks, key):
    """heg's 672 columns over 4 ranks (176, 176, 160, 160) with K4 on haloed
    blocks; msca on duke's 576 over 4 (9 columns a rank at the deepest level,
    the 1x21 strip conv's halo from two ranks)."""
    res, refs = ranks
    _held([res[r][key] for r in range(WORLD)], refs[key], (1, 4), key)


def test_exchanges_and_reductions_follow_the_config(ranks):
    """Every rank of a group makes the same exchanges and all-reduces (a
    collective issued by some ranks only would hang), as many as
    ``chip_smoke.py::ws_exchanges`` counts from the model's config: factor 3
    all-reduces a block, hydra 1, none elsewhere."""
    sys.path.insert(0, H.REPO)
    import chip_smoke

    res, _ = ranks
    for key, (name, mixer, cnn_impl) in CASES.items():
        want = chip_smoke.ws_exchanges(H.build(name, mixer, NC), cnn_impl == "fused")
        for shape in MESHES:
            for W in WIDTHS:
                for r in range(WORLD):
                    s = res[r][key, shape, W]["stats"]
                    assert (s.get("exchanges", 0), s.get("reduces", 0)) == want, (key, shape, W)
                    assert s["bytes"] == res[0][key, shape, W]["stats"]["bytes"]
        assert want[1] == {"factor": 12, "hydra": 4}.get(key, 0)


@pytest.mark.parametrize("key", list(NAMES))
def test_every_name_serves_on_a_width_shard(ranks, key):
    """Each name at (1, 4) on 32x96: held as above, the maps also on > 0.999
    of the JAX sharded predictor's, the exchanges and all-reduces as
    ``chip_smoke.py::ws_exchanges`` counts them."""
    sys.path.insert(0, H.REPO)
    import chip_smoke

    res, refs = ranks
    want = refs["name", key]
    _held([res[r]["name", key] for r in range(WORLD)], want, (1, 4), key)
    count = chip_smoke.ws_exchanges(H.build(*NAMES[key], NC))
    for r in range(WORLD):
        s = res[r]["name", key]["stats"]
        assert (s["exchanges"], s.get("reduces", 0)) == count, (key, r)
    assert (res[0]["name", key]["maps"] == want["jax"]).mean() > 0.999
