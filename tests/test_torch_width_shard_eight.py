"""duke's 576 columns over 8 ``'model'`` ranks on the CPU: eight gloo processes,
one thread each, as a (1, 8) ``('data', 'model')`` mesh (blocks 80 x 4, 64 x 4:
36 units of 16 columns; 5 or 4 columns a rank at the deepest level), serving
``stc_tt`` on 32 rows of the duke width with the plain and the fused CNN branch
(K4's plain version on blocks widened by ``k // 2 + 2`` columns, which at the
deepest level reach past a rank), f32, against one process: every rank returns
the same whole maps, each rank's logits within 1e-4 of one process's at its
columns, the maps on > 0.999 of pixels.  The harness is
``tests/torch_ws_harness.py``.
"""

import os

import numpy as np
import pytest
import torch

import torch_ws_harness as H

NC, BATCH, HW, WORLD, SHAPE = 9, 2, (32, 576), 8, (1, 8)
IMPLS = ("plain", "fused")


def child(rank: int, world: int, store: str, out: str, weights: str) -> None:
    from tcct_tpu_torch.parallel import make_mesh

    H.init_child(rank, world, store)
    mesh = make_mesh(world, ("data", "model"), shape=SHAPE)
    res = {}
    for impl in IMPLS:
        m = H.build("stc_tt", "metapool", NC)
        m.load_state_dict(torch.load(os.path.join(weights, "stc_tt.pt")))
        res[impl] = H.serve(m, H.geometry(HW, NC), BATCH, mesh, impl, H.volume(BATCH, HW))
        res[impl]["blocks"] = H.width_blocks(HW[1], world)
    torch.save(res, f"{out}.{rank}")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    folder = tmp_path_factory.mktemp("ws_eight")
    model = H.seeded("stc_tt", "metapool", NC, 40, HW)
    torch.save(model.state_dict(), str(folder / "stc_tt.pt"))

    def references():
        vol = H.volume(BATCH, HW)
        return {impl: H.one_process(model, H.geometry(HW, NC), BATCH, impl, vol)
                for impl in IMPLS}

    try:
        yield H.run_ranks("test_torch_width_shard_eight", WORLD, tmp_path_factory.mktemp("run"),
                          str(folder), references)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("impl", IMPLS)
def test_duke_width_serves_over_eight_ranks(ranks, impl):
    res, refs = ranks
    want = refs[impl]
    assert res[0][impl]["blocks"] == (80,) * 4 + (64,) * 4
    for r in range(WORLD):
        got = res[r][impl]
        np.testing.assert_array_equal(got["maps"], res[0][impl]["maps"])
        torch.testing.assert_close(got["logits"], H.block_of(want["logits"], (0, r), SHAPE),
                                   atol=1e-4, rtol=0)
    assert len(np.unique(want["maps"])) > 1
    assert (res[0][impl]["maps"] == want["maps"]).mean() > 0.999
