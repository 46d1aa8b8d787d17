"""The models this slice adds, in the port vs the JAX package (CPU):
``msca``, ``tcct32``, ``relay`` and the ``factor``, ``hydra`` and
``metapool2d`` mixers.  Eval-mode logits of each variant at full width on a
64x96 input (within 1e-3, argmax above 99.9 %, as ``tests/test_torch_zoo.py``),
``from_jax_variables`` onto each model's state dict, the registry against
JAX's, and the predictor serving each.  Their training is in
``tests/test_torch_zoo_train.py`` and ``test_torch_zoo_mixers.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcct_tpu.models.layers import feats_gate
from tcct_tpu.models.registry import list_models as jax_list_models
from tcct_tpu_torch.infer import VolumePredictor, load_into, load_predictor
from tcct_tpu_torch.infer.importer import flatten_variables, from_jax_variables
from tcct_tpu_torch.models import RegNet, get_model, list_models
from tests.test_torch_zoo import GEO, HW, NC, pair

# (name, variant, mixer) of every model this slice adds
CASES = [("msca", "infer", "metapool"), ("msca", "train", "metapool"),
         ("tcct32", "t32", "metapool"), ("tcct32", "train", "metapool"),
         ("relay", "infer", "metapool"),
         ("stc_tt", "infer", "factor"), ("stc_tt", "train", "factor"),
         ("stc_tt", "infer", "hydra"), ("stc_tt", "train", "hydra"),
         ("stc_tt", "infer", "metapool2d"), ("stc_tt", "train", "metapool2d")]
IDS = ["-".join(c) for c in CASES]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,variant,mixer", CASES, ids=IDS)
def test_logits_match_jax(name, variant, mixer):
    """Eval-mode logits of every head, port vs JAX in f32: within 1e-3,
    argmax agreement above 99.9 %."""
    m, net, jv, x = pair(name, variant, mixer)
    with feats_gate(False):
        want, _ = jax.jit(lambda v, x: net.apply(v, x, train=False))(jv, jnp.asarray(x))
    with torch.inference_mode():
        got = m.eval().to(memory_format=torch.channels_last)(torch.from_numpy(x))
    assert len(got) == len(want) == (1 if name == "relay" else 4)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == (2,) + HW + (NC,)
        assert np.abs(w).max() > 0.5  # a real test of an absolute tolerance
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3, err_msg=f"{name} head {i}")
        assert (g.argmax(-1) == w.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("name,variant,mixer", CASES, ids=IDS)
def test_from_jax_variables_fills_the_state_dict(name, variant, mixer):
    """The JAX variables land on the port's state-dict names and shapes,
    with nothing unexpected (a load_state_dict that is strict on that side),
    and leave missing only what no serving forward reads: BatchNorm's step
    counter, the MetaPool MPViT's CRPE and classifier, ``fuse``, the RegNet
    loss heads and ReLayNet's feats heads.  ``load_into`` agrees."""
    m, _, jv, _ = pair(name, variant, mixer)
    ours = from_jax_variables(flatten_variables(jv))
    fresh = RegNet(get_model(name, NC, variant=variant, mixer=mixer), out_channels=NC)
    res = fresh.load_state_dict(ours, strict=False)
    assert res.unexpected_keys == []
    sd = m.state_dict()
    for k, t in ours.items():
        np.testing.assert_array_equal(t.numpy(), sd[k].numpy(), err_msg=k)
    dead = ["num_batches_tracked", "cls_head.", ".fuse.", "lap_", "fcp.", "tau", ".eran", ".dran"]
    if mixer not in ("factor", "hydra"):
        dead.append("crpe.")
    assert [k for k in res.missing_keys if not any(d in k for d in dead)] == []
    assert load_into(fresh, ours)[1] == []
    assert any("crpe" in k for k in ours) == (mixer in ("factor", "hydra"))


def test_importer_names():
    """MSCA's ``conv0_1`` ... keep their underscore and ReLayNet's bare
    PReLU leaf becomes an ``nn.PReLU`` weight."""
    flat = {"params/base/base_cnn/att_2/conv1_2/kernel": np.zeros((11, 1, 1, 32), np.float32),
            "params/base/encode1/prelu": np.full((1,), 0.25, np.float32)}
    assert sorted(from_jax_variables(flat)) == ["base.base_cnn.att.2.conv1_2.weight",
                                                "base.encode1.prelu.weight"]


def test_registry_equals_jax():
    assert list_models() == sorted(jax_list_models())
    for name in list_models():
        if name == "relay":
            continue
        for mixer in ("metapool", "metapool_pallas", "factor", "hydra", "metapool2d"):
            assert get_model(name, 5, mixer=mixer).vit_cfg.mixer == mixer
    assert get_model("tcct32", 5).variant == "t32"
    assert get_model("relay", 5, variant="train", mixer="hydra", drop_path_rate=0.3,
                     filters=16).encode1.conv.weight.shape == (16, 3, 7, 3)


@pytest.mark.parametrize("name,variant,mixer", [("relay", "infer", "metapool"),
                                                ("msca", "infer", "metapool"),
                                                ("tcct32", "t32", "metapool"),
                                                ("stc_tt", "infer", "hydra")])
def test_predictor_serves_the_new_models(name, variant, mixer):
    """The bucketed predictor's f32 class maps equal the argmax of the
    model's main head; ``load_predictor`` builds each name; the fused CNN
    branch refuses MSCA and a model without CrossCNN blocks."""
    m, _, _, _ = pair(name, variant, mixer)
    vol = np.random.default_rng(4).integers(0, 255, (3,) + HW + (3,), dtype=np.uint8)
    pred = VolumePredictor(m, GEO, batch_size=2, dtype=torch.float32, device="cpu")
    seg = pred.predict_scans(vol)
    with torch.inference_mode():
        want = m(torch.from_numpy(vol).float() / 255.0)[0].argmax(-1).numpy()
    assert seg.shape == (3,) + HW and (seg == want).mean() >= 0.999
    pred = load_predictor("hcms", net=name, variant=variant, mixer=mixer, batch_size=1,
                          dtype=torch.float32, device="cpu", seed=0)
    assert type(pred.model.base).__name__ == ("ReLayNet" if name == "relay" else "FTC")
    if name in ("relay", "msca"):
        with pytest.raises(ValueError, match="no CrossCNN blocks|MSCA"):
            fused = VolumePredictor(m, GEO, batch_size=2, dtype=torch.float32, device="cpu",
                                    cnn_impl="fused")
            fused.predict_scans(vol[:1])
