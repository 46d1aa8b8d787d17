"""Step-0 gradients of the rest of the zoo in the port vs the JAX package
(CPU, 64x64): ``vitu``, ``msca``, ``tcct32``, ``relay`` and ``stc_tt`` with
the ``factor``, ``hydra`` and ``metapool2d`` mixers.  The reference is the
JAX package's loss run in f64; the bound and the reasons are in
``tests/test_torch_zoo_train.py``.  Their logits, weights and serving are
in ``tests/test_torch_zoo_serving.py``."""

import pytest
import torch

from tests.test_torch_zoo_train import check_step0_gradients


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,mixer", [("vitu", "metapool"), ("msca", "metapool"),
                                        ("tcct32", "metapool"), ("relay", "metapool"),
                                        ("stc_tt", "factor"), ("stc_tt", "hydra"),
                                        ("stc_tt", "metapool2d")])
def test_step0_gradients_match_jax(name, mixer):
    assert check_step0_gradients(name, mixer) > 60
