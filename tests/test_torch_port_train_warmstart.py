"""The port's warm start (``model/import_pt.py``, ``io/torch_pt.py``) against
the JAX package's.

The ``.pt`` fixtures are built here as ``tests/test_torch_pt.py`` builds
them: its torch replica of YOLO11n-seg, whose module tree reproduces
ultralytics' state_dict keys, pickled whole by ``torch.save`` (which
``torch.load(weights_only=True)`` refuses), in float32, float16 and
bfloat16, with COCO's 80 classes and with 1. Both packages start from the
same initial weights (the JAX model's ``init``, bridged to a state_dict).

Tolerance: none. The port's ``load_pretrained`` gives the state_dict that
``model/bridge.py`` makes of the JAX package's ``load_pretrained`` output on
the same file; the two reports transfer and skip the same keys.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_pt import TYolo11Seg, _save_ckpt
from tpu_mslesseg.io import torch_pt as jpt
from tpu_mslesseg.model import import_pt as jimp
from tpu_mslesseg.model.yolo11 import YoloConfig
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg_torch.io import torch_pt as tpt
from tpu_mslesseg_torch.model import import_pt as timp
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.train import trainer
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def init():
    jmodel, _ = j_create(nc=1, scale="n")
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32)))
    tmodel, _ = t_create(nc=1, scale="n")
    return variables, tmodel


@pytest.mark.parametrize("nc", [80, 1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_load_pretrained_equals_the_bridged_jax_import(init, tmp_path, dtype, nc):
    variables, tmodel = init
    torch.manual_seed(3)
    path = _save_ckpt(tmp_path, TYolo11Seg(YoloConfig(nc=nc, scale="n")).to(DTYPES[dtype]))
    jnew, jrep = jimp.load_pretrained(path, variables)
    want = state_dict_from_reference(jnew, tmodel)
    got, trep = timp.load_pretrained(path, state_dict_from_reference(variables, tmodel))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    assert sorted(trep["transferred"]) == sorted(jrep["transferred"])
    assert trep["total_ours"] == jrep["total_ours"]
    assert sorted(m.split(" ")[0] for m in trep["mismatched"]) == \
        sorted(m.split(" ")[0] for m in jrep["mismatched"])
    assert trep["train_args"] == jrep["train_args"] == {"nc": nc}
    if nc == 80:  # only the class towers' last convolutions keep their initial values
        assert trep["mismatched"] and all(m.startswith("model.23.cv3.") for m in trep["mismatched"])
    else:
        assert trep["mismatched"] == []


def test_reader_equals_jax_and_torch(tmp_path):
    torch.manual_seed(4)
    module = TYolo11Seg(YoloConfig(nc=1, scale="n")).to(torch.bfloat16)
    path = _save_ckpt(tmp_path, module)
    got = tpt.state_dict(tpt.load_pt(path)["model"])
    want = jpt.state_dict(jpt.load_pt(path)["model"])
    assert got.keys() == want.keys() == module.state_dict().keys()
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32))
        np.testing.assert_array_equal(got[k], v.float().numpy())
    with pytest.raises(Exception):  # the file pickles a module: weights_only refuses it
        torch.load(path, weights_only=True)


def test_nothing_matches_raises(tmp_path):
    path = tmp_path / "other.pt"
    torch.save({"model": torch.nn.Linear(3, 2)}, path)
    tmodel, _ = t_create(nc=1, scale="n")
    with pytest.raises(ValueError, match="no parameter matched"):
        timp.load_pretrained(path, tmodel.state_dict())


def test_train_state_warm_starts_from_cfg_pretrained(init, tmp_path):
    variables, tmodel = init
    torch.manual_seed(5)
    path = _save_ckpt(tmp_path, TYolo11Seg(YoloConfig(nc=80, scale="n")))
    sd0 = state_dict_from_reference(variables, tmodel)
    want, _ = timp.load_pretrained(path, sd0)
    cfg = trainer.TrainConfig(imgsz=64, pretrained=str(path))
    state = trainer.init_train_state(t_create(nc=1, scale="n")[0], cfg, 2, variables=sd0,
                                     device="cpu")
    got = state.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(state.ema[k], want[k]) for k in state.ema)
