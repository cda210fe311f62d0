"""The port's validation pass (``train/validate.py``) against the JAX package's.

One pass at imgsz 64, float32, over the 12 slices of fold 1 of
``test_torch_port_stages``'s tree (P1 and P2, FLAIR, GC), in batches of 5
(the last padded by repeating its last slice). The weights are the JAX
model's ``init`` with seeded BatchNorm statistics and a head that keeps
boxes (``test_torch_port_consensus._perturbed``), bridged to the port's
state_dict, with the box head's DFL prior and the mask head's bias set so
that some detections match the lesions as boxes and as masks; both
packages read the same dataset arrays (the JAX package's).

Tolerances: the four val losses within 2e-4 relative (as the train step's
tests allow between the frameworks); every metric of the ``results.csv``
row within 1e-6. NMS keeps are compared image by image: the test says how
many images keep a different number of detections, and holds the metrics
as they come.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_consensus import _perturbed
from test_torch_port_stages import write_dataset
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.train import data as jdata
from tpu_mslesseg.train import validate as jval
from tpu_mslesseg.train.losses import LossConfig as JLossConfig
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.train import data as tdata
from tpu_mslesseg_torch.train import validate as tval
from tpu_mslesseg_torch.train.losses import LossConfig as TLossConfig

S, BATCH = 64, 5
METRICS = ("precision_b", "recall_b", "map50_b", "map_b", "precision_m", "recall_m", "map50_m",
           "map_m")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("val")
    write_dataset(root)
    jset = jdata.build_dataset(["P1", "P2"], "axial", ["FLAIR"], "GC", 6,
                               root / "MSLesSeg-Dataset" / "train", train_size=S)
    tset = tdata.SliceDataset(
        **{k: torch.from_numpy(np.array(v)) for k, v in jset.as_dict().items()},
        meta=jset.meta, src_hw=jset.src_hw, ratio=jset.ratio)

    jmodel, _ = j_create(nc=1, scale="n")
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, S, S, 3)), train=False))
    v0 = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    v0 = {c: jax.tree_util.tree_map(lambda x: x, dict(v0[c])) for c in v0}
    jvars = _perturbed(v0, 7)
    for lvl in range(3):  # boxes of about the lesions' size, masks that fill them
        # scores spread over (0, 1) rather than saturated: no ties for the AP sweep
        jvars["params"][f"cls{lvl}_2"]["kernel"] = jvars["params"][f"cls{lvl}_2"]["kernel"] / 20
        box = jvars["params"][f"box{lvl}_2"]
        box["bias"] = np.tile(-0.65 * np.arange(16, dtype=np.float32), 4)
        box["kernel"] = box["kernel"] / 10
        mc = jvars["params"][f"mc{lvl}_2"]
        mc["bias"] = (mc["bias"] + 3.0).astype(np.float32)

    j_metrics, j_losses, j_acc = jval.run_validation(
        jmodel, jvars, jset, JLossConfig(imgsz=S, max_fg=8), batch_size=BATCH, imgsz=S,
        return_acc=True)
    tmodel, _ = t_create(nc=1, scale="n")
    t_metrics, t_losses, t_acc = tval.run_validation(
        tmodel, state_dict_from_reference(jvars, tmodel), tset, TLossConfig(imgsz=S, max_fg=8),
        batch_size=BATCH, imgsz=S, return_acc=True, device="cpu")
    return {"j": (j_metrics, j_losses, j_acc), "t": (t_metrics, t_losses, t_acc), "n": len(tset)}


def test_val_losses_within_2e4(runs):
    (_, jl, _), (_, tl, _) = runs["j"], runs["t"]
    assert set(tl) == set(jl) == {"box", "seg", "cls", "dfl"}
    for k in jl:
        assert jl[k] > 0
        assert abs(tl[k] - jl[k]) <= 2e-4 * abs(jl[k]), (k, tl[k], jl[k])


def test_every_results_metric_within_1e6(runs):
    (jm, _, ja), (tm, _, ta) = runs["j"], runs["t"]
    kept_j = [len(s) for s in ja.scores]
    kept_t = [len(s) for s in ta.scores]
    flipped = sum(a != b for a, b in zip(kept_j, kept_t))
    print(f"images keeping a different number of detections: {flipped} of {len(kept_j)}; "
          f"kept {sum(kept_t)} (port) vs {sum(kept_j)} (JAX)")
    assert len(kept_t) == len(kept_j) == runs["n"]  # the padded slots are not counted
    assert sum(kept_j) > 0 and ta.n_gt == ja.n_gt > 0
    for k in METRICS:
        assert tm[k] == pytest.approx(jm[k], abs=1e-6), (k, tm[k], jm[k])
    assert jm["map50_b"] > 0 and jm["map50_m"] > 0  # boxes and masks matched lesions
    if not flipped:  # the same detections: the same scores and match bits
        for name in ("tp_box", "tp_mask"):
            np.testing.assert_array_equal(np.concatenate(getattr(ta, name)),
                                          np.concatenate(getattr(ja, name)))
        np.testing.assert_allclose(np.concatenate(ta.scores), np.concatenate(ja.scores),
                                   rtol=0, atol=1e-6)


def test_val_aug_config_equals_jax():
    assert tuple(tval.val_aug_config(12, 96)) == tuple(jval.val_aug_config(12, 96))
