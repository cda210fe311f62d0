"""NMS (``infer/nms.py``) against the JAX package's, on the CPU.

On a CPU tensor ``nms_batch`` suppresses through ``suppress``, which takes
the plain version ``suppress_ref``: the reference's fixpoint, run from the
host. The kernel (``csrc/nms.cu``) computes the same keep on the card and is
held against ``suppress_ref`` there by ``tests/test_torch_port_cuda.py``.
Inputs are seeded numpy arrays (``tools/nms_cases.py``): the served shape
(8,400 anchors, K = 300), deep suppression chains, score ties, k < max_det,
conf 0.001 and pairs of boxes at, one ulp above and one ulp below the IoU
threshold. Tolerance: exact equality of keep, indices, boxes and scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.infer import nms as jnms
from tpu_mslesseg_torch.infer import nms
from tpu_mslesseg_torch.tools import nms_cases


def _case(name):
    """-> (boxes, scores, conf, iou, max_det)"""
    if name == "served_shape":
        return (*nms_cases.clustered(0, 4, 8400), 0.25, 0.7, 300)
    if name.startswith("chain_"):
        return (*nms_cases.chain(int(name[6:]), 8400), 0.25, 0.7, 300)
    if name == "ties_partly_valid":
        return (*nms_cases.clustered(1, 4, 400), 0.25, 0.7, 300)
    if name == "distinct_scores":
        return (*nms_cases.clustered(2, 4, 400, ties=False), 0.25, 0.7, 300)
    if name == "k_below_max_det":
        return (*nms_cases.clustered(3, 4, 50), 0.25, 0.7, 300)
    if name == "conf_0.001":
        return (*nms_cases.clustered(4, 4, 400), 0.001, 0.7, 300)
    if name == "none_valid":
        return (*nms_cases.clustered(5, 2, 400), 0.9999, 0.7, 300)
    if name.startswith("threshold_"):
        thr = float(name[10:])
        return (*nms_cases.threshold_pairs(thr, 12, 6)[:2], 0.25, thr, 300)
    raise KeyError(name)


CASES = ("served_shape", "chain_40", "chain_250", "ties_partly_valid", "distinct_scores",
         "k_below_max_det", "conf_0.001", "none_valid", "threshold_0.7", "threshold_0.3")


@pytest.mark.parametrize("name", CASES)
def test_nms_batch_matches_jax(name):
    boxes, scores, conf, iou, max_det = _case(name)
    want = jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores), conf, iou, max_det)
    before = nms.LAUNCHES
    got = nms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), conf, iou, max_det)
    assert nms.LAUNCHES == before  # the CPU takes the plain version
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    if name == "none_valid":
        assert not keep.any()
    else:
        assert keep.any() and not keep.all()


@pytest.mark.parametrize("depth", [40, 250])
def test_a_chain_keeps_every_second_box_after_a_step_a_link(depth):
    """The chain cases are deep: the fixpoint runs about one step a link,
    and the greedy result keeps every second box of the row."""
    boxes, scores = nms_cases.chain(depth, 300)
    keep, steps = nms.suppress_ref_steps(torch.from_numpy(boxes),
                                         torch.from_numpy(scores > 0.25), 0.7)
    assert steps >= depth
    np.testing.assert_array_equal(keep[0, :depth].numpy(), np.arange(depth) % 2 == 0)


@pytest.mark.parametrize("thr", [0.7, 0.3, 0.45])
def test_threshold_pairs_sit_at_and_beside_the_threshold(thr):
    """The pairs' IoU, as ``box_iou_matrix`` rounds it, is the float32
    threshold, one ulp above or one ulp below; only those above suppress.
    At 0.3 float32 rounds the threshold up, so comparing in float64 would
    suppress the pairs at it."""
    boxes, _, ious = nms_cases.threshold_pairs(thr, 12, 6)
    iou = nms.box_iou_matrix(torch.from_numpy(boxes))[0]
    np.testing.assert_array_equal(iou[1::2, 0::2].diagonal().numpy(), ious)
    t = np.float32(thr)
    assert set(ious.tolist()) == {float(t), float(np.nextafter(t, 2)), float(np.nextafter(t, -1))}
    keep = nms.suppress_ref(torch.from_numpy(boxes), torch.ones((1, 24), dtype=torch.bool), thr)
    np.testing.assert_array_equal(keep[0, 1::2].numpy(), ious <= t)
    assert keep[0, 0::2].all()


@pytest.mark.parametrize("name", ["served_shape", "chain_250", "conf_0.001", "threshold_0.3"])
def test_suppress_ref_matches_jax_nms_single(name):
    """The plain suppression alone on the JAX package's own candidates:
    ``nms_single``'s top boxes and validity in, its keep out."""
    boxes, scores, conf, iou, max_det = _case(name)
    for n in range(boxes.shape[0]):
        jb, js, jk, _ = jnms.nms_single(jnp.asarray(boxes[n]), jnp.asarray(scores[n]), conf, iou,
                                        max_det=max_det)
        k = min(max_det, boxes.shape[1])
        top = torch.from_numpy(np.array(jb)[None, :k])
        valid = torch.from_numpy(np.asarray(js)[None, :k] > np.float32(conf))
        got = nms.suppress_ref(top, valid, iou)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jk)[:k])


def test_suppress_checks_its_inputs():
    boxes, scores = nms_cases.clustered(0, 2, 64)
    top = torch.from_numpy(boxes[:, :40])
    valid = torch.from_numpy(scores[:, :40] > 0.25)
    before = nms.LAUNCHES
    assert torch.equal(nms.suppress(top, valid, 0.7), nms.suppress_ref(top, valid, 0.7))
    assert nms.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nms.suppress(top.to("meta"), valid.to("meta"), 0.7)
    over = nms.MAX_K + 1
    with pytest.raises(ValueError, match=f"at most {nms.MAX_K}"):
        nms.suppress(torch.zeros((1, over, 4)), torch.ones((1, over), dtype=torch.bool), 0.7)
    with pytest.raises(ValueError, match=f"at most {nms.MAX_K}"):
        nms.nms_batch(torch.zeros((1, over, 4)), torch.ones((1, over)), 0.25, 0.7, over)
    with pytest.raises(TypeError):
        nms.suppress(top.double(), valid, 0.7)
    with pytest.raises(TypeError):
        nms.suppress(top, valid.float(), 0.7)
    with pytest.raises(ValueError):
        nms.suppress(top, valid[:, :30], 0.7)
    with pytest.raises(ValueError):
        nms.suppress(top[..., :3], valid, 0.7)
