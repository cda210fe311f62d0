"""The port's training losses against the reference's.

Float32 on the CPU, inputs from a seed with numpy. Every loss part agrees at
rtol 1e-5 (sums of a few thousand float32 terms in another order), and the
gradients of the total with respect to the model's output tensors at rtol
1e-4 with atol 1e-6 (one more pass of such sums). The gradients with respect
to the model's parameters are held in ``test_torch_port_train_step.py``,
where the two models run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.train import losses as jls
from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.train import losses as tls

IMGSZ = 160
PARTS = ("box", "seg", "cls", "dfl")


def _loss_case(rng, B=2, M=6, nm=8, reg_max=16, near=True):
    """Random model outputs and ground truths in both sides' layouts. With
    `near`, each ground truth's box distribution peaks near it at the anchors
    inside it, so that the box and DFL parts are well above zero."""
    mh = IMGSZ // 4
    levels = [(IMGSZ // s, IMGSZ // s) for s in dec.STRIDES]
    out = {
        "box": [rng.normal(0, 2, (B, h, w, 4 * reg_max)).astype(np.float32) for h, w in levels],
        "cls": [rng.normal(-3, 1.5, (B, h, w, 1)).astype(np.float32) for h, w in levels],
        "mcoef": [rng.normal(0, 1, (B, h, w, nm)).astype(np.float32) for h, w in levels],
        "proto": rng.normal(0, 1, (B, mh, mh, nm)).astype(np.float32),
    }
    boxes = np.zeros((B, M, 4), np.float32)
    valid = np.zeros((B, M), bool)
    instmap = np.zeros((B, mh, mh), np.uint8)
    ys, xs = np.arange(mh)[:, None], np.arange(mh)[None, :]
    for b in range(B):
        for m in range(rng.integers(2, M + 1)):
            w, h = rng.uniform(3, 14 if rng.random() < 0.4 else 80, 2)
            cx, cy = rng.uniform(w / 2, IMGSZ - w / 2), rng.uniform(h / 2, IMGSZ - h / 2)
            boxes[b, m] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            valid[b, m] = True
            x1, y1, x2, y2 = boxes[b, m] / 4
            instmap[b][(xs >= x1) & (xs < x2) & (ys >= y1) & (ys < y2)] = m + 1
            if not near:
                continue
            for (lh, lw), s, lvl in zip(levels, dec.STRIDES, out["box"]):
                ay, ax = (np.mgrid[0:lh, 0:lw] + 0.5) * s
                inside = (ax > boxes[b, m, 0]) & (ax < boxes[b, m, 2]) & \
                    (ay > boxes[b, m, 1]) & (ay < boxes[b, m, 3])
                ltrb = np.stack([ax - boxes[b, m, 0], ay - boxes[b, m, 1],
                                 boxes[b, m, 2] - ax, boxes[b, m, 3] - ay], -1) / s
                bins = np.clip(np.round(ltrb), 0, reg_max - 1).astype(int)  # [lh, lw, 4]
                peak = np.zeros((lh, lw, 4, reg_max), np.float32)
                np.put_along_axis(peak, bins[..., None], 6.0, axis=-1)
                lvl[b][inside] += peak.reshape(lh, lw, 4 * reg_max)[inside]
    return out, boxes, np.zeros((B, M), np.int32), valid, instmap


def _torch_loss(case, max_fg, grads=False):
    out, boxes, labels, valid, instmap = case
    t = {k: [torch.from_numpy(x).requires_grad_(grads) for x in v] if isinstance(v, list)
         else torch.from_numpy(v).requires_grad_(grads) for k, v in out.items()}
    total, parts = tls.segmentation_loss(
        t, torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(valid),
        torch.from_numpy(instmap), tls.LossConfig(imgsz=IMGSZ, max_fg=max_fg))
    if grads:
        total.backward()
    return total, parts, t


def _jax_loss(case, max_fg, grads=False):
    out, boxes, labels, valid, instmap = case
    cfg = jls.LossConfig(imgsz=IMGSZ, max_fg=max_fg)
    fn = lambda o: jls.segmentation_loss(
        o, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(instmap), cfg)
    o = jax.tree_util.tree_map(jnp.asarray, out)
    if grads:
        (total, parts), g = jax.value_and_grad(fn, has_aux=True)(o)
        return total, parts, g
    return (*fn(o), None)


def test_df_loss_matches_reference():
    rng = np.random.default_rng(1)
    pred = rng.normal(0, 3, (64, 50, 4, 16)).astype(np.float32)
    tgt = np.clip(rng.uniform(-1, 17, (64, 50, 4)), 0, 15 - 0.01).astype(np.float32)
    got = tls.df_loss(torch.from_numpy(pred), torch.from_numpy(tgt))
    want = jls.df_loss(jnp.asarray(pred), jnp.asarray(tgt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    # bf16 logits are promoted, not cast down: the loss comes out in float32
    got16 = tls.df_loss(torch.from_numpy(pred).bfloat16(), torch.from_numpy(tgt))
    want16 = jls.df_loss(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(tgt))
    assert got16.dtype == torch.float32 and want16.dtype == jnp.float32
    np.testing.assert_allclose(got16.numpy(), np.asarray(want16), rtol=1e-5, atol=1e-6)


def test_bce_logits_matches_reference():
    rng = np.random.default_rng(2)
    logits = (rng.normal(0, 4, (8, 525, 1)) * rng.choice([1, 10], (8, 525, 1))).astype(np.float32)
    targets = rng.uniform(0, 1, logits.shape).astype(np.float32) * (rng.random(logits.shape) < 0.1)
    got = tls.bce_logits(torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets))
    want = jls.bce_logits(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


_BCE_IN_A_CHILD = """
import ctypes
import os
import sys
import numpy as np
import torch
from tpu_mslesseg_torch.train import losses
n = int(sys.argv[1])
torch.set_num_threads(n)
rng = np.random.default_rng(2)
logits = (rng.normal(0, 4, (8, 525, 1)) * rng.choice([1, 10], (8, 525, 1))).astype(np.float32)
targets = rng.uniform(0, 1, logits.shape).astype(np.float32) * (rng.random(logits.shape) < 0.1)
x, t = torch.from_numpy(logits).bfloat16(), torch.from_numpy(targets)
if sys.argv[2] == "cycled":
    # one_torch_thread's 1 and back, another count and back, MKL's own count and back
    for k in (1, max(n // 2, 1)):
        torch.set_num_threads(k)
        losses.bce_logits(x, t)
        torch.set_num_threads(n)
    mkl = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
    if hasattr(mkl, "mkl_set_num_threads"):
        was = mkl.mkl_get_max_threads()
        mkl.mkl_set_num_threads(ctypes.c_int(1))
        losses.bce_logits(x, t)
        mkl.mkl_set_num_threads(ctypes.c_int(was))
sys.stdout.buffer.write(losses.bce_logits(x, t).numpy().tobytes())
"""


def test_bce_logits_bits_after_thread_count_changes_match_a_fresh_process():
    """A process whose thread counts went where the port's test files take
    them (``one_torch_thread``'s 1 and back, another count and back, MKL's
    own count and back) gives a fresh process's ``bce_logits`` bits at eight
    threads (4,200 elements split three ways), and both give the reference's
    values at the parity test's tolerance. One run of the whole suite failed
    ``test_bce_logits_matches_reference`` (302 of 4,200 elements up to
    1.3e-4 off) and its cause is not found: this holds that the thread
    counts are not it. The comparison runs in two child processes: in a
    worker of the whole suite the bits differed from a fresh process's once
    in three runs, from some other state of that worker (ROADMAP C12)."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def child(mode):
        out = subprocess.run([sys.executable, "-c", _BCE_IN_A_CHILD, "8", mode],
                             capture_output=True, check=True, timeout=120, cwd=root,
                             env={**os.environ, "PYTHONPATH": root}).stdout
        return np.frombuffer(out, np.float32).reshape(8, 525, 1)

    cycled, fresh = child("cycled"), child("fresh")
    assert np.array_equal(cycled.view(np.uint32), fresh.view(np.uint32))
    rng = np.random.default_rng(2)
    logits = (rng.normal(0, 4, (8, 525, 1)) * rng.choice([1, 10], (8, 525, 1))).astype(np.float32)
    targets = rng.uniform(0, 1, logits.shape).astype(np.float32) * (rng.random(logits.shape) < 0.1)
    want = np.asarray(jls.bce_logits(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets)))
    np.testing.assert_allclose(cycled, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bce_logits_gradient_is_sigmoid_minus_label_at_every_logit(dtype):
    """At a logit of exactly 0 too, where a clamp's gradient is 1 instead of
    1/2 (the reference's autodiff gives ``-label`` there: neither is the
    derivative)."""
    logits = torch.tensor([0.0, -0.0, 1e-3, -1e-3, 2.5, -4.6, 30.0, -30.0], dtype=dtype)
    labels = torch.tensor([0.0, 1.0, 0.25, 0.0, 1.0, 0.0, 0.5, 0.75])
    x = logits.clone().requires_grad_()
    tls.bce_logits(x, labels).sum().backward()
    want = torch.sigmoid(logits.float()) - labels
    torch.testing.assert_close(x.grad.float(), want.to(dtype).float(), rtol=0, atol=1e-6)
    value = torch.nn.functional.binary_cross_entropy_with_logits(
        logits.float(), labels, reduction="none")
    torch.testing.assert_close(tls.bce_logits(logits, labels), value, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("near", [True, False], ids=["near", "random"])
@pytest.mark.parametrize("seed", range(4))
def test_segmentation_loss_parts_match_reference(seed, near):
    case = _loss_case(np.random.default_rng(50 + seed), near=near)
    total, parts, _ = _torch_loss(case, max_fg=16)
    jtotal, jparts, _ = _jax_loss(case, max_fg=16)
    for k in PARTS:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    assert int(parts["fg_count"]) == int(jparts["fg_count"]) > 0
    if near:
        assert min(float(parts[k]) for k in PARTS) > 1e-2
    # the parts are gain-scaled and the total is their sum times the batch
    assert float(total) == pytest.approx(2 * sum(float(parts[k]) for k in PARTS), rel=1e-6)


@pytest.mark.parametrize("seed", range(2))
def test_segmentation_loss_gradients_match_reference(seed):
    case = _loss_case(np.random.default_rng(70 + seed))
    _, _, t = _torch_loss(case, max_fg=16, grads=True)
    _, _, g = _jax_loss(case, max_fg=16, grads=True)
    named = {f"{k}[{i}]": (t[k][i].grad, g[k][i]) for k in ("box", "cls", "mcoef") for i in range(3)}
    named["proto"] = (t["proto"].grad, g["proto"])
    alive = 0
    for name, (got, want) in named.items():
        want = np.asarray(want)
        alive += int(np.abs(want).max() > 1e-3)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6, err_msg=name)
    assert alive >= 8  # a level without a foreground anchor has no box gradient


def test_mask_loss_chunk_size_is_a_memory_bound_not_a_cap():
    """M * 10 = 60 anchor slots in chunks of 8 (the last one padded), 16 and
    64 (one chunk): the same loss, and the reference's at each."""
    case = _loss_case(np.random.default_rng(7))
    seg = {}
    for max_fg in (8, 16, 64):
        total, parts, _ = _torch_loss(case, max_fg)
        _, jparts, _ = _jax_loss(case, max_fg)
        np.testing.assert_allclose(float(parts["seg"]), float(jparts["seg"]), rtol=1e-5)
        seg[max_fg] = float(parts["seg"])
    assert seg[8] == pytest.approx(seg[64], rel=1e-5) and seg[16] == pytest.approx(seg[64], rel=1e-5)


def test_an_image_without_ground_truth_gives_a_finite_loss():
    out, boxes, labels, valid, instmap = _loss_case(np.random.default_rng(3))
    valid[:] = False
    boxes[:] = 0
    instmap[:] = 0
    case = (out, boxes, labels, valid, instmap)
    total, parts, t = _torch_loss(case, max_fg=16, grads=True)
    jtotal, jparts, _ = _jax_loss(case, max_fg=16)
    assert int(parts["fg_count"]) == 0 and float(parts["seg"]) == 0.0
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    assert all(bool(torch.isfinite(x.grad).all()) for x in t["cls"])
