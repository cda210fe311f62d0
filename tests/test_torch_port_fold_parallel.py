"""The port's fold-parallel pieces (``train/fold_parallel.py``) against the
JAX package's.

* ``plan_fold_mesh`` and ``build_fold_index_pools`` are arithmetic: equal to
  the reference's on its own cases (``tests/test_fold_parallel.py``) and on
  more (padding, a fold with no rows).
* One fold-parallel micro-step: the reference's ``make_multi_fold_step``
  (``mesh=None``: ``lax.map`` over 2 folds) from its seeded per-fold
  states, and the port's ``fold_step`` for each fold from the same weights
  (bridged) with the reference's draws injected (the pool rows from its
  ``randint``, the augmentation's parameters from its keys). Float32 on the
  CPU at imgsz 64, batch 2, ``max_fg`` 8, ``warmup_bias_lr`` 0. Each fold's
  batch is the one the reference's ``one_fold`` builds (images within 1e-5,
  boxes within 1e-4 pixels, the instance maps and ``valid`` equal: the
  augmentation's own tolerances); every loss part within rtol 1e-3 (the
  tolerance of ``tests/test_torch_port_train_step.py``, what the two
  frameworks' train steps on one batch hold to: 4.4e-4 at most on these
  batches, fed either fold's exact JAX batch), the BatchNorm running
  statistics after it within 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.pipeline.paciente import calcular_fold as j_calcular_fold
from tpu_mslesseg.train import augment as jaug
from tpu_mslesseg.train import fold_parallel as jfp
from tpu_mslesseg.train.trainer import TrainConfig as JConfig
from tpu_mslesseg_torch.model import bridge
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.pipeline.paciente import calcular_fold
from tpu_mslesseg_torch.train import augment as taug
from tpu_mslesseg_torch.train import fold_parallel as tfp
from tpu_mslesseg_torch.train.trainer import TrainConfig as TConfig
from torch_threads import one_torch_thread  # noqa: F401


PLAN_CASES = [(8, 5), (8, 4), (4, 5), (2, 5), (1, 5), (8, 8), (16, 5), (1, 1), (3, 2), (6, 4),
              (12, 5), (2, 2), (4, 2)]


@pytest.mark.parametrize("n_devices,k_folds", PLAN_CASES)
def test_plan_fold_mesh_equals_jax(n_devices, k_folds):
    assert tfp.plan_fold_mesh(n_devices, k_folds) == jfp.plan_fold_mesh(n_devices, k_folds)


def test_plan_fold_mesh_keeps_every_device_busy():
    """The reference's own table: the smallest covering divisor."""
    assert [tfp.plan_fold_mesh(n, k) for n, k in
            [(8, 5), (8, 4), (4, 5), (2, 5), (1, 5), (8, 8), (16, 5)]] == \
        [(8, 8), (4, 4), (4, 8), (2, 6), (1, 5), (8, 8), (8, 8)]


def _meta(k_folds, m=12):
    """`m` rows of `k_folds` patients, one in each fold, in turns."""
    pids = [next(f"P{n}" for n in range(1, 60) if calcular_fold(f"P{n}", k_folds) == f)
            for f in range(1, k_folds + 1)]
    return [(pids[i % k_folds], "FLAIR", i) for i in range(m)]


@pytest.mark.parametrize("k_folds,k_pad", [(4, None), (4, 8), (2, None), (2, 4), (5, 8), (3, 3)])
def test_build_fold_index_pools_equals_jax(k_folds, k_pad):
    meta = _meta(k_folds, m=12 + k_folds)
    tp, tc = tfp.build_fold_index_pools(meta, k_folds, calcular_fold, k_pad=k_pad)
    jp, jc = jfp.build_fold_index_pools(meta, k_folds, j_calcular_fold, k_pad=k_pad)
    assert tp.dtype == tc.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for f in range(k_folds):  # a fold never trains on its own patients
        own = {i for i, (pid, _, _) in enumerate(meta) if calcular_fold(pid, k_folds) == f + 1}
        rows = set(tp[f, : int(tc[f])].tolist())
        assert rows and rows.isdisjoint(own)


def test_a_fold_without_training_rows_raises_as_jax():
    meta = [("P1", "FLAIR", i) for i in range(4)]  # one patient: fold 1 of 2 holds them all
    k = calcular_fold("P1", 2)
    assert k == j_calcular_fold("P1", 2)
    with pytest.raises(ValueError, match=f"Fold {k} sin cortes"):
        tfp.build_fold_index_pools(meta, 2, calcular_fold)
    with pytest.raises(ValueError, match=f"Fold {k} sin cortes"):
        jfp.build_fold_index_pools(meta, 2, j_calcular_fold)


# ---------------------------------------------------------------------------
# one micro-step of every fold, against make_multi_fold_step
# ---------------------------------------------------------------------------

S, B, K, SPE, MAX_INST = 64, 2, 2, 2, 4
OPTS = dict(epochs=1, batch_size=B, imgsz=S, max_fg=8, warmup_bias_lr=0.0)


def _pool():
    rng = np.random.default_rng(7)
    m, h, w = 12, 48, 40
    images = rng.integers(0, 255, (m, h, w)).astype(np.uint8)
    inst = np.zeros((m, h, w), np.uint8)
    boxes = np.zeros((m, MAX_INST, 4), np.float32)
    valid = np.zeros((m, MAX_INST), bool)
    for i in range(m):
        y, x = rng.integers(4, 20), rng.integers(4, 16)
        hh, ww = rng.integers(8, 20), rng.integers(8, 20)
        inst[i, y:y + hh, x:x + ww] = 1
        images[i, y:y + hh, x:x + ww] = 230
        boxes[i, 0] = (x, y, x + ww, y + hh)
        valid[i, 0] = True
    return {"images": images, "instmaps": inst, "boxes": boxes, "valid": valid}, _meta(K)


@pytest.fixture(scope="module")
def steps():
    data, meta = _pool()
    acfg = jaug.AugConfig(imgsz=S, max_inst=MAX_INST, mosaic=True)
    jmodel, _ = j_create(nc=1, scale="n", dtype=jnp.float32, remat=False)
    jcfg = JConfig(remat=False, **OPTS)
    pools, counts = jfp.build_fold_index_pools(meta, K, j_calcular_fold)
    state0 = jfp.init_multi_fold_state(jmodel, jcfg, SPE, K)
    keys = jax.random.split(jax.random.PRNGKey(5), K)
    step = jfp.make_multi_fold_step(jmodel, jcfg, SPE, acfg, mesh=None)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    state1, metrics = step(state0, keys, pools, counts, jd)
    metrics = jax.tree_util.tree_map(np.asarray, metrics)

    t_pools, t_counts = tfp.build_fold_index_pools(meta, K, calcular_fold)
    td = {k: torch.from_numpy(v) for k, v in data.items()}
    port = []
    for f in range(K):
        # the reference's draws for this fold: rows from k_idx, parameters from k_aug
        k_idx, k_aug = jax.random.split(keys[f])
        draws = np.array(jax.random.randint(k_idx, (B, 4), 0, counts[f]))
        p = jax.vmap(lambda k: jaug._draw_params(k, acfg))(jax.random.split(k_aug, B))
        params = taug.AugParams(**{n: torch.from_numpy(np.array(getattr(p, n)))
                                   for n in jaug._AugParams._fields})
        variables = jax.tree_util.tree_map(
            lambda x, f=f: np.asarray(x[f]),
            {"params": state0.params, "batch_stats": state0.batch_stats})
        tmodel, _ = t_create(nc=1, scale="n")
        sd = bridge.state_dict_from_reference(variables, tmodel)
        from tpu_mslesseg_torch.train import trainer as ttr

        state = ttr.init_train_state(tmodel, TConfig(**OPTS, amp=False), SPE, variables=sd,
                                     device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfp, "draw_rows", lambda gen, count, batch, d=draws: torch.from_numpy(d))
            mp.setattr(taug, "draw_params", lambda gen, cfg, batch, p=params: p)
            tbatch = tfp.fold_batch(state, t_pools[f], t_counts[f], td, taug.AugConfig(*acfg), B)
            m = tfp.fold_step(state, t_pools[f], t_counts[f], td, taug.AugConfig(*acfg))
        jbatch = jax.tree_util.tree_map(np.asarray, jaug.make_batch(
            k_aug, jd, pools[f][jnp.asarray(draws)], acfg))
        after = bridge.state_dict_from_reference(jax.tree_util.tree_map(
            lambda x, f=f: np.asarray(x[f]),
            {"params": state1.params, "batch_stats": state1.batch_stats}), tmodel)
        port.append((m, state, after, tbatch, jbatch))
    return metrics, port, np.asarray(state1.step)


def test_each_folds_batch_is_the_references_one_fold_batch(steps):
    _, port, _ = steps
    for _, _, _, got, want in port:
        np.testing.assert_allclose(got["images"].numpy(), want["images"], rtol=0, atol=1e-5)
        for k in ("instmap", "instmap_proto", "valid"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-4)
        assert want["valid"].any()


@pytest.mark.parametrize("part", ["loss", "box", "seg", "cls", "dfl"])
def test_one_micro_step_of_each_fold_equals_make_multi_fold_step(steps, part):
    metrics, port, _ = steps
    for f, (m, *_) in enumerate(port):
        got, want = float(m[part]), float(metrics[part][f])
        assert np.isfinite(want) and want > 0
        np.testing.assert_allclose(got, want, rtol=1e-3, err_msg=f"fold {f}, {part}")
    # the folds drew different batches from different weights
    assert float(metrics[part][0]) != float(metrics[part][1])


def test_one_micro_step_moves_batch_statistics_as_jax(steps):
    _, port, jsteps = steps
    assert jsteps.tolist() == [1] * K
    for state, want in ((s, a) for _, s, a, *_ in port):
        assert state.step == 1 and state.applies == 1
        got = state.model.state_dict()
        names = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert len(names) > 100
        for k in names:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=2e-4)


def test_fold_states_are_seeded_apart():
    """Fold f's weights and generator are seeded ``seed + f``, as the
    reference's ``init_multi_fold_state``; every fold warm-starts alike."""
    model, _ = t_create(nc=1, scale="n")
    cfg = TConfig(**OPTS, amp=False)
    states = tfp.init_multi_fold_state(model, cfg, SPE, [0, 1], device="cpu")
    w = [st.model.state_dict()["model.0.conv.weight"] for st in states.values()]
    assert not torch.equal(w[0], w[1])
    again = tfp.init_fold_state(model, cfg, SPE, 1, device="cpu")
    assert torch.equal(again.model.state_dict()["model.0.conv.weight"], w[1])
    draws = [tfp.draw_rows(st.gen, 10, 8) for st in states.values()]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(tfp.draw_rows(again.gen, 10, 8), draws[1])
    assert all(int(d.min()) >= 0 and int(d.max()) < 10 for d in draws)
    assert states[0].model is not model and states[0].model is not states[1].model
