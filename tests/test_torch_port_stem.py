"""The port's stem (``model.0``+``model.1``), its ``from_p2`` entry and its
switch vs the JAX package's ``stem_pallas``.

The stem's BN statistics are perturbed away from init, as
``tests/test_stem_pallas.py`` does: with init statistics silu(bn(0)) == 0,
so a P1 position outside the map computed as BN+SiLU of zero input instead
of b1's zero padding would be invisible.

Tolerances: float32 atol and rtol 2e-5 (sums in another order); bfloat16
one bf16 ulp of the larger of the value and 1.0 (2**-7 below 1). The port
rounds each conv sum to bf16 before BN, as its chain does, while JAX's
Pallas kernel feeds the f32 sum to BN; and a one-ulp difference in a conv
sum near the BN mean lands on an output near 0, so a bound relative to the
output alone would not hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.model import stem_pallas as jsp
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.model.yolo11 import fold_gray_stem as j_fold
from tpu_mslesseg_torch.infer import predictor as tpred
from tpu_mslesseg_torch.model import stem as tst
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.model.yolo11 import fold_gray_stem as t_fold
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _variables(scale):
    """JAX variables (numpy leaves) with the stem's BN stats perturbed."""
    model, _ = j_create(nc=1, scale=scale)
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=False))
    v = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    v = {c: jax.tree_util.tree_map(lambda x: x, dict(v[c])) for c in v}
    rng = np.random.default_rng(5)
    for blk in ("b0", "b1"):
        st = v["batch_stats"][blk]["bn"]
        pp = v["params"][blk]["bn"]
        st["mean"] = rng.normal(0.3, 0.2, st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
        pp["bias"] = rng.normal(0.1, 0.3, pp["bias"].shape).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def variables():
    return _variables("n")


def _served(variables, tdtype, scale="n"):
    """The port's model and its served state_dict (stem folded)."""
    tmodel, _ = t_create(nc=1, scale=scale, dtype=tdtype)
    return tmodel, t_fold(state_dict_from_reference(variables, tmodel))


def _bf16_ulp_bound(want):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1.0))) - 7)


@pytest.mark.parametrize(
    "dtype,imgsz", [("float32", 64), ("float32", 256), ("bfloat16", 64)]
)
def test_stem_matches_jax_reference_and_pallas_kernel(variables, dtype, imgsz):
    jdt, tdt = DTYPES[dtype]
    jmodel, _ = j_create(nc=1, scale="n", dtype=jdt)
    folded = j_fold(variables)
    x = np.random.default_rng(7).uniform(0, 1, (3, imgsz, imgsz)).astype(np.float32)
    ref = jsp.stem_reference(jmodel, folded, jnp.asarray(x))
    kern = jsp.stem_apply(
        jsp.build_stem_weights(folded, dtype=jdt),
        jsp.stem_s2d(jnp.asarray(x).astype(jdt)), interpret=True,
    )
    tmodel, sd = _served(variables, tdt)
    got = tst.stem_apply(tmodel, tst.stem_weights(sd), torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (3, 32, imgsz // 4, imgsz // 4)
    got = got.float().permute(0, 2, 3, 1).numpy()  # NHWC, as JAX's
    for want in (ref, kern):
        want = np.asarray(want.astype(jnp.float32))
        assert want.shape == got.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp_bound(want))


@pytest.mark.parametrize("scale,c0,c1", [("s", 32, 64), ("m", 64, 128), ("x", 96, 192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wider_stems_match_the_pallas_kernel(scale, c0, c1, dtype):
    """The plain version that the wider kernel instances are held against on
    the card, against JAX's kernel (interpreted) and its plain stem, at the
    channel counts of scales s, m (and l) and x."""
    jdt, tdt = DTYPES[dtype]
    v = _variables(scale)
    jmodel, _ = j_create(nc=1, scale=scale, dtype=jdt)
    folded = j_fold(v)
    x = np.random.default_rng(11).uniform(0, 1, (2, 64, 64)).astype(np.float32)
    ref = jsp.stem_reference(jmodel, folded, jnp.asarray(x))
    kern = jsp.stem_apply(
        jsp.build_stem_weights(folded, dtype=jdt),
        jsp.stem_s2d(jnp.asarray(x).astype(jdt)), interpret=True,
    )
    tmodel, sd = _served(v, tdt, scale)
    w = tst.stem_weights(sd)
    assert tst.instance_of(w) == (c0, c1)
    got = tst.stem_apply(tmodel, w, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == (2, c1, 16, 16)
    got = got.float().permute(0, 2, 3, 1).numpy()
    for want in (ref, kern):
        want = np.asarray(want.astype(jnp.float32))
        assert want.shape == got.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp_bound(want))


def test_every_published_scale_has_a_kernel_instance():
    for scale in "nsmlx":
        tmodel, _ = t_create(nc=1, scale=scale)
        shapes = {k: v for k, v in tmodel.state_dict().items()
                  if k in ("model.0.conv.weight", "model.1.conv.weight")}
        shapes["model.0.conv.weight"] = shapes["model.0.conv.weight"][:, :1]  # folded
        assert scale in tst.INSTANCES[tst.instance_of(shapes)]


def test_a_stem_without_a_kernel_instance_fails_the_predictor_at_construction(
        variables, monkeypatch):
    """With the switch on, a served stem whose shapes no kernel instance
    takes raises when the predictor is built, before any patient, and the
    stages' queue calls it a kernel failure (raised, not skipped)."""
    from tpu_mslesseg_torch.core.device import SinInstanciaDeKernel, es_fallo_de_dispositivo

    tmodel, sd = _served(variables, torch.float32)
    narrow = dict(sd)  # a stem of 8 and 32 channels: no scale has it
    for leaf in ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
        narrow[f"model.0.{leaf}"] = sd[f"model.0.{leaf}"][:8]
    narrow["model.1.conv.weight"] = sd["model.1.conv.weight"][:, :8]
    monkeypatch.setattr(tst, "ENABLED", True)
    monkeypatch.setenv("TPU_MSLESSEG_SCALE", "n")
    with pytest.raises(RuntimeError, match="no kernel instance.*TPU_MSLESSEG_SCALE=n") as err:
        tst.maybe_build(narrow, "cuda", 640)
    # told by its class, whatever the message says
    assert isinstance(err.value, SinInstanciaDeKernel)
    assert es_fallo_de_dispositivo(err.value)
    assert es_fallo_de_dispositivo(SinInstanciaDeKernel("reworded"))
    assert not es_fallo_de_dispositivo(RuntimeError("no kernel instance"))
    with pytest.raises(RuntimeError, match="no kernel instance"):
        tst.maybe_build({"axial": sd, "coronal": narrow}, "cuda", 640)
    assert tst.maybe_build(narrow, "cpu", 640) is None  # the plain chain serves any shape
    # the predictors build their stem through this gate: as if on a card
    real = tst.maybe_build
    monkeypatch.setattr(tst, "maybe_build", lambda v, device, imgsz: real(v, "cuda", imgsz))
    with pytest.raises(RuntimeError, match="no kernel instance"):
        tpred.SlicePredictor(tmodel, narrow, (28, 24), imgsz=64, device="cpu")
    assert tpred.SlicePredictor(tmodel, sd, (28, 24), imgsz=64, device="cpu")._stem_w is not None


def test_from_p2_equals_the_full_forward(variables):
    tmodel, sd = _served(variables, torch.float32)
    x = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (2, 64, 64)).astype(np.float32))
    with torch.no_grad():
        p2 = tst.stem_apply(tmodel, tst.stem_weights(sd), x)
        via_p2 = torch.func.functional_call(tmodel, sd, (p2,), {"from_p2": True})
        full = torch.func.functional_call(tmodel, sd, (x[..., None],))
    torch.testing.assert_close(via_p2["proto"], full["proto"], atol=1e-4, rtol=1e-4)
    for key in ("box", "cls", "mcoef"):
        for a, b in zip(via_p2[key], full[key]):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_maybe_build_gates_like_the_reference(variables, monkeypatch):
    _, sd = _served(variables, torch.float32)
    monkeypatch.setattr(tst, "ENABLED", False)
    assert tst.maybe_build(sd, "cuda", 640) is None
    monkeypatch.setattr(tst, "ENABLED", True)
    assert tst.maybe_build(sd, "cpu", 640) is None
    assert tst.maybe_build(sd, "cuda", 642) is None
    w = tst.maybe_build(sd, "cuda", 640)
    assert set(w) == {k for k in sd if k.startswith(("model.0.", "model.1."))
                      and not k.endswith("num_batches_tracked")}
    per_plane = tst.maybe_build({"axial": sd, "coronal": sd}, "cuda", 640)
    assert set(per_plane) == {"axial", "coronal"}


def test_predictor_with_the_switch_on_cpu_runs_the_plain_chain(variables, monkeypatch):
    tmodel, sd = _served(variables, torch.float32)
    slices = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (2, 28, 24), dtype=np.uint8)
    )
    monkeypatch.setattr(tst, "ENABLED", True)
    on = tpred.SlicePredictor(tmodel, sd, (28, 24), imgsz=64, device="cpu")
    assert on._stem_w is None
    launches = tst.LAUNCHES
    got = on(slices)
    monkeypatch.setattr(tst, "ENABLED", False)
    want = tpred.SlicePredictor(tmodel, sd, (28, 24), imgsz=64, device="cpu")(slices)
    assert tst.LAUNCHES == launches
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_stem_refuses_devices_without_a_kernel(variables):
    tmodel, sd = _served(variables, torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        tst.stem_apply(tmodel, tst.stem_weights(sd), torch.zeros((1, 8, 8), device="meta"))
