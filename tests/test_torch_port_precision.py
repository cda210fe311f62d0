"""A float32 model convolves in full float32 (ROADMAP C10).

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``); the JAX package computes exact
float32. The port scopes the flag off itself, around a float32 model's
forward (``YOLO11Seg.forward``: serving, validation, the consensus) and
around the train step's forward, loss and backward, and gives the caller's
setting back. There is no TF32 on the CPU, so these tests hold the flags
the program sets: hooks record them inside the first Conv block's forward
and inside the backward (a hook on its kernel's gradient). A bf16 model
leaves them as the caller set them; the other cuDNN flags pass through
untouched; the matrix products' TF32 flag is PyTorch's default, False.
"""

import pytest
import torch

from tpu_mslesseg_torch.model.yolo11 import create_model
from tpu_mslesseg_torch.tools.train_batches import synthetic_batch
from tpu_mslesseg_torch.train import trainer
from torch_threads import one_torch_thread  # noqa: F401

cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul


def _flags():
    return {"allow_tf32": cudnn.allow_tf32, "matmul_allow_tf32": matmul.allow_tf32,
            "enabled": cudnn.enabled, "benchmark": cudnn.benchmark,
            "deterministic": cudnn.deterministic}


@pytest.fixture
def caller_flags(request):
    """The caller's cuDNN flags for the test (`request.param`: TF32 on or
    off, and whether benchmark and deterministic are on), the process's
    own put back after it."""
    tf32, modes = request.param
    saved = (cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic)
    cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = tf32, modes, modes
    yield _flags()
    cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = saved


def _recorder(model):
    seen = {"forward": [], "backward": []}
    first = model.model[0]
    hooks = [first.register_forward_hook(lambda m, a, o: seen["forward"].append(_flags())),
             first.conv.weight.register_hook(lambda g: seen["backward"].append(_flags()))]
    return seen, hooks


CASES = [(True, False), (False, False), (True, True)]


def test_matmul_tf32_is_off_by_default():
    assert matmul.allow_tf32 is False


@pytest.mark.parametrize("caller_flags", CASES, indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_train_step_scopes_tf32_by_the_models_dtype(caller_flags, dtype):
    model, _ = create_model(nc=1, scale="n", dtype=dtype)
    cfg = trainer.TrainConfig(batch_size=2, imgsz=64, max_fg=8)
    state = trainer.init_train_state(model, cfg, 4, device="cpu")
    seen, hooks = _recorder(model)
    try:
        trainer.train_step(state, synthetic_batch(0, 2, 64, 4, max_valid=2))
    finally:
        for h in hooks:
            h.remove()
    want = dict(caller_flags, allow_tf32=False) if dtype == torch.float32 else caller_flags
    assert seen == {"forward": [want], "backward": [want]}
    assert _flags() == caller_flags


@pytest.mark.parametrize("caller_flags", CASES, indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_served_forward_scopes_tf32_by_the_models_dtype(caller_flags, dtype):
    model, _ = create_model(nc=1, scale="n", dtype=dtype)
    seen, hooks = _recorder(model)
    x = torch.rand((1, 64, 64, 3))
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    want = dict(caller_flags, allow_tf32=False) if dtype == torch.float32 else caller_flags
    assert seen == {"forward": [want], "backward": []}
    assert _flags() == caller_flags
