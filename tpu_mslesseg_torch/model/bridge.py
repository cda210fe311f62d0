"""Reference (flax) variables <-> this package's ``state_dict``.

The reference keeps its weights as ``{"params", "batch_stats"}`` trees of
arrays. This module turns such a tree, given as numpy arrays (or anything
``np.asarray`` takes), into a state_dict for `YOLO11Seg`
(`state_dict_from_reference`), a tree shaped like the reference's
parameters, such as its gradients, into tensors under state_dict keys
(`tensors_from_reference`), and a state_dict back into reference-shaped
numpy trees (`reference_from_state_dict`), so that parameters, EMA and
BatchNorm statistics can be compared leaf by leaf after training steps. It
is the inverse of the reference's ultralytics importer
(``tpu_mslesseg/model/import_pt.py`` ``torch_key`` and ``_transform``),
whose name map it copies:

* flax kernel ``(kh, kw, I/g, O)`` -> Conv2d weight ``(O, I/g, kh, kw)``;
* flax ConvTranspose kernel ``(kh, kw, I, O)`` -> transpose to
  ``(I, O, kh, kw)``, then a spatial flip (flax does not mirror the kernel);
* BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``; ``num_batches_tracked`` is set to 0.

Every parameter and buffer of the model is set, and nothing is left over:
anything else raises.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

# reference top-level module name -> ultralytics prefix under the Sequential
_TOP = {
    **{f"b{i}": f"model.{i}" for i in range(11)},
    **{f"h{i}": f"model.{i}" for i in (13, 16, 17, 19, 20, 22)},
    "proto": "model.23.proto",
}
_HEAD_BRANCH = {"box": "cv2", "mc": "cv4"}
_CLS_SUFFIX = {"0dw": "0.0", "0pw": "0.1", "1dw": "1.0", "1pw": "1.1", "2": "2"}
_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",  # bn
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _top_prefix(name: str) -> str:
    if name in _TOP:
        return _TOP[name]
    m = re.fullmatch(r"(box|mc)(\d)_(\d)", name)
    if m:
        return f"model.23.{_HEAD_BRANCH[m.group(1)]}.{m.group(2)}.{m.group(3)}"
    m = re.fullmatch(r"cls(\d)_(\w+)", name)
    if m:
        return f"model.23.cv3.{m.group(1)}.{_CLS_SUFFIX[m.group(2)]}"
    raise KeyError(f"no torch mapping for top-level module {name!r}")


def _inner(component: str) -> str | None:
    """Torch name of one intermediate path component (None = drop)."""
    if component == "Conv_0":  # the reference's DWConv wraps Conv
        return None
    m = re.fullmatch(r"m(\d+)", component)
    if m:
        return f"m.{m.group(1)}"
    return {"ffn1": "ffn.0", "ffn2": "ffn.1"}.get(component, component)


def torch_key(collection: str, path: tuple[str, ...]) -> str:
    """state_dict key for one leaf of the reference's variables tree."""
    parts = [_top_prefix(path[0])]
    for comp in path[1:-1]:
        t = _inner(comp)
        if t is not None:
            parts.append(t)
    leaf = _LEAF.get((collection, path[-1]))
    if leaf is None:
        raise KeyError(f"unmapped leaf {collection}/{'/'.join(path)}")
    return ".".join(parts + [leaf])


def _to_torch_layout(path: tuple[str, ...], w: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return w
    if w.ndim != 4:
        raise ValueError(f"{path}: kernel with ndim {w.ndim}")
    if "upsample" in path:  # ConvTranspose2d weight is (I, O, kh, kw)
        return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _to_reference_layout(path: tuple[str, ...], w: np.ndarray) -> np.ndarray:
    """The inverse of `_to_torch_layout`."""
    if path[-1] != "kernel":
        return w
    if "upsample" in path:
        return np.ascontiguousarray(w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _leaves(tree, path=()):
    for name, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, path + (name,))
        else:
            yield path + (name,), node


def tensors_from_reference(tree, collection: str = "params") -> dict[str, torch.Tensor]:
    """A tree shaped like the reference's `collection` (its parameters, their
    gradients, an EMA) -> float32 CPU tensors under state_dict keys, in this
    package's layouts."""
    out = {}
    for path, leaf in _leaves(tree):
        w = _to_torch_layout(path, np.asarray(leaf, dtype=np.float32))
        out[torch_key(collection, path)] = torch.from_numpy(w.copy())
    return out


def reference_from_state_dict(sd, template) -> dict:
    """`sd` (a state_dict, or any subset of one such as an EMA of the
    parameters) -> numpy trees shaped like `template`, the reference's
    ``{"params": ..., "batch_stats": ...}`` (leaf values unused; a collection
    none of whose keys `sd` holds is left out). Raises ``KeyError`` when `sd`
    holds some but not all leaves of a collection."""
    def build(col, tree, path=()):
        return {
            name: build(col, node, path + (name,)) if isinstance(node, Mapping)
            else _to_reference_layout(
                path + (name,),
                sd[torch_key(col, path + (name,))].detach().to("cpu", torch.float32).numpy())
            for name, node in tree.items()
        }

    out = {}
    for col in ("params", "batch_stats"):
        if col in template and any(
            torch_key(col, path) in sd for path, _ in _leaves(template[col])
        ):
            out[col] = build(col, template[col])
    return out


def state_dict_from_reference(variables, model) -> dict[str, torch.Tensor]:
    """The reference's ``{"params", "batch_stats"}`` -> `model`'s state_dict
    (float32 CPU tensors). Raises unless the keys and shapes match the
    model's exactly."""
    sd = {}
    for col in ("params", "batch_stats"):
        sd.update(tensors_from_reference(variables[col], col))
    expected = model.state_dict()
    for key in expected:
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.long)
    missing = sorted(set(expected) - set(sd))
    extra = sorted(set(sd) - set(expected))
    if missing or extra:
        raise ValueError(f"bridge mismatch: missing {missing}, extra {extra}")
    bad = [
        f"{k} {tuple(sd[k].shape)} != {tuple(v.shape)}"
        for k, v in expected.items() if sd[k].shape != v.shape
    ]
    if bad:
        raise ValueError(f"bridge shape mismatch: {bad}")
    return sd
