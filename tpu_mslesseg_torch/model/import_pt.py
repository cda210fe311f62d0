"""Warm start from an ultralytics ``yolo11*-seg.pt``.

Port of ``tpu_mslesseg/model/import_pt.py``. The reference fine-tunes from
COCO-pretrained ``yolo11n-seg.pt`` (``args.yaml: pretrained: true``). The
file pickles an ultralytics module graph that ``torch.load(weights_only=
True)`` cannot read, so it is parsed by the port's own reader
(``io/torch_pt.py``, no code from the file runs). The port's state_dict keys
are ultralytics' own, so the load is ultralytics' ``intersect_dicts``: each
parameter and BatchNorm statistic whose key and shape match is taken, every
other one keeps its initial value (the class head's last convolutions when
going from COCO's 80 classes to 1). ``num_batches_tracked`` is not taken
(the BatchNorm momentum is fixed) and ``model.23.dfl.conv.weight`` has no
counterpart: the DFL expectation is a fixed arange in the decode and loss.
"""

from __future__ import annotations

import numpy as np
import torch


def map_state_dict(ours: dict, theirs: dict):
    """`theirs` ({key: ndarray}) onto `ours` (a state_dict) by key and
    shape -> (new state_dict, report): ``transferred`` (their keys taken),
    ``mismatched`` (present with another shape, or absent), ``unused_theirs``
    and ``total_ours``."""
    new, transferred, mismatched, used = {}, [], [], set()
    for key, ref in ours.items():
        new[key] = ref
        if key.endswith("num_batches_tracked"):
            continue
        w = theirs.get(key)
        if w is None:
            mismatched.append(f"{key} (absent)")
            continue
        if tuple(w.shape) != tuple(ref.shape):
            mismatched.append(f"{key} {tuple(w.shape)} != {tuple(ref.shape)}")
            continue
        new[key] = torch.from_numpy(np.ascontiguousarray(w)).to(ref.dtype)
        transferred.append(key)
        used.add(key)
    report = {
        "transferred": transferred,
        "mismatched": mismatched,
        "unused_theirs": sorted(k for k in theirs if k not in used),
        "total_ours": sum(not k.endswith("num_batches_tracked") for k in ours),
    }
    return new, report


def load_pretrained(path, variables: dict):
    """`variables` (a state_dict) warm-started from the ultralytics ``.pt``
    at `path` -> (new state_dict, report). Raises when nothing matches (the
    wrong architecture or scale)."""
    from tpu_mslesseg_torch.io.torch_pt import load_ultralytics_checkpoint

    theirs, train_args = load_ultralytics_checkpoint(path)
    new, report = map_state_dict(variables, theirs)
    report["train_args"] = train_args
    if not report["transferred"]:
        raise ValueError(
            f"{path}: no parameter matched the model (mismatched: {len(report['mismatched'])})")
    return new, report
