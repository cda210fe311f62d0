"""3D volume reconstruction and multi-plane consensus.

Port of ``tpu_mslesseg/infer/reconstruct.py``: a scatter of the predicted
slice batch into a volume, and a thresholded sum of the three plane
volumes.
"""

from __future__ import annotations

import torch

from tpu_mslesseg_torch.core import geometry


def reconstruct_volume(vol_shape, mask_slices, plane: str, indices,
                       dtype=torch.float32):
    """Predicted binary slices [N,H,W] -> float volume of `vol_shape`
    (zeros where no slice was predicted)."""
    return geometry.insert_slices(
        vol_shape, torch.as_tensor(mask_slices).to(torch.float32), plane,
        indices, dtype=dtype,
    )


def consensus_vote(axial, coronal, sagital, umbral: int = 2):
    """Majority vote across plane volumes: >= umbral of the 3 planes agree
    (reference `combinar_volumenes`). Returns a uint8 volume."""
    total = (
        (axial > 0).to(torch.int32)
        + (coronal > 0).to(torch.int32)
        + (sagital > 0).to(torch.int32)
    )
    return (total >= umbral).to(torch.uint8)


def reconstruccion_valida(pred_shape, gt_shape) -> bool:
    """Shape-consistency validation (reference ``utils.py:183-194``)."""
    return tuple(pred_shape) == tuple(gt_shape)
