"""Canonical geometry: plane slicing, stacking, and PNG-boundary transforms.

Port of ``tpu_mslesseg/core/geometry.py``. A volume is ``vol[X, Y, Z]`` in
native NIfTI index order; slices per anatomical plane are

    axial   : vol[:, :, i]  -> (X, Y)   axis 2
    coronal : vol[:, i, :]  -> (X, Z)   axis 1
    sagital : vol[i, :, :]  -> (Y, Z)   axis 0

and ``to_png_space``/``from_png_space`` convert between volume-slice and
PNG orientation (``flipud(slice.T)`` and its inverse).
"""

from __future__ import annotations

import torch

PLANES = ("axial", "coronal", "sagital")
PLANE_AXIS = {"axial": 2, "coronal": 1, "sagital": 0}


def plane_axis(plane: str) -> int:
    try:
        return PLANE_AXIS[plane]
    except KeyError:
        raise ValueError(f"Unknown plane {plane!r}; expected one of {PLANES}")


def num_slices(shape, plane: str) -> int:
    """Total slice count of a volume along the given plane."""
    return shape[plane_axis(plane)]


def slice_shape(shape, plane: str):
    """(H, W) of a 2D slice extracted along `plane` from a volume `shape`."""
    axis = plane_axis(plane)
    return tuple(s for i, s in enumerate(shape) if i != axis)


def extract_slices(vol, plane: str, indices):
    """Gather slices -> [N, H, W] (a view of the gathered copy)."""
    axis = plane_axis(plane)
    vol = torch.as_tensor(vol)
    idx = torch.as_tensor(indices, dtype=torch.long, device=vol.device)
    return vol.index_select(axis, idx).movedim(axis, 0)


def insert_slices(vol_shape, slices, plane: str, indices, dtype=torch.float32):
    """Scatter a batch of slices [N, H, W] into a zero volume of `vol_shape`.

    Index semantics follow the reference's XLA scatter: a negative index
    counts from the end, and an index that is still out of range drops its
    slice. Callers rely on the drop: slice groups are padded with the index
    ``max(vol_shape)``. Torch indexing would raise (or trip a device
    assert) on those, so they are routed to one spare slab past the end of
    the axis, which is cut off before returning. No host sync.
    """
    axis = plane_axis(plane)
    size = vol_shape[axis]
    idx = torch.as_tensor(indices, dtype=torch.long, device=slices.device)
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    padded = list(vol_shape)
    padded[axis] += 1
    vol = torch.zeros(padded, dtype=dtype, device=slices.device)
    vol.index_copy_(axis, idx, slices.to(dtype).movedim(0, axis))
    return vol.narrow(axis, 0, size).contiguous()


def to_png_space(slice2d):
    """Volume-slice -> PNG pixel array (``plt.imsave(corte.T, origin="lower")``)."""
    return slice2d.T.flip(0)


def from_png_space(png2d):
    """PNG pixel array -> volume-slice. Inverse of `to_png_space`."""
    return png2d.flip(0).T


def to_png_space_batch(slices):
    """[N, H, W] -> [N, W, H] batch version of `to_png_space`."""
    return slices.transpose(1, 2).flip(1)


def from_png_space_batch(pngs):
    """[N, H, W] PNG-space -> [N, W, H] volume-slice space, batched."""
    return pngs.flip(1).transpose(1, 2)


def minmax_to_uint8(x):
    """Min-max normalize to [0, 255] uint8 (reference `normalizar_a_uint8`,
    ``utils/utils.py:396-406``): per-array for 2D, per-slice for [N,H,W].
    Single implementation lives in preproc.enhance.normalize_to_uint8."""
    from tpu_mslesseg_torch.preproc.enhance import normalize_to_uint8

    return normalize_to_uint8(x)
