"""The training dataset on the device: slices, instance maps, boxes.

Port of ``tpu_mslesseg/train/data.py``. A fold's lesion slices are
extracted on the host, enhanced on the device (CLAHE's kernels under
``--mejora CLAHE``), turned to PNG space and resized so that their longest
side is the train size; each slice's mask becomes an 8-connected instance
map (``scipy.ndimage``, on the host) with one box an instance. The arrays
then stay on the device for the augmentation and the train step.

The resize is the reference's ``jax.image.resize(..., "bilinear")``, built
as its separable weight matrices (half-pixel centres, the kernel widened by
the inverse scale when shrinking, weights renormalised at the edges) and
applied tap by tap in the float32 rounding order of the reference's
compiled CPU program: the first axis accumulates each tap into the sum with
one rounding (a fused multiply-add), the second adds the rounded products.
The sample positions ``(i + 0.5) / scale - 0.5`` are rounded once (a fused
multiply-add), as the reference's compiled CPU program rounds them. XLA
computes the weights of some matrices at compile time and rounds those
positions twice instead, so a pixel within an ulp of an integer can land
one grey level from the reference's after the truncating cast
(``tests/test_torch_port_train_data.py`` counts them).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from scipy import ndimage

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.pipeline.paciente import Paciente, calcular_fold
from tpu_mslesseg_torch.preproc import enhance

EIGHT_CONN = np.ones((3, 3), dtype=int)
RESIZE_CHUNK = 256  # slices a resize call


@dataclass
class SliceDataset:
    """One plane/enhancement configuration's slices, on the device."""

    images: torch.Tensor  # [M, H, W] uint8, PNG space, longest side = train size
    instmaps: torch.Tensor  # [M, H, W] uint8 instance ids (0 = background)
    boxes: torch.Tensor  # [M, I, 4] float32 xyxy in resized pixels
    valid: torch.Tensor  # [M, I] bool
    meta: list  # per slice (patient_id, modality, slice_index)
    src_hw: tuple  # PNG-space (H, W) before the resize
    ratio: float

    def __len__(self):
        return int(self.images.shape[0])

    @property
    def max_inst(self) -> int:
        return int(self.boxes.shape[1])

    def as_dict(self):
        return {"images": self.images, "instmaps": self.instmaps, "boxes": self.boxes,
                "valid": self.valid}

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.as_dict().values())


def label_instances(mask2d: np.ndarray, max_inst: int):
    """8-connected components -> (instance map uint8, boxes [I, 4], valid [I]).
    Components beyond `max_inst` are dropped smallest-first."""
    labeled, n = ndimage.label(mask2d > 0, structure=EIGHT_CONN)
    boxes = np.zeros((max_inst, 4), np.float32)
    valid = np.zeros((max_inst,), bool)
    out = np.zeros_like(labeled, dtype=np.uint8)
    if n == 0:
        return out, boxes, valid
    slices = ndimage.find_objects(labeled)
    areas = ndimage.sum_labels(np.ones_like(labeled), labeled, range(1, n + 1))
    order = np.argsort(-areas)[:max_inst]
    for new_id, comp in enumerate(order, start=1):
        sl = slices[comp]
        out[labeled == comp + 1] = new_id
        boxes[new_id - 1] = (sl[1].start, sl[0].start, sl[1].stop, sl[0].stop)
        valid[new_id - 1] = True
    return out, boxes, valid


def count_max_instances(masks_png: np.ndarray) -> int:
    """The largest 8-connected component count over the slices."""
    best = 0
    for m in masks_png:
        _, n = ndimage.label(m > 0, structure=EIGHT_CONN)
        best = max(best, n)
    return best


def resize_taps(in_size: int, out_size: int):
    """The reference's bilinear weight matrix for one axis, as taps: (index
    [T, out], weight [T, out] float32), T the most nonzero weights an output
    has, in ascending input order (padding taps have weight 0)."""
    f32 = np.float32
    inv = f32(1.0 / (out_size / in_size))
    kscale = max(inv, f32(1.0))
    # (i + 0.5) * inv - 0.5 with one rounding: a fused multiply-add
    sample = ((np.arange(out_size, dtype=np.float64) + 0.5) * np.float64(inv) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kscale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)  # [in, out]
    nz = w != 0
    taps = max(int(nz.sum(axis=0).max()), 1)
    idx = np.zeros((taps, out_size), np.int64)
    wt = np.zeros((taps, out_size), np.float32)
    for j in range(out_size):
        rows = np.nonzero(nz[:, j])[0]
        idx[: len(rows), j] = rows
        wt[: len(rows), j] = w[rows, j]
    return idx, wt


def resize_bilinear_u8(imgs, new_h: int, new_w: int):
    """``jax.image.resize(imgs.astype(f32), (M, new_h, new_w), "bilinear")
    .astype(uint8)`` on a uint8 tensor [M, H, W], on its device."""
    dev = imgs.device
    x = imgs.to(torch.float64)
    iy, wy = (torch.from_numpy(a).to(dev) for a in resize_taps(imgs.shape[1], new_h))
    ix, wx = (torch.from_numpy(a).to(dev) for a in resize_taps(imgs.shape[2], new_w))
    # rows: each tap added into the float32 sum with one rounding (products
    # of a uint8 and a float32 are exact in float64)
    acc = None
    for t in range(iy.shape[0]):
        term = x[:, iy[t], :] * wy[t].to(torch.float64)[None, :, None]
        acc = term.to(torch.float32) if acc is None else (acc.to(torch.float64) + term).to(
            torch.float32)
    # columns: the products rounded to float32, then added
    out = None
    for t in range(ix.shape[0]):
        term = acc[:, :, ix[t]] * wx[t][None, None, :]
        out = term if out is None else out + term
    return out.to(torch.uint8)


def build_dataset(patients: list, plano: str, modalidades: list, mejora: str | None,
                  num_cortes: int | None, dataset_dir, train_size: int = 640,
                  max_inst: int | None = None, device="cuda") -> SliceDataset:
    """Every lesion slice of `patients`, all modalities (one label set a
    slice, shared by its modalities), enhanced and resized into one dataset
    on `device`."""
    dev = torch.device(device)
    all_imgs, all_masks, meta = [], [], []
    for pid in patients:
        p = Paciente(id=pid, plano=plano, modalidad=list(modalidades), dataset_dir=dataset_dir)
        idx = p.indices_a_usar(num_cortes)
        if not idx:
            continue
        mask_png = geometry.to_png_space_batch(torch.from_numpy(p.cortes_mascara_batch(idx)))
        for mod in modalidades:
            img = torch.from_numpy(p.cortes_imagen_batch(idx, mod)).to(dev)
            all_imgs.append(geometry.to_png_space_batch(enhance.enhance_for_model(img, mejora)))
            all_masks.append(mask_png.numpy())
            meta.extend((pid, mod, i) for i in idx)
    if not all_imgs:
        raise ValueError("No se encontraron cortes válidos para el dataset.")

    imgs = torch.cat(all_imgs, 0)  # [M, h, w] uint8, PNG space
    masks = np.concatenate(all_masks, axis=0)
    src_h, src_w = imgs.shape[1:]
    if max_inst is None:
        max_inst = min(max(8, count_max_instances(masks)), 32)

    r = train_size / max(src_h, src_w)
    new_h, new_w = round(src_h * r), round(src_w * r)
    # in chunks: the float64 rows of a whole fold would take tens of GB
    resized = torch.cat([resize_bilinear_u8(imgs[i : i + RESIZE_CHUNK], new_h, new_w)
                         for i in range(0, imgs.shape[0], RESIZE_CHUNK)])

    n = imgs.shape[0]
    instmaps = np.zeros((n, new_h, new_w), np.uint8)
    boxes = np.zeros((n, max_inst, 4), np.float32)
    valid = np.zeros((n, max_inst), bool)
    ys = np.clip(np.round((np.arange(new_h) + 0.5) / r - 0.5).astype(int), 0, src_h - 1)
    xs = np.clip(np.round((np.arange(new_w) + 0.5) / r - 0.5).astype(int), 0, src_w - 1)
    for i in range(n):
        inst, bx, vl = label_instances(masks[i], max_inst)
        instmaps[i] = inst[ys][:, xs]
        boxes[i] = bx * np.float32(r)
        valid[i] = vl
    return SliceDataset(
        images=resized.contiguous(), instmaps=torch.from_numpy(instmaps).to(dev),
        boxes=torch.from_numpy(boxes).to(dev), valid=torch.from_numpy(valid).to(dev),
        meta=meta, src_hw=(int(src_h), int(src_w)), ratio=r,
    )


def fold_patient_split(all_patients: list, fold_test: int, k_folds: int):
    """(train_ids, test_ids) by the deterministic fold assignment."""
    train, test = [], []
    for pid in all_patients:
        (test if calcular_fold(pid, k_folds) == fold_test else train).append(pid)
    return train, test


def epoch_indices(gen: torch.Generator, n_slices: int, batch_size: int, mosaic: bool):
    """[steps, B, 4] int64 source indices for one epoch, drawn on the host
    from `gen`: column 0 a permutation of the slices (wrapping when the
    epoch needs more than there are), columns 1-3 the mosaic's other tiles
    (zero with the mosaic off)."""
    steps = max(n_slices // batch_size, 1)
    need = steps * batch_size
    perm = torch.randperm(n_slices, generator=gen)
    if need > n_slices:
        perm = perm.repeat(-(-need // n_slices))
    primary = perm[:need].reshape(steps, batch_size, 1)
    extra = torch.randint(0, n_slices, (steps, batch_size, 3), generator=gen)
    if not mosaic:
        extra.zero_()
    return torch.cat([primary, extra], dim=-1)
