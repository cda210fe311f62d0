"""Fused 3-plane consensus inference for whole patients.

Port of ``tpu_mslesseg/infer/consensus3.py``. One call runs, on the
device:

    raw volume slices (3 planes)
      -> enhancement + per-slice PNG stretch
      -> per-plane letterbox -> one concatenated [sum(N), S, S, 1] forward
         (or one forward per plane with per-plane weights; the stem as the
         fused CUDA kernel with TPU_MSLESSEG_PALLAS_STEM=1)
      -> DFL decode + padded NMS + proto-mask union (CUDA kernel)
      -> per-plane inverse-letterbox sampling -> volume scatter
      -> majority vote -> confusion counts

Not ported (TPU-only or later): the serving TPU flags and the ``mesh=``
SPMD path.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.evalx import metrics as mx
from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.infer.mask_union import mask_union_logits_batch
from tpu_mslesseg_torch.infer.predictor import (
    _bilinear_sample, detect_and_union, prepare_variables, proto_grid,
)
from tpu_mslesseg_torch.infer.reconstruct import consensus_vote
from tpu_mslesseg_torch.model import stem
from tpu_mslesseg_torch.preproc import enhance

PLANES = geometry.PLANES


def _per_plane(variables) -> bool:
    """{plane: state_dict} (one trained model per plane) vs one state_dict."""
    return bool(variables) and all(k in PLANES for k in variables)


class ConsensusPredictor:
    """3-plane predict + reconstruct + consensus + metrics.

    Usage:
        cp = ConsensusPredictor(model, variables, vol_shape=(182, 218, 182),
                                mejora="GC", device="cuda")
        counts, consensus, vols = cp(slices_by_plane, idx_by_plane, gt_vol)
        metrics = cp.metrics_from_counts(counts)   # host-side dict

    `model` is a `YOLO11Seg` (architecture and compute dtype); `variables`
    is its state_dict, or {plane: state_dict}. `slices_by_plane[p]` are RAW
    volume-space slices [N_p, h_p, w_p] (or {modalidad: [N_p, h_p, w_p]});
    enhancement and the PNG min-max stretch happen on the device.
    `mask_union` computes the proto-mask union; the default launches the
    CUDA kernel for CUDA tensors.
    """

    def __init__(
        self,
        model,
        variables,
        vol_shape,
        mejora: str | None = "Base",
        imgsz: int = 640,
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        umbral: int = 2,
        mask_thresh: float = 0.0,
        planes=PLANES,
        per_plane_counts: bool = False,
        device="cuda",
        mask_union=mask_union_logits_batch,
    ):
        self.model = model
        self.planes = tuple(planes)
        self.per_plane_counts = per_plane_counts
        if len(self.planes) != 3 and not per_plane_counts:
            raise ValueError(
                "sin los tres planos no hay consenso: use per_plane_counts=True"
            )
        self.device = torch.device(device)
        if _per_plane(variables):
            self.variables = {
                p: prepare_variables(model, v, self.device)
                for p, v in variables.items()
            }
        else:
            self.variables = prepare_variables(model, variables, self.device)
        self.vol_shape = tuple(vol_shape)
        self.mejora = mejora
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.umbral = umbral
        self.mask_thresh = mask_thresh
        self.mask_union = mask_union
        self.lb = {}
        for p in self.planes:
            h, w = geometry.slice_shape(self.vol_shape, p)
            # PNG-space (model) dims are transposed volume-slice dims
            self.lb[p] = dec.Letterbox(src_h=w, src_w=h, size=imgsz)
        # opt-in fused stem (TPU_MSLESSEG_PALLAS_STEM=1, CUDA only), one set
        # of stem weights per plane with per-plane variables
        self._stem_w = stem.maybe_build(self.variables, self.device, imgsz)

    def _as_device(self, x, dtype=None):
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _union_logits(self, slices):
        """Enhance + letterbox each plane's slice batch, run the forward +
        NMS + proto-mask union. Returns (union [sum(n_mod*N), mh, mw]
        logits, segments: list of (plane, n_mod, N))."""
        segs = []
        xs_by_plane = []
        for p in self.planes:
            mods = slices[p] if isinstance(slices[p], Mapping) else {None: slices[p]}
            xs = []
            n = None
            for sl in mods.values():
                img_u8 = enhance.enhance_for_model(sl, self.mejora)
                png = geometry.to_png_space_batch(img_u8).to(torch.float32) / 255.0
                xs.append(self.lb[p].apply(png))
                n = sl.shape[0]
            # grayscale [n_mod*N, S, S, 1] in the compute dtype, for the
            # folded stem
            xs_by_plane.append(torch.cat(xs, 0).to(self.model.dtype)[..., None])
            segs.append((p, len(mods), n))

        run = lambda v, x, sw: detect_and_union(
            self.model, v, x, self.imgsz, self.conf, self.iou, self.max_det,
            self.mask_union, sw,
        )
        sw = self._stem_w
        if _per_plane(self.variables):
            union = torch.cat(
                [run(self.variables[p], x, None if sw is None else sw[p])
                 for (p, _, _), x in zip(segs, xs_by_plane)], 0,
            )
        else:
            union = run(self.variables, torch.cat(xs_by_plane, 0), sw)
        return union, segs

    def _plane_logits(self, union_p, plane):
        """Union logits [M, mh, mw] -> volume-space sampled logits [M, h, w]
        on the exact inverse-letterbox grid."""
        ys, xs = proto_grid(self.lb[plane], self.device)
        return geometry.from_png_space_batch(_bilinear_sample(union_p, ys, xs))

    def _plane_masks(self, union, segs, n_pat):
        """Per plane: binary masks [n_pat, N, h, w], the modalities OR'd."""
        masks = {}
        start = 0
        for p, n_mod, n in segs:
            m = self._plane_logits(union[start : start + n_mod * n], p)
            m = m > self.mask_thresh
            start += n_mod * n
            if n_mod > 1:  # multimodal: binary-mask union across modalities
                m = m.reshape((n_mod, n) + m.shape[1:]).any(dim=0)
            masks[p] = m.reshape((n_pat, -1) + m.shape[1:])
        return masks

    def _finish(self, vols, gt):
        cons = None
        if len(self.planes) == 3:
            cons = consensus_vote(
                vols["axial"], vols["coronal"], vols["sagital"], self.umbral
            )
        if self.per_plane_counts:
            counts = {p: mx.confusion_counts(gt, vols[p]) for p in vols}
            if cons is not None:
                counts["consenso"] = mx.confusion_counts(gt, cons)
        else:
            counts = mx.confusion_counts(gt, cons)
        return counts, cons, vols

    def _check_shapes(self, slices, lead):
        for p in self.planes:
            sl = slices[p]
            h, w = geometry.slice_shape(self.vol_shape, p)
            for arr in (sl.values() if isinstance(sl, Mapping) else [sl]):
                if tuple(arr.shape[lead:]) != (h, w):
                    raise ValueError(f"{p}: slices {tuple(arr.shape)}, want (..., {h}, {w})")

    def _slices_to_device(self, slices, flat):
        """Slices on the device; with `flat`, [P, N, h, w] -> [P*N, h, w]."""
        def conv(v):
            v = self._as_device(v)
            return v.reshape((-1,) + tuple(v.shape[-2:])) if flat else v

        return {
            p: {m: conv(v) for m, v in slices[p].items()}
            if isinstance(slices[p], Mapping) else conv(slices[p])
            for p in self.planes
        }

    @torch.inference_mode()
    def __call__(self, slices, idx, gt):
        """One patient: returns (counts [4] — or {plane: [4]} with
        ``per_plane_counts`` —, consensus volume, {plane: volume})."""
        self._check_shapes(slices, 1)
        union, segs = self._union_logits(self._slices_to_device(slices, False))
        masks = self._plane_masks(union, segs, 1)
        vols = {
            p: geometry.insert_slices(
                self.vol_shape, masks[p][0], p, self._as_device(idx[p])
            )
            for p in self.planes
        }
        return self._finish(vols, self._as_device(gt))

    @torch.inference_mode()
    def lote(self, slices, idx, gts):
        """Batch of patients in one call: `slices[p]` [P, N, h, w] (or
        {modalidad: [P, N, h, w]}), `idx[p]` [P, N], `gts` [P, X, Y, Z].
        Returns per-patient (counts [P,4] — or {plane: [P,4]} with
        ``per_plane_counts`` —, consensus [P,...], vols {plane: [P,...]}).

        A short patient is padded to the group's N with any slices and the
        index ``max(vol_shape)``: those writes are dropped."""
        self._check_shapes(slices, 2)
        gts = self._as_device(gts)
        n_pat = gts.shape[0]
        union, segs = self._union_logits(self._slices_to_device(slices, True))
        masks = self._plane_masks(union, segs, n_pat)
        vols = {}
        for p in self.planes:
            ix = self._as_device(idx[p])
            vols[p] = torch.stack([
                geometry.insert_slices(self.vol_shape, masks[p][i], p, ix[i])
                for i in range(n_pat)
            ])
        return self._finish(vols, gts)

    @staticmethod
    def metrics_from_counts(counts) -> dict:
        """Host-side: fetched [tp,fp,fn,tn] -> reference metrics dict."""
        return mx.metrics_from_counts(counts)
