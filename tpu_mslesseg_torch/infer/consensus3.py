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

With ``devices=[...]`` (the counterpart of the reference's ``mesh=``),
`lote` gives a model replica on each card a contiguous chunk of every
patient's slice axis, padded to a multiple of the card count with slices
whose index is out of range (their writes are dropped, as the reference's
are), and gathers the masks on the first card, which scatters them into the
volumes and counts: the results are one card's. Not ported (TPU-only): the
serving TPU flags.
"""

from __future__ import annotations

from collections.abc import Mapping

import contextlib
from typing import NamedTuple

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


class _Replica(NamedTuple):
    """The served weights on one device."""

    device: torch.device
    variables: dict  # state_dict, or {plane: state_dict}
    stem_w: object  # stem.maybe_build's weights, or None


def _on(device: torch.device):
    """The context that makes `device` current (a kernel wrapper launches on
    the current card)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


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
    CUDA kernel for CUDA tensors. With `devices`, `lote` splits each
    patient's slice axis over those devices (the first is `device`).
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
        devices=None,
    ):
        self.model = model
        self.planes = tuple(planes)
        self.per_plane_counts = per_plane_counts
        if len(self.planes) != 3 and not per_plane_counts:
            raise ValueError(
                "sin los tres planos no hay consenso: use per_plane_counts=True"
            )
        self.devices = [torch.device(d) for d in devices] if devices else None
        self.device = self.devices[0] if self.devices else torch.device(device)
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
        self._replicas = [self._replica(model, variables, d)
                          for d in (self.devices or [self.device])]
        self.variables, self._stem_w = self._replicas[0].variables, self._replicas[0].stem_w

    def _replica(self, model, variables, device) -> _Replica:
        """`variables` prepared on `device`, with the opt-in fused stem's
        weights (TPU_MSLESSEG_PALLAS_STEM=1, CUDA only), one set per plane
        with per-plane variables."""
        if _per_plane(variables):
            v = {p: prepare_variables(model, vp, device) for p, vp in variables.items()}
        else:
            v = prepare_variables(model, variables, device)
        with _on(device):
            return _Replica(device, v, stem.maybe_build(v, device, self.imgsz))

    def _as_device(self, x, dtype=None):
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _union_logits(self, slices, rep: _Replica | None = None):
        """Enhance + letterbox each plane's slice batch, run the forward +
        NMS + proto-mask union with `rep`'s weights (the first device's by
        default). Returns (union [sum(n_mod*N), mh, mw] logits, segments:
        list of (plane, n_mod, N))."""
        rep = rep or self._replicas[0]
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
        sw = rep.stem_w
        if _per_plane(rep.variables):
            union = torch.cat(
                [run(rep.variables[p], x, None if sw is None else sw[p])
                 for (p, _, _), x in zip(segs, xs_by_plane)], 0,
            )
        else:
            union = run(rep.variables, torch.cat(xs_by_plane, 0), sw)
        return union, segs

    def _plane_logits(self, union_p, plane):
        """Union logits [M, mh, mw] -> volume-space sampled logits [M, h, w]
        on the exact inverse-letterbox grid."""
        ys, xs = proto_grid(self.lb[plane], union_p.device)
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

    def _slices_to_device(self, slices, flat, device=None):
        """Slices on `device` (the first); with `flat`, [P, N, h, w] ->
        [P*N, h, w]."""
        def conv(v):
            v = torch.as_tensor(v).to(device or self.device)
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
        if self.devices is None:
            union, segs = self._union_logits(self._slices_to_device(slices, True))
            masks = self._plane_masks(union, segs, n_pat)
        else:
            slices, idx = self._pad_slice_axis(slices, idx)
            masks = self._sharded_masks(slices, n_pat)
        vols = {}
        for p in self.planes:
            ix = self._as_device(idx[p])
            vols[p] = torch.stack([
                geometry.insert_slices(self.vol_shape, masks[p][i], p, ix[i])
                for i in range(n_pat)
            ])
        return self._finish(vols, gts)

    def _pad_slice_axis(self, slices, idx):
        """Each plane's slice axis padded to a multiple of the device count:
        zero slices at the index ``max(vol_shape)``, whose writes drop."""
        n_dev = len(self.devices)
        out_s, out_i = {}, {}
        for p in self.planes:
            ix = torch.as_tensor(idx[p])
            pad = -ix.shape[1] % n_dev
            out_i[p] = torch.cat([ix, ix.new_full((ix.shape[0], pad), max(self.vol_shape))], 1)

            def padded(v, pad=pad):
                v = torch.as_tensor(v)
                return torch.cat([v, v.new_zeros((v.shape[0], pad) + tuple(v.shape[2:]))], 1)

            sl = slices[p]
            out_s[p] = {m: padded(v) for m, v in sl.items()} if isinstance(sl, Mapping) \
                else padded(sl)
        return out_s, out_i

    def _sharded_masks(self, slices, n_pat):
        """Replica i serves chunk i of every patient's (padded) slice axis;
        the chunks' masks [n_pat, N/n_dev, h, w] are gathered on the first
        device and joined along the slice axis."""
        n_dev = len(self.devices)

        def chunk(v, i):
            c = v.shape[1] // n_dev
            return v[:, i * c:(i + 1) * c]

        parts = []
        for i, rep in enumerate(self._replicas):
            sl = {p: ({m: chunk(v, i) for m, v in slices[p].items()}
                      if isinstance(slices[p], Mapping) else chunk(slices[p], i))
                  for p in self.planes}
            with _on(rep.device):
                union, segs = self._union_logits(
                    self._slices_to_device(sl, True, rep.device), rep)
                parts.append(self._plane_masks(union, segs, n_pat))
        return {p: torch.cat([m[p].to(self.device) for m in parts], 1) for p in self.planes}

    @staticmethod
    def metrics_from_counts(counts) -> dict:
        """Host-side: fetched [tp,fp,fn,tn] -> reference metrics dict."""
        return mx.metrics_from_counts(counts)
