"""Host profile of stage 1 (slice extraction) for one synthetic patient.

    python -m tpu_mslesseg_torch.tools.profile_stage1 [--device cuda]
        [--plano axial] [--mejora CLAHE] [--lesion 60] [--ref]

Writes one 182x218x182 patient (seeded noise, a box lesion of ``--lesion``
slices a side) into a temporary experiment tree, runs
``extraer_dataset.ejecutar_flujo_dataset`` on it under ``cProfile`` with
``--num_cortes 50``, and prints one JSON line: the stage's wall seconds and
the cumulative seconds of its parts (volume loads, slice extraction, the
enhancement with its transfers, the PNG writes, the label files). The stage
is host work around a few milliseconds of device work, so this is where its
time is read. ``--ref`` writes the label files with
``labels.write_yolo_seg_label_ref`` (the reference's walk, every point
formatted) in place of the stage's writer; the bytes are the same.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np

from tpu_mslesseg_torch.io import nifti
from tpu_mslesseg_torch.pipeline import labels
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paths import ConfigDataset
from tpu_mslesseg_torch.pipeline.stages import extraer_dataset

VOL_SHAPE = (182, 218, 182)
# part -> (file suffix, function) whose cumulative time is reported
PARTS = {
    "nifti_load": ("io/nifti.py", "load"),
    "extract_slices": ("core/geometry.py", "extract_slices"),
    "enhance_batch": ("preproc/enhance.py", "enhance_batch"),
    "minmax_to_uint8": ("core/geometry.py", "minmax_to_uint8"),
    "save_gray_batch": ("io/png.py", "save_gray_batch"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plano", default="axial", choices=["axial", "coronal", "sagital"])
    ap.add_argument("--mejora", default="CLAHE", choices=["HE", "CLAHE", "GC", "LT"])
    ap.add_argument("--lesion", type=int, default=60)
    ap.add_argument("--ref", action="store_true",
                    help="write the label files with write_yolo_seg_label_ref")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    vol = rng.normal(500, 150, VOL_SHAPE).astype(np.float32)
    mask = np.zeros(VOL_SHAPE, np.uint8)
    lo = [s // 2 - args.lesion // 2 for s in VOL_SHAPE]
    mask[tuple(slice(a, a + args.lesion) for a in lo)] = 1
    with tempfile.TemporaryDirectory(prefix="profile_stage1_") as tmp:
        root = Path(tmp)
        pdir = root / "MSLesSeg-Dataset" / "train" / "P1" / "T1"
        nifti.save(vol, np.eye(4), pdir / "P1_T1_FLAIR.nii.gz")
        nifti.save(mask, np.eye(4), pdir / "P1_T1_MASK.nii.gz")
        modelo = Modelo(plano=args.plano, num_cortes=50, modalidad=["FLAIR"], k_folds=2,
                        mejora=args.mejora)
        config = ConfigDataset(modelo=modelo, k_folds=2, completo=True, root=root)
        writer = labels.write_yolo_seg_label_ref if args.ref else labels.write_yolo_seg_label
        profile = cProfile.Profile()
        with mock.patch.object(extraer_dataset.labels_mod, "write_yolo_seg_label", writer):
            t0 = time.perf_counter()
            profile.enable()
            estado = extraer_dataset.ejecutar_flujo_dataset(config, device=args.device)
            profile.disable()
            wall = time.perf_counter() - t0
        label_files = sorted(config.paths_paciente_dirs("P1")["labels"].glob("*.txt"))
        label_bytes = sum(f.stat().st_size for f in label_files)
    if estado is not True:
        raise SystemExit(f"stage 1 returned {estado}")
    stats = pstats.Stats(profile).stats
    parts = {}
    walk = "trace_boundary_ref" if args.ref else "trace_boundary_period"
    funcs = {**PARTS, "write_yolo_seg_label": ("pipeline/labels.py", writer.__name__),
             "trace_boundary": ("pipeline/labels.py", walk)}
    for name, (suffix, func) in funcs.items():
        hits = [v[3] for (path, _, fn), v in stats.items() if path.endswith(suffix) and fn == func]
        parts[name] = round(sum(hits), 4)
    print(json.dumps({"what": "stage 1, one patient", "device": args.device,
                      "plano": args.plano, "mejora": args.mejora, "writer": writer.__name__,
                      "slices": len(label_files),
                      "wall_s": round(wall, 4), "cumulative_s": parts,
                      "label_bytes": label_bytes}))


if __name__ == "__main__":
    main()
