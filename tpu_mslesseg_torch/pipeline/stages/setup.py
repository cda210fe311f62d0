"""Stage 0 — dataset setup: download MSLesSeg, unpack, build GT tree.

Port of ``tpu_mslesseg/pipeline/stages/setup.py`` (host only).

Reference: ``scripts/setup.py`` — streams the Figshare ZIP with a progress
bar, unzips stripping the root folder and skipping ``info_dataset/``, then
builds ``GT/{train,test}/PX/PX_MASK.nii.gz`` with unified names (train
masks live at ``PX/T1/PX_T1_MASK.nii.gz``, test at ``PX/PX_MASK.nii.gz``).
Also accepts a pre-downloaded ZIP or an existing dataset directory (for
air-gapped environments).
"""

from __future__ import annotations

import argparse
import shutil
import sys
import zipfile
from pathlib import Path

from tpu_mslesseg_torch.pipeline.logging_setup import get_logger

logger = get_logger(__file__)

FIGSHARE_URL = (
    "https://figshare.com/ndownloader/files/52012952"  # MSLesSeg ZIP (public)
)
DATASET_DIR = Path("MSLesSeg-Dataset")
GT_DIR = Path("GT")


def descargar_archivo(url: str, destino: Path, chunk: int = 1 << 20):
    import requests

    destino.parent.mkdir(parents=True, exist_ok=True)
    logger.info(f"⬇️ Descargando {url} -> {destino}")
    with requests.get(url, stream=True, timeout=60) as r:
        r.raise_for_status()
        total = int(r.headers.get("content-length", 0))
        done = 0
        with open(destino, "wb") as f:
            for part in r.iter_content(chunk_size=chunk):
                f.write(part)
                done += len(part)
                if total:
                    pct = 100 * done / total
                    print(f"\r    {done >> 20} MiB / {total >> 20} MiB ({pct:.0f}%)",
                          end="", flush=True)
    print()
    return destino


def descomprimir_zip(zip_path: Path, destino: Path):
    """Unzip stripping the top-level folder; skip ``info_dataset/``."""
    destino.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(zip_path) as z:
        names = [n for n in z.namelist() if not n.endswith("/")]
        roots = {n.split("/", 1)[0] for n in names if "/" in n}
        strip_root = len(roots) == 1
        for n in names:
            rel = n.split("/", 1)[1] if strip_root and "/" in n else n
            if not rel or rel.startswith("info_dataset"):
                continue
            out = destino / rel
            out.parent.mkdir(parents=True, exist_ok=True)
            with z.open(n) as src, open(out, "wb") as dst:
                shutil.copyfileobj(src, dst)
    logger.info(f"📦 Dataset descomprimido en {destino}.")


def obtener_mask_path(paciente_dir: Path, split: str) -> Path | None:
    """Train masks: ``PX/T1/PX_T1_MASK.nii.gz``; test: ``PX/PX_MASK.nii.gz``."""
    pid = paciente_dir.name
    if split == "train":
        cand = paciente_dir / "T1" / f"{pid}_T1_MASK.nii.gz"
        if cand.exists():
            return cand
        flat = paciente_dir / f"{pid}_MASK.nii.gz"
        return flat if flat.exists() else None
    cand = paciente_dir / f"{pid}_MASK.nii.gz"
    return cand if cand.exists() else None


def mover_volumenes_gt(dataset_dir: Path, gt_dir: Path):
    """Build GT/{split}/PX/PX_MASK.nii.gz (copies, unified names)."""
    for split in ("train", "test"):
        src_split = dataset_dir / split
        if not src_split.is_dir():
            continue
        for pac in sorted(src_split.iterdir()):
            if not pac.is_dir() or not pac.name.startswith("P"):
                continue
            mask = obtener_mask_path(pac, split)
            if mask is None:
                logger.warning(f"⚠️ Sin máscara para {pac.name} ({split}).")
                continue
            out = gt_dir / split / pac.name / f"{pac.name}_MASK.nii.gz"
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(mask, out)
    logger.info(f"🗂️ GT preparado en {gt_dir}.")


def ejecutar_flujo_setup(zip_path=None, url=FIGSHARE_URL, limpiar=False):
    dataset_dir = DATASET_DIR
    gt_dir = GT_DIR

    if limpiar and gt_dir.exists():
        shutil.rmtree(gt_dir)

    if (dataset_dir / "train").is_dir():
        logger.skip("⏩ Dataset MSLesSeg ya presente.")
    else:
        if zip_path is None:
            zip_path = Path("MSLesSeg.zip")
            if not zip_path.exists():
                descargar_archivo(url, zip_path)
        descomprimir_zip(Path(zip_path), dataset_dir)

    gt_done = (gt_dir / "train").is_dir() and any((gt_dir / "train").iterdir())
    if gt_done and not limpiar:
        logger.skip("⏩ GT ya preparado.")
    else:
        mover_volumenes_gt(dataset_dir, gt_dir)
    return True


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Preparar el dataset MSLesSeg.")
    parser.add_argument("--zip", type=str, default=None,
                        help="ZIP local (omite la descarga).")
    parser.add_argument("--url", type=str, default=FIGSHARE_URL)
    parser.add_argument("--limpiar", action="store_true")
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None):
    args = parsear_args(argv)
    logger.header("\n🚀 Setup del dataset MSLesSeg.")
    ejecutar_flujo_setup(zip_path=args.zip, url=args.url, limpiar=args.limpiar)


def ejecutar_setup_pipeline(limpiar=False):
    return ejecutar_flujo_setup(limpiar=limpiar)


if __name__ == "__main__":
    main()
