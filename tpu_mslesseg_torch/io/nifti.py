"""Self-contained NIfTI-1 codec (.nii / .nii.gz), pure numpy.

Port of ``tpu_mslesseg/io/nifti.py``, behaviour unchanged: files either
package writes, the other reads. Like it, this replaces the reference's
nibabel dependency (``utils/utils.py:153-181``:
``nib.load(...).get_fdata()``, ``nib.save(Nifti1Image(vol, affine))``).
Implements exactly the subset of NIfTI-1 the pipeline needs:

* read: dims, datatype, scl slope/inter, qform/sform affines, data in
  Fortran order, optional gzip container;
* write: single-file ``n+1`` images with an sform affine, data dtype
  preserved from the array.

Endian-safe: headers declaring a byte-swapped ``sizeof_hdr`` are swapped.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_HDR_SIZE = 348
_MAGIC_N1 = b"n+1\x00"

# NIfTI datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """In-memory NIfTI image: raw data array + affine (+ header extras)."""

    data: np.ndarray
    affine: np.ndarray

    @property
    def shape(self):
        return self.data.shape

    def get_fdata(self) -> np.ndarray:
        """Float64 view of the data (nibabel-compatible semantics)."""
        return np.asarray(self.data, dtype=np.float64)


def _read_bytes(path: Path) -> bytes:
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def _quaternion_to_affine(b, c, d, qx, qy, qz, dx, dy, dz, qfac):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    rot = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    if qfac == 0:
        qfac = 1.0
    zooms = np.array([dx, dy, dz * qfac])
    aff = np.eye(4)
    aff[:3, :3] = rot * zooms
    aff[:3, 3] = [qx, qy, qz]
    return aff


def load(path) -> NiftiImage:
    """Load a .nii or .nii.gz file."""
    raw = _read_bytes(Path(path))
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"Not a NIfTI-1 file (too short): {path}")
    hdr = raw[:_HDR_SIZE]

    (sizeof_hdr,) = struct.unpack_from("<i", hdr, 0)
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        (sizeof_hdr,) = struct.unpack_from(">i", hdr, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"Not a NIfTI-1 file (bad sizeof_hdr): {path}")

    dim = struct.unpack_from(endian + "8h", hdr, 40)
    (datatype, bitpix) = struct.unpack_from(endian + "2h", hdr, 70)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)
    (vox_offset,) = struct.unpack_from(endian + "f", hdr, 108)
    (scl_slope, scl_inter) = struct.unpack_from(endian + "2f", hdr, 112)
    (qform_code, sform_code) = struct.unpack_from(endian + "2h", hdr, 252)
    quat = struct.unpack_from(endian + "6f", hdr, 256)  # b c d qx qy qz
    srow_x = struct.unpack_from(endian + "4f", hdr, 280)
    srow_y = struct.unpack_from(endian + "4f", hdr, 296)
    srow_z = struct.unpack_from(endian + "4f", hdr, 312)

    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"Bad ndim {ndim} in {path}")
    shape = tuple(int(d) for d in dim[1 : 1 + ndim])

    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype} in {path}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    offset = int(vox_offset) if vox_offset >= _HDR_SIZE else _HDR_SIZE + 4
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    data = data.reshape(shape, order="F")
    data = np.asarray(data, dtype=data.dtype.newbyteorder("="))

    # scaling (nibabel applies slope/inter when meaningful)
    if np.isfinite(scl_slope) and scl_slope not in (0.0, 1.0) or (
        np.isfinite(scl_inter) and scl_inter != 0.0 and scl_slope != 0.0
    ):
        data = data * np.float64(scl_slope) + np.float64(scl_inter)

    if sform_code > 0:
        affine = np.eye(4)
        affine[0, :] = srow_x
        affine[1, :] = srow_y
        affine[2, :] = srow_z
    elif qform_code > 0:
        affine = _quaternion_to_affine(
            *quat, pixdim[1], pixdim[2], pixdim[3], pixdim[0]
        )
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])

    return NiftiImage(data=data, affine=np.asarray(affine, dtype=np.float64))


def save(img_or_data, affine=None, path=None):
    """Save a NIfTI-1 image (``save(NiftiImage, path=...)`` or
    ``save(data, affine, path)``)."""
    if isinstance(img_or_data, NiftiImage):
        data, affine = img_or_data.data, img_or_data.affine
    else:
        data = np.asarray(img_or_data)
    if path is None or affine is None:
        raise ValueError("save() needs both an affine and a path")
    path = Path(path)
    affine = np.asarray(affine, dtype=np.float64)

    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    dt = np.dtype(data.dtype).newbyteorder("=")
    if dt not in _DTYPE_CODES:
        data = data.astype(np.float32)
        dt = np.dtype(np.float32)
    code = _DTYPE_CODES[dt]
    bitpix = dt.itemsize * 8

    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    pixdim = [1.0] + [float(z) if z > 0 else 1.0 for z in zooms[: min(3, ndim)]]
    pixdim += [1.0] * (8 - len(pixdim))

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<2h", hdr, 70, code, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 2)  # qform=0, sform=2 (aligned)
    struct.pack_into("<4f", hdr, 280, *affine[0, :])
    struct.pack_into("<4f", hdr, 296, *affine[1, :])
    struct.pack_into("<4f", hdr, 312, *affine[2, :])
    hdr[344:348] = _MAGIC_N1

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.asfortranarray(data).tobytes(order="F")
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz" or str(path).endswith(".nii.gz"):
        path.write_bytes(gzip.compress(payload, compresslevel=1))
    else:
        path.write_bytes(payload)


def load_header(path):
    """Return (shape, affine) without materializing data as float
    (reference ``cargar_referencia_nifti``, ``utils/utils.py:162-170``)."""
    img = load(path)
    return img.shape, img.affine
