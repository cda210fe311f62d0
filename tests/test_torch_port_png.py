"""The port's PNG codec (``io/png.py``) against PIL and the JAX package.

The port reads and writes 8-bit grayscale PNGs with the standard library
only. Inputs come from a numpy seed; every comparison is exact (pixels are
integers). PIL and the JAX package serve as oracles here; the port imports
neither.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from tpu_mslesseg.io import png as jpng
from tpu_mslesseg_torch.io import png as tpng


def _images():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:46, 0:61]
    smooth = (np.sin(yy / 5.0) + np.cos(xx / 4.0)) * 60 + 128 + rng.normal(0, 2, yy.shape)
    mask = np.zeros((28, 24), np.uint8)
    mask[6:14, 8:18] = 255
    return {
        "noise": rng.integers(0, 256, (37, 53), dtype=np.uint8),
        "smooth": smooth.clip(0, 255).astype(np.uint8),
        "mask255": mask,
        "mask01": mask // 255,
        "row": rng.integers(0, 256, (1, 19), dtype=np.uint8),
        "column": rng.integers(0, 256, (23, 1), dtype=np.uint8),
        "constant": np.full((9, 7), 200, np.uint8),
    }


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_port_writer_decodes_through_pil(tmp_path, name):
    arr = IMAGES[name]
    path = tmp_path / "deep" / f"{name}.png"
    tpng.save_gray(path, arr)  # creates the parent directory
    with Image.open(path) as im:
        assert im.mode == "L"
        np.testing.assert_array_equal(np.array(im), arr)
    np.testing.assert_array_equal(jpng.load_gray(path), arr)
    np.testing.assert_array_equal(tpng.load_gray(path), arr)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(w, h, *chunks):
    ihdr = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
    return b"\x89PNG\r\n\x1a\n" + ihdr + b"".join(chunks) + _chunk(b"IEND", b"")


def _png_with_filter(arr, ftype):
    """A PNG whose every row carries filter `ftype`, built by hand from the
    format's definition of the five filters."""
    h, w = arr.shape
    a = arr.astype(np.int32)
    left = np.pad(a, ((0, 0), (1, 0)))[:, :-1]
    up = np.pad(a, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(a, ((1, 0), (1, 0)))[:-1, :-1]
    if ftype == 0:
        pred = np.zeros_like(a)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = ftype
    rows[:, 1:] = ((a - pred) % 256).astype(np.uint8)
    raw = zlib.compress(rows.tobytes())
    half = len(raw) // 2  # two IDAT chunks: the stream may be split anywhere
    return _png(w, h, _chunk(b"tEXt", b"Comment\x00hand-built"),
                _chunk(b"IDAT", raw[:half]), _chunk(b"IDAT", raw[half:]))


@pytest.mark.parametrize(
    "source", ["pil", "pil_optimize", "jax_batch", "jax_single",
               "filter0", "filter1", "filter2", "filter3", "filter4", "mixed_filters"],
)
def test_port_reader_decodes_foreign_files(tmp_path, source):
    for name, arr in IMAGES.items():
        path = tmp_path / f"{name}.png"
        if source.startswith("pil"):
            Image.fromarray(arr, mode="L").save(path, optimize=source == "pil_optimize")
        elif source == "jax_batch":
            jpng.save_gray_batch([path], arr[None])
        elif source == "jax_single":
            jpng.save_gray(path, arr)
        elif source == "mixed_filters":
            # rows cycling through the five filters
            rows = [_png_with_filter(arr, f) for f in range(5)]
            path.write_bytes(_mixed(arr, rows))
        else:
            path.write_bytes(_png_with_filter(arr, int(source[-1])))
        with Image.open(path) as im:  # the file is a PNG PIL agrees on
            np.testing.assert_array_equal(np.array(im), arr, err_msg=name)
        got = tpng.load_gray(path)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, arr, err_msg=name)


def _mixed(arr, per_filter_pngs):
    """Row y takes its filtered bytes from the all-rows-filter-(y%5) file."""
    h, w = arr.shape
    rows = []
    for f, raw in enumerate(per_filter_pngs):
        idat = b""
        pos = 8
        while pos < len(raw):
            (n,) = struct.unpack_from(">I", raw, pos)
            if raw[pos + 4 : pos + 8] == b"IDAT":
                idat += raw[pos + 8 : pos + 8 + n]
            pos += 12 + n
        rows.append(np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1))
    mixed = np.stack([rows[y % 5][y] for y in range(h)])
    return _png(w, h, _chunk(b"IDAT", zlib.compress(mixed.tobytes())))


def _unsupported(kind, path):
    rng = np.random.default_rng(2)
    if kind == "16bit":
        Image.fromarray(rng.integers(0, 65536, (8, 9)).astype(np.uint16)).save(path)
    elif kind == "rgb":
        Image.fromarray(rng.integers(0, 256, (8, 9, 3), dtype=np.uint8), mode="RGB").save(path)
    elif kind == "rgba":
        Image.fromarray(rng.integers(0, 256, (8, 9, 4), dtype=np.uint8), mode="RGBA").save(path)
    elif kind == "palette":
        Image.fromarray(rng.integers(0, 256, (8, 9), dtype=np.uint8), mode="L").convert(
            "P").save(path)
    elif kind == "interlaced":
        raw = bytearray(tpng.encode_gray(IMAGES["noise"]))
        raw[8 + 8 + 12] = 1  # IHDR's interlace byte
        raw[8 + 8 + 13 : 8 + 8 + 17] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
        path.write_bytes(bytes(raw))
    elif kind == "bad_crc":
        raw = bytearray(tpng.encode_gray(IMAGES["noise"]))
        raw[-20] ^= 0xFF  # inside the IDAT data
        path.write_bytes(bytes(raw))
    elif kind == "not_png":
        path.write_bytes(b"GIF89a" + bytes(40))


@pytest.mark.parametrize(
    "kind", ["16bit", "rgb", "rgba", "palette", "interlaced", "bad_crc", "not_png"])
def test_port_reader_refuses_other_pngs_by_name(tmp_path, kind):
    path = tmp_path / f"{kind}.png"
    _unsupported(kind, path)
    with pytest.raises(ValueError, match=f"{kind}.png"):
        tpng.load_gray(path)
    with pytest.raises(ValueError):
        tpng.load_pred_png(path)


def test_encode_refuses_what_is_not_a_2d_image():
    for bad in (np.zeros((3, 4, 5), np.uint8), np.zeros((0, 4), np.uint8), np.zeros(7, np.uint8)):
        with pytest.raises(ValueError):
            tpng.encode_gray(bad)


@pytest.mark.parametrize("helper", ["slice", "mask01", "mask255", "pred", "batch"])
def test_png_helpers_match_the_jax_package(tmp_path, helper):
    rng = np.random.default_rng(5)
    sl = rng.normal(500, 150, (24, 28)).astype(np.float32)
    mask = (rng.random((24, 28)) > 0.6).astype(np.float32)
    jp, tp = tmp_path / "j.png", tmp_path / "t.png"
    if helper == "slice":
        jpng.save_slice_png(jp, sl)
        tpng.save_slice_png(tp, sl)
    elif helper.startswith("mask"):
        jpng.save_mask_png(jp, mask, binary_01=helper == "mask01")
        tpng.save_mask_png(tp, mask, binary_01=helper == "mask01")
    elif helper == "pred":
        jpng.save_pred_png(jp, mask)
        tpng.save_pred_png(tp, mask)
    else:
        stack = rng.integers(0, 256, (3, 12, 15), dtype=np.uint8)
        jpng.save_gray_batch([tmp_path / f"j{i}.png" for i in range(3)], stack)
        tpng.save_gray_batch([tmp_path / f"t{i}.png" for i in range(3)], stack)
        for i in range(3):
            np.testing.assert_array_equal(tpng.load_gray(tmp_path / f"t{i}.png"), stack[i])
            np.testing.assert_array_equal(tpng.load_gray(tmp_path / f"j{i}.png"), stack[i])
        return
    want = jpng.load_gray(jp)
    np.testing.assert_array_equal(tpng.load_gray(tp), want)
    np.testing.assert_array_equal(tpng.load_gray(jp), want)
    # each package reads the other's file the same way, in both spaces
    for path in (jp, tp):
        np.testing.assert_array_equal(tpng.load_pred_png(path), jpng.load_pred_png(path))
        got = tpng.load_slice_png_volspace(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jpng.load_slice_png_volspace(path))
    if helper == "pred":
        assert set(np.unique(want)) == {0, 255} and want.shape == mask.shape
        np.testing.assert_array_equal(tpng.load_pred_png(tp), mask)
