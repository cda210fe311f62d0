"""The port's native host IO (``io/native.py``, ``csrc/hostio.cc``) against
the JAX package's (``tpu_mslesseg/io/native.py``, ``native/hostio.cc``) and
the port's own PNG encoder.

Both libraries are built with the machine's ``g++`` and zlib. The images
come from a numpy seed: random pixels, a flat image, a stage-1-sized slice
(218x182) and a single row. Tolerance: none; files are compared byte for
byte.
"""

import gzip
import logging
import os

import numpy as np
import pytest

from tpu_mslesseg.io import native as jnative
from tpu_mslesseg_torch.io import native, png


def _images():
    rng = np.random.default_rng(11)
    return {
        "random": rng.integers(0, 256, (37, 53)).astype(np.uint8),
        "flat": np.full((16, 16), 7, np.uint8),
        "slice": (rng.random((218, 182)) ** 4 * 255).astype(np.uint8),
        "row": rng.integers(0, 256, (1, 300)).astype(np.uint8),
    }


@pytest.mark.parametrize("name", sorted(_images()))
def test_write_gray_png_writes_encode_grays_bytes_and_the_jax_packages(tmp_path, name):
    img = _images()[name]
    assert native.write_gray_png(tmp_path / "port.png", img)
    assert jnative.write_gray_png(tmp_path / "jax.png", img)
    got = (tmp_path / "port.png").read_bytes()
    assert got == png.encode_gray(img) == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(png.load_gray(tmp_path / "port.png"), img)


def test_the_batch_writer_writes_every_file_and_reports_failures(tmp_path):
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, (9, 24, 20)).astype(np.uint8)
    paths = [tmp_path / f"{i}.png" for i in range(9)]
    jpaths = [tmp_path / f"j{i}.png" for i in range(9)]
    assert native.write_gray_png_batch(paths, imgs)
    assert jnative.write_gray_png_batch(jpaths, imgs)
    for p, jp, img in zip(paths, jpaths, imgs):
        assert p.read_bytes() == png.encode_gray(img) == jp.read_bytes()
    # a file in a folder that does not exist fails; the others are written
    bad = [tmp_path / "b0.png", tmp_path / "missing" / "b1.png", tmp_path / "b2.png"]
    assert not native.write_gray_png_batch(bad, imgs[:3])
    assert bad[0].read_bytes() == png.encode_gray(imgs[0])
    assert bad[2].read_bytes() == png.encode_gray(imgs[2])
    assert not bad[1].exists()
    # a count of paths that is not the count of images is refused before the call
    with pytest.raises(ValueError):
        native.write_gray_png_batch(paths[:2], imgs)
    with pytest.raises(ValueError):
        native.write_gray_png(tmp_path / "x.png", imgs)


@pytest.mark.parametrize("level", [1, 6])
def test_gzip_bytes_round_trips_and_equals_the_jax_packages(level):
    rng = np.random.default_rng(13)
    data = (rng.random(50_000) ** 6 * 255).astype(np.uint8).tobytes()
    got = native.gzip_bytes(data, level)
    assert got == jnative.gzip_bytes(data, level)
    assert gzip.decompress(got) == data
    assert native.gzip_bytes(b"", level) is not None


def test_save_gray_batch_goes_through_the_native_writer(tmp_path, monkeypatch):
    calls = []
    real = native.write_gray_png_batch

    def spy(paths, imgs, *a, **kw):
        calls.append(len(paths))
        return real(paths, imgs, *a, **kw)

    monkeypatch.setattr(native, "write_gray_png_batch", spy)
    imgs = np.random.default_rng(14).integers(0, 256, (4, 10, 12)).astype(np.uint8)
    paths = [tmp_path / "a" / f"{i}.png" for i in range(2)] + [tmp_path / "b" / "2.png",
                                                              tmp_path / "b" / "3.png"]
    png.save_gray_batch(paths, imgs)
    assert calls == [4]
    for p, img in zip(paths, imgs):
        assert p.read_bytes() == png.encode_gray(img)


def test_a_failed_build_warns_once_and_png_writes_the_same_bytes(tmp_path, monkeypatch, caplog):
    """The compiler is made to fail: one warning names its error, and
    ``save_gray``/``save_gray_batch`` write ``encode_gray``'s bytes."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_LIB", tmp_path / "build" / "libhostio.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build_error", "")
    imgs = np.random.default_rng(15).integers(0, 256, (3, 9, 7)).astype(np.uint8)
    with caplog.at_level(logging.WARNING):
        png.save_gray_batch([tmp_path / f"{i}.png" for i in range(3)], imgs)
        png.save_gray(tmp_path / "one.png", imgs[0])
        assert not native.available()
    warned = [r for r in caplog.records if "hostio" in r.getMessage()]
    assert len(warned) == 1 and "no-such-g++" in warned[0].getMessage()
    assert "no-such-g++" in native.build_error
    for i, img in enumerate(imgs):
        assert (tmp_path / f"{i}.png").read_bytes() == png.encode_gray(img)
    assert (tmp_path / "one.png").read_bytes() == png.encode_gray(imgs[0])
    assert not (tmp_path / "build" / "libhostio.so").exists()


def test_a_source_newer_than_the_library_is_rebuilt(tmp_path, monkeypatch):
    lib = tmp_path / "libhostio.so"
    lib.write_bytes(b"stale")
    src = native._SRC.stat().st_mtime
    os.utime(lib, (src - 100, src - 100))
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available()
    assert lib.read_bytes() != b"stale" and lib.stat().st_mtime >= src
