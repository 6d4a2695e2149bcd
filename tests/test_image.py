"""Image output tests: gamma, quantization, PPM text format, PNG container."""
import struct
import zlib

import numpy as np

from first_raytracer.render.image import (gamma_correct, to_uint8,
                                          write_png, write_ppm)


def test_gamma_is_sqrt():
    img = np.array([[[0.25, 1.0, 0.0]]], np.float32)
    np.testing.assert_allclose(gamma_correct(img)[0, 0], [0.5, 1.0, 0.0])


def test_to_uint8_matches_reference_formula():
    # int(255.99 * sqrt(c)) [E: main.cpp]
    img = np.array([[[0.25, 1.0, 0.0]]], np.float32)
    assert to_uint8(img)[0, 0].tolist() == [127, 255, 0]
    # Out-of-range values are clipped, not wrapped.
    img = np.array([[[2.0, -1.0, 0.5]]], np.float32)
    q = to_uint8(img)[0, 0]
    assert q[0] == 255 and q[1] == 0


def test_write_ppm(tmp_path):
    img = np.random.RandomState(0).rand(4, 6, 3).astype(np.float32)
    path = tmp_path / "t.ppm"
    write_ppm(path, img)
    lines = path.read_text().split()
    assert lines[0] == "P3" and lines[1] == "6" and lines[2] == "4"
    assert lines[3] == "255"
    vals = np.array(lines[4:], int).reshape(4, 6, 3)
    np.testing.assert_array_equal(vals, to_uint8(img))


def test_write_png_roundtrip(tmp_path):
    img = np.random.RandomState(1).rand(5, 7, 3).astype(np.float32)
    path = tmp_path / "t.png"
    write_png(path, img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # Parse IHDR.
    assert data[12:16] == b"IHDR"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (7, 5)
    # Decode IDAT scanlines and compare.
    idat_len = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * 3)
    assert np.all(rows[:, 0] == 0)  # filter type none
    np.testing.assert_array_equal(
        rows[:, 1:].reshape(5, 7, 3), to_uint8(img))
