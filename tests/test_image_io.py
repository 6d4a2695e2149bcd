"""Image readers + diff stats (render/image.py): PPM P3/P6 and PNG
round-trips, and the `cli compare` gate math.

The PPM reader exists so a reference binary's stdout [E: main.cpp P3
output] can be diffed directly against our renders — the pixel-allclose
gate's tooling [BASELINE.json:2]."""
import subprocess
import sys

import numpy as np

from first_raytracer.render.image import (image_diff_stats, read_image,
                                          read_png, read_ppm, to_uint8,
                                          write_png, write_ppm)


def _gradient(ny=13, nx=17):
    y, x = np.mgrid[0:ny, 0:nx]
    img = np.stack([x / nx, y / ny, (x + y) / (nx + ny)], -1)
    return img.astype(np.float32)


def test_ppm_roundtrip(tmp_path):
    img = _gradient()
    p = tmp_path / "a.ppm"
    write_ppm(p, img)
    back = read_ppm(p)
    np.testing.assert_array_equal(back, to_uint8(img))


def test_ppm_p6_and_comments(tmp_path):
    q = to_uint8(_gradient())
    p = tmp_path / "a.ppm"
    with open(p, "wb") as f:
        f.write(b"P6\n# a comment\n%d %d\n255\n" % (q.shape[1], q.shape[0]))
        f.write(q.tobytes())
    np.testing.assert_array_equal(read_ppm(p), q)


def test_png_roundtrip(tmp_path):
    img = _gradient()
    p = tmp_path / "a.png"
    write_png(p, img)
    np.testing.assert_array_equal(read_png(p), to_uint8(img))


def test_png_reader_handles_all_filters(tmp_path):
    # our writer emits filter 0 only; synthesize rows with filters 1-4.
    import struct
    import zlib

    rng = np.random.RandomState(0)
    q = rng.randint(0, 256, (6, 8, 3), dtype=np.uint8)
    stride = 8 * 3
    raws = []
    prev = np.zeros(stride, np.int64)
    for y, ft in enumerate([0, 1, 2, 3, 4, 1]):
        row = q[y].reshape(-1).astype(np.int64)
        enc = np.zeros(stride, np.int64)
        for x in range(stride):
            a = row[x - 3] if x >= 3 else 0
            b = prev[x]
            c = prev[x - 3] if x >= 3 else 0
            if ft == 0:
                p = 0
            elif ft == 1:
                p = a
            elif ft == 2:
                p = b
            elif ft == 3:
                p = (a + b) // 2
            else:
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                p = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            enc[x] = (row[x] - p) & 0xFF
        raws.append(bytes([ft]) + bytes(enc.astype(np.uint8)))
        prev = row

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    p = tmp_path / "f.png"
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 6, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(raws))))
        f.write(chunk(b"IEND", b""))
    np.testing.assert_array_equal(read_png(p), q)


def test_diff_stats_and_compare_cli(tmp_path):
    img = _gradient()
    a, b = tmp_path / "a.png", tmp_path / "b.ppm"
    write_png(a, img)
    write_ppm(b, img)
    stats = image_diff_stats(read_image(str(a)), read_image(str(b)))
    assert stats["max_abs"] == 0.0 and stats["psnr_db"] == float("inf")

    img2 = img.copy()
    img2[0, 0] = 1.0
    c = tmp_path / "c.png"
    write_png(c, img2)
    stats = image_diff_stats(read_image(str(a)), read_image(str(c)))
    assert stats["max_abs"] > 4 and 0 < stats["frac_pixels_gt_4"] < 0.02

    from first_raytracer.cli import main
    assert main(["compare", str(a), str(b), "--max-frac-gt-4", "0.0"]) in (
        0, None)
    assert main(["compare", str(a), str(c), "--max-frac-gt-4", "0.0"]) == 1
