"""PNG round trips through the stdlib encoder/decoder (io/png.py)."""

import zlib

import numpy as np
import pytest

from pegasus_tpu.io import png


@pytest.mark.parametrize(
    "shape,dtype",
    [((7, 5), np.uint8), ((6, 9, 3), np.uint8), ((5, 4), np.uint16)],
    ids=["gray8", "rgb8", "gray16"],
)
def test_stdlib_png_round_trip(tmp_path, shape, dtype):
    rng = np.random.default_rng(1)
    img = rng.integers(0, np.iinfo(dtype).max + 1, size=shape).astype(dtype)
    path = tmp_path / "x.png"
    path.write_bytes(png.encode_png(img))
    back = png.read_png(path)
    assert back.dtype == dtype and back.shape == shape
    np.testing.assert_array_equal(back, img)
    # write_png (native encoder where it builds) decodes identically
    png.write_png(tmp_path / "y.png", img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "y.png"), img)


def test_read_png_undoes_scanline_filters(tmp_path):
    """Rows written with the Sub, Up, Average and Paeth filters (as other
    encoders emit) decode to the original pixels."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(4, 6, 3)).astype(np.uint8)
    bpp, stride = 3, 18
    rows = img.reshape(4, stride).astype(np.int64)
    raw, prev = [], np.zeros(stride, np.int64)
    for y, ftype in enumerate((1, 2, 3, 4)):
        line = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where(
                (pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft)
            )
        raw.append(np.concatenate([[ftype], (line - pred) % 256]))
        prev = line
    data = np.stack(raw).astype(np.uint8).tobytes()
    blob = bytearray(png.encode_png(img))
    # swap the unfiltered IDAT for the filtered one
    start = blob.index(b"IDAT") - 4
    end = blob.index(b"IEND") - 4
    path = tmp_path / "f.png"
    path.write_bytes(
        bytes(blob[:start]) + png._chunk(b"IDAT", zlib.compress(data))
        + bytes(blob[end:])
    )
    np.testing.assert_array_equal(png.read_png(path), img)
