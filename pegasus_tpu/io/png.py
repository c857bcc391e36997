"""PNG writing and reading: native zlib encoder, stdlib-zlib fallback.

``write_png`` loads the C++ encoder (csrc/pngio.cpp) via ctypes, building
it with ``make`` from the committed sources on first use if the shared
object is missing.  The native path releases the GIL for the entire
encode+write, so the dataset writer's thread pool parallelizes across
cores.  Where it cannot build (no compiler or no ``zlib.h``), the encoder
below, built on the standard library's ``zlib``, writes the same images.

``read_png`` decodes the 8-bit gray/RGB/RGBA and 16-bit gray PNGs this
package writes (any scanline filter), with the standard library alone.
"""

from __future__ import annotations

import ctypes
import struct
import subprocess
import zlib
from pathlib import Path

import numpy as np

_LIB = None
_LIB_FAILED = False
_SRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
_SO_PATH = _SRC_DIR / "libpegasus_pngio.so"

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG color type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}


def _load_native():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    try:
        if not _SO_PATH.exists():
            subprocess.run(
                ["make", "-C", str(_SRC_DIR)],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(_SO_PATH))
        lib.png_write_file.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.png_write_file.restype = ctypes.c_int
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB_FAILED = True
    return _LIB


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray, compression: int = 4) -> bytes:
    """PNG bytes of a [H, W] / [H, W, C] uint8 or [H, W] uint16 image
    (scanline filter 0, as the native encoder writes)."""
    h, w = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    bit_depth = 16 if image.dtype == np.uint16 else 8
    rows = image.astype(">u2" if bit_depth == 16 else np.uint8)
    rows = rows.reshape(h, -1).view(np.uint8)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows
    ihdr = struct.pack(
        ">IIBBBBB", w, h, bit_depth, _COLOR_TYPE[channels], 0, 0, 0
    )
    return b"".join([
        _SIGNATURE,
        _chunk(b"IHDR", ihdr),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), compression)),
        _chunk(b"IEND", b""),
    ])


def write_png(path, image: np.ndarray, compression: int = 4) -> None:
    """Write uint8 gray/RGB/RGBA or uint16 gray PNGs."""
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        channels = 1
    elif image.ndim == 3 and image.shape[2] in (1, 3, 4):
        channels = image.shape[2]
        if channels == 1:
            image = image[:, :, 0]
    else:
        raise ValueError(f"unsupported image shape {image.shape}")

    if image.dtype == np.uint8:
        bit_depth = 8
    elif image.dtype == np.uint16:
        bit_depth = 16
        if channels != 1:
            raise ValueError("16-bit PNGs are single-channel (BOP depth)")
    else:
        raise ValueError(f"unsupported dtype {image.dtype}")

    lib = _load_native()
    if lib is not None:
        h, w = image.shape[:2]
        buf = image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = lib.png_write_file(
            str(path).encode(), buf, w, h, channels, bit_depth, compression
        )
        if rc == 0:
            return
        # fall through on any native error

    Path(path).write_bytes(encode_png(image, compression))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters: data is [h, 1 + stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(data[y, 0]), data[y, 1:].copy()
        if ftype == 1:  # Sub
            for x in range(bpp, stride):
                line[x] = (int(line[x]) + int(line[x - bpp])) & 0xFF
        elif ftype == 2:  # Up
            line += prev
        elif ftype == 3:  # Average
            for x in range(stride):
                left = int(line[x - bpp]) if x >= bpp else 0
                line[x] = (int(line[x]) + (left + int(prev[x])) // 2) & 0xFF
        elif ftype == 4:  # Paeth
            for x in range(stride):
                a = int(line[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                c = int(prev[x - bpp]) if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = line
    return out


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8-bit gray/RGB/RGBA or 16-bit gray PNG to
    [H, W] / [H, W, C] uint8 or [H, W] uint16."""
    blob = Path(path).read_bytes()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, bit_depth, color_type, _, _, interlace = header
    if interlace or color_type not in _CHANNELS or bit_depth not in (8, 16):
        raise ValueError(
            f"{path}: unsupported PNG (depth {bit_depth}, color type "
            f"{color_type}, interlace {interlace})"
        )
    channels = _CHANNELS[color_type]
    bpp = channels * bit_depth // 8
    stride = w * bpp
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    data = data.reshape(h, stride + 1)
    if np.any(data[:, 0]):
        rows = _unfilter(data, h, stride, bpp)
    else:
        rows = data[:, 1:]
    rows = np.ascontiguousarray(rows)
    img = rows.view(">u2").astype(np.uint16) if bit_depth == 16 else rows
    img = img.reshape(h, w, channels)
    return np.ascontiguousarray(img[..., 0] if channels == 1 else img)
