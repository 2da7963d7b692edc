"""Minimal PNG decoder (standard library + numpy) for the map assets.

Decodes 8-bit, non-interlaced greyscale, RGB and RGBA images — the formats of
the bundled occupancy maps — and rejects anything else.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _unfilter_row(ftype: int, row: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ftype == 0:
        return row
    if ftype == 2:
        return row + prev  # uint8 wraps mod 256
    if ftype == 1:
        # Recon(x) = Filt(x) + Recon(x - bpp): a per-channel running sum
        px = row.reshape(-1, bpp).astype(np.uint64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    if ftype == 3:
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    elif ftype == 4:
        for i in range(len(out)):
            a = out[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f"invalid PNG filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png(file_path: str) -> np.ndarray:
    """Decode a PNG file to a ``(H, W)`` or ``(H, W, C)`` uint8 array."""
    with open(file_path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{file_path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{file_path}: missing IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{file_path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace})")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, stride + 1)
    img = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        prev = img[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    img = img.reshape(height, width, bpp)
    return img[..., 0] if bpp == 1 else img
