"""A small PNG decoder (standard library `zlib` and numpy), so the port reads frames
without cv2, and an encoder for test data (`write_png`, no row filter).

It takes what the TTHQ frames are: 8 bits per sample, no interlacing, colour types 0
(grey), 2 (RGB) and 6 (RGBA), and raises on anything else. All five row filters are
undone. None, Sub and Up could be undone a row at a time, but Average and Paeth are
recurrences along the row (each byte needs its reconstructed left neighbour), so the
decoder walks the image's anti-diagonals instead: every pixel of one anti-diagonal
depends only on pixels of the two before it, so one step undoes a whole anti-diagonal
(H + W - 1 numpy steps per image, whatever the filters).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_png", "write_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter(rows: np.ndarray, ftype: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters. rows (H, W, bpp) uint8 filtered bytes, ftype (H,) -> (H, W, bpp).

    The image is held skewed, one anti-diagonal per row: pixel (r, i) lives at
    S[r + i + 2, r + 1], so the anti-diagonal r + i = d is S[d + 2], its left neighbours
    (r, i - 1) are S[d + 1] at the same r, its upper ones (r - 1, i) S[d + 1] at r - 1,
    and the upper-left ones S[d] at r - 1. S[:, 0] and S[:2] are the zero border the
    filters read outside the image.
    """
    H, W, _ = rows.shape
    r_idx = np.arange(H)[:, None]
    diag = r_idx + np.arange(W)[None, :]  # d = r + i
    raw = np.zeros((H + W - 1, H, bpp), np.int16)
    raw[diag, r_idx] = rows
    S = np.zeros((H + W + 1, H + 1, bpp), np.int16)
    # one 0/1 weight per row and filter: pred = sub*a + up*b + avg*(a+b)//2 + paeth*paeth
    sub, up, avg, pae = ((ftype == k).astype(np.int16)[:, None] for k in (1, 2, 3, 4))
    for d in range(H + W - 1):
        r0, r1 = max(0, d - W + 1), min(H, d + 1)
        a = S[d + 1, r0 + 1:r1 + 1]
        b = S[d + 1, r0:r1]
        c = S[d, r0:r1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)  # |p - a|, ...
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = sub[r0:r1] * a + up[r0:r1] * b + avg[r0:r1] * ((a + b) >> 1) + pae[r0:r1] * paeth
        S[d + 2, r0 + 1:r1 + 1] = (raw[d, r0:r1] + pred) & 0xFF
    return S[diag + 2, r_idx + 1].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(path, img: np.ndarray, text=None) -> None:
    """Write (H, W) or (H, W, 1/3/4) uint8 as an 8-bit PNG (no row filter); `text`, a dict
    of Latin-1 keyword -> value, goes into tEXt chunks (e.g. {"Title": ...})."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, bpp = img.shape
    colour = {1: 0, 3: 2, 4: 6}[bpp]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * bpp)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0, 0))
                + b"".join(_chunk(b"tEXt", k.encode("latin-1") + b"\0" + v.encode("latin-1"))
                           for k, v in (text or {}).items())
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """(H, W, channels) uint8 of an 8-bit, non-interlaced grey, RGB or RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}); this reader takes 8-bit, non-interlaced "
                         f"grey, RGB or RGBA")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = width * bpp + 1
    if raw.size != height * stride:
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {height * stride}")
    raw = raw.reshape(height, stride)
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    rows = raw[:, 1:].reshape(height, width, bpp)
    if not ftype.any():  # no row filter (as write_png writes): the bytes are the pixels
        return rows.copy()
    return _unfilter(rows, ftype, bpp)
