"""A PNG reader and writer over the standard library's `zlib` and `struct`.

The recorded demos keep their ground-truth views as 8-bit PNGs. The JAX
package reads and writes them through PIL; the port does not depend on it.
What this codec covers:
  read:  8-bit gray, gray + alpha, RGB and RGBA, not interlaced, every
         scanline filter (None, Sub, Up, Average, Paeth); ancillary chunks
         are skipped, palette images and other bit depths are refused;
  write: 8-bit gray, RGB or RGBA, every scanline with filter None, and
         optional tEXt chunks (`read_png_text` reads them back).
`read_png_rgb` gives what PIL's `Image.open(path).convert("RGB")` gives for
these images: gray is repeated into three channels, alpha is dropped.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Mapping, Optional

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, compress_level: int = 6,
              text: Optional[Mapping[str, str]] = None) -> None:
    """Write an (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 image;
    `text` as tEXt chunks (Latin-1 keywords of 1-79 characters)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    raw = np.zeros((h, 1 + w * c), np.uint8)       # filter byte 0 on every row
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    texts = b""
    for key, value in (text or {}).items():
        if not 1 <= len(key) <= 79:
            raise ValueError(f"PNG text keyword {key!r} must have 1-79 characters")
        texts += _chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr) + texts
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level))
                + _chunk(b"IEND", b""))


def read_png_text(path: str) -> Dict[str, str]:
    """The tEXt chunks of a PNG file, keyword -> text."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    out, pos = {}, 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            out[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IEND":
            break
    return out


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: (H, W * bpp) uint8."""
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:   # Sub: a running sum along each byte lane of a pixel
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint64) % 256
                   ).astype(np.uint8).reshape(stride)
        elif ftype == 2:   # Up
            cur = line + prior
        elif ftype in (3, 4):   # Average, Paeth: sequential along the row
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels, C the file's channels (1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNGs are not supported")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, method, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit gray/gray-alpha/RGB/RGBA PNGs are "
                         f"supported (bit depth {depth}, colour type {ctype})")
    if method != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: interlaced or non-standard PNGs are not supported")
    c = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, c).reshape(h, w, c)


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's convert("RGB") gives it for these images."""
    img = read_png(path)
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]
