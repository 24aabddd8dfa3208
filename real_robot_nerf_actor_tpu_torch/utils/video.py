"""Episode video recording (the port's counterpart of the JAX package's
`utils/video.py`, reference src/video.py VideoRecorder).

Frames are collected as numpy RGB and written as an animated GIF89a by the
writer below (the port needs no PIL, as `data/png.py` writes PNG without
it): a NETSCAPE2.0 loop extension, a graphic control extension with the
frame delay, and each frame's own 256-entry palette, LZW-coded. A frame of
at most 256 colours keeps them exactly; a frame of more is reduced by a
median cut (the palette differs from PIL's, so the pixels do too).
`save_frames_npz` keeps the raw array, as in JAX.
"""
from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _median_cut(pixels: np.ndarray, n_colors: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """(palette (n, 3) uint8, index per pixel): boxes of pixels split at the
    median of their widest channel until there are n_colors, each box
    coloured by its mean."""
    def span(b):
        return np.ptp(pixels[b], axis=0) if b.size > 1 else np.full(3, -1)

    boxes = [np.arange(pixels.shape[0])]
    spans = [span(boxes[0])]
    while len(boxes) < n_colors:
        i = int(np.argmax([sp.max() for sp in spans]))
        if spans[i].max() <= 0:
            break
        b, sp = boxes.pop(i), spans.pop(i)
        order = b[np.argsort(pixels[b, int(np.argmax(sp))], kind="stable")]
        half = order.size // 2
        for part in (order[:half], order[half:]):
            boxes.append(part)
            spans.append(span(part))
    palette = np.zeros((len(boxes), 3), np.uint8)
    index = np.zeros(pixels.shape[0], np.int64)
    for k, b in enumerate(boxes):
        palette[k] = np.round(pixels[b].mean(axis=0))
        index[b] = k
    return palette, index


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(palette (256, 3) uint8, indices (H, W) uint8) of an (H, W, 3) uint8
    frame: its own colours where there are at most 256, else a median cut."""
    flat = frame.reshape(-1, 3)
    colors, inverse = np.unique(flat, axis=0, return_inverse=True)
    if colors.shape[0] <= 256:
        palette, index = colors.astype(np.uint8), inverse.reshape(-1)
    else:
        palette, index = _median_cut(flat.astype(np.int64))
    full = np.zeros((256, 3), np.uint8)
    full[:palette.shape[0]] = palette
    return full, index.astype(np.uint8).reshape(frame.shape[:2])


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF LZW of a flat run of palette indices: variable-width codes up to
    12 bits, LSB first, a clear code first and whenever the table fills, an
    end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = indices.tobytes()
    width, next_code, table = min_code_size + 1, end + 1, {}
    emit(clear, width)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        table[key] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        if next_code == 4096:   # full: start a new table
            emit(clear, width)
            width, next_code, table = min_code_size + 1, end + 1, {}
        prefix = k
    emit(prefix, width)
    # the decoder adds one more entry on reading that last code
    if next_code + 1 > (1 << width) and width < 12:
        width += 1
    emit(end, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    chunks = [data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(bytes([len(c)]) + c for c in chunks) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int, loop: int = 0
              ) -> None:
    """An animated GIF89a of uint8 (H, W, 3) frames: each shown duration_ms
    (stored in hundredths, rounded down as PIL stores it), looping `loop`
    times (0: forever)."""
    h, w = frames[0].shape[:2]
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0, 0, 0)   # no global colour table
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    delay = duration_ms // 10
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError(f"frame of {f.shape[:2]}, the first is {(h, w)}")
        palette, idx = quantize(f)
        out += b"\x21\xf9\x04" + struct.pack("<BHB", 0x04, delay, 0) + b"\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87)   # local table, 256
        out += palette.tobytes()
        out += b"\x08" + _sub_blocks(lzw_encode(idx.reshape(-1)))
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def to_uint8(frame: np.ndarray) -> np.ndarray:
    """A frame as uint8 RGB: float frames are clipped to [0, 1] and scaled,
    as the JAX recorder converts them."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    return frame


class VideoRecorder:
    def __init__(self, save_dir: Optional[str], fps: int = 15, enabled: bool = True):
        self.save_dir = save_dir
        self.fps = fps
        self.enabled = enabled and save_dir is not None
        self.frames: List[np.ndarray] = []
        if self.enabled:
            os.makedirs(save_dir, exist_ok=True)

    def init(self, env=None):
        self.frames = []
        if env is not None:
            self.record(env)

    def record(self, env):
        if not self.enabled:
            return
        frame = env.render()
        if frame is not None:
            self.frames.append(np.asarray(frame))

    def record_frame(self, frame: np.ndarray):
        if self.enabled:
            self.frames.append(np.asarray(frame))

    def save(self, name: str) -> Optional[str]:
        if not self.enabled or not self.frames:
            return None
        path = os.path.join(self.save_dir, name if name.endswith(".gif") else name + ".gif")
        write_gif(path, [to_uint8(f) for f in self.frames], int(1000 / self.fps), loop=0)
        return path

    def save_frames_npz(self, name: str) -> Optional[str]:
        if not self.enabled or not self.frames:
            return None
        path = os.path.join(self.save_dir, name + ".npz")
        np.savez_compressed(path, frames=np.stack(self.frames))
        return path
