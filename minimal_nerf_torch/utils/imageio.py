"""Image IO: PNG write and animated-GIF write on uint8 ``[H, W, 3]`` arrays.

The port's own copy of ``minimal_nerf_tpu/utils/imageio.py``'s writers.
Uses the ``imageio`` package, else PIL; both are imported at first use, so
a machine without them can still import and render (``render_views``).
Where neither imports, ``mimwrite`` writes the GIF itself (``write_gif``:
numpy and the standard library only); ``imwrite`` still needs one of them.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def _backend():
    try:
        import imageio.v2 as iio

        return "imageio", iio
    except ImportError:
        pass
    try:
        from PIL import Image

        return "pil", Image
    except ImportError:
        return "builtin", None


def imwrite(path: str | Path, image: np.ndarray) -> None:
    """Write a ``[H, W, 3]`` uint8 image (format from the extension)."""
    image = np.asarray(image, dtype=np.uint8)
    kind, mod = _backend()
    if kind == "imageio":
        mod.imwrite(str(path), image)
    elif kind == "pil":
        mod.fromarray(image).save(str(path))
    else:
        raise ImportError("no image backend available for imwrite (need imageio or PIL)")


def mimwrite(path: str | Path, frames: Sequence[np.ndarray], fps: float = 10.0) -> None:
    """Write an animated GIF from uint8 RGB frames (reference ``nerf_helpers.py:187``):
    a frame every ``1000 / fps`` ms, looping forever."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    kind, mod = _backend()
    if kind == "imageio":
        mod.mimwrite(str(path), frames, duration=1000.0 / fps, loop=0)
    elif kind == "pil":
        ims = [mod.fromarray(f) for f in frames]
        ims[0].save(str(path), save_all=True, append_images=ims[1:],
                    duration=int(1000.0 / fps), loop=0)
    else:
        write_gif(path, frames, duration_ms=1000.0 / fps, loop=0)


# ---------------------------------------------------------------- GIF89a

# The quantizer of a frame with more than 256 colors: each channel to the
# nearest level of a 6 x 7 x 6 cube (252 colors, green finest, as the eye
# is most sensitive to it). Levels are round(i * 255 / (n - 1)); a channel
# moves by at most QUANT_MAX_ERR (red, green, blue): half the widest gap
# between two neighbouring levels, rounded down on integer values.
QUANT_LEVELS = (6, 7, 6)
_LEVELS = [np.round(np.arange(n) * 255.0 / (n - 1)).astype(np.int64) for n in QUANT_LEVELS]
QUANT_MAX_ERR = tuple(int(np.diff(lv).max()) // 2 for lv in _LEVELS)  # (25, 21, 25)


def _nearest_level(levels: np.ndarray) -> np.ndarray:
    """For each value 0..255, the index of the nearest level (the lower on a tie)."""
    v = np.arange(256)[:, None]
    return np.abs(v - levels[None, :]).argmin(axis=1)


_NEAREST = [_nearest_level(lv) for lv in _LEVELS]


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(indices [H, W] uint8, palette [n, 3] uint8)`` of an RGB frame.

    Exact when the frame has at most 256 colors (its own colors, in
    ascending order of ``r << 16 | g << 8 | b``); otherwise each pixel takes
    the nearest color of the 6 x 7 x 6 cube, off by at most
    ``QUANT_MAX_ERR`` = (25, 21, 25) in (red, green, blue).
    """
    rgb = frame.reshape(-1, 3).astype(np.int64)
    key = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    colors, inverse = np.unique(key, return_inverse=True)
    if colors.size <= 256:
        palette = np.stack([(colors >> 16) & 255, (colors >> 8) & 255, colors & 255], axis=1)
        return inverse.reshape(frame.shape[:2]).astype(np.uint8), palette.astype(np.uint8)
    nr, ng, nb = QUANT_LEVELS
    ir, ig, ib = (_NEAREST[c][rgb[:, c]] for c in range(3))
    idx = (ir * ng + ig) * nb + ib
    grid = np.stack(np.meshgrid(*_LEVELS, indexing="ij"), axis=-1).reshape(-1, 3)
    return idx.reshape(frame.shape[:2]).astype(np.uint8), grid.astype(np.uint8)


def lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF's variable-length LZW of a sequence of color indices: a clear
    code first, codes of ``min_code_size + 1`` bits growing by one bit when
    the next code would not fit, up to 12 bits; a full table (4096 codes)
    emits a clear code and starts again at the initial size; the
    end-of-information code last. Bits are packed least significant first."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    size = min_code_size + 1
    emit(clear, size)
    table: dict = {}
    next_code = eoi + 1
    data = indices.reshape(-1).tolist()
    if not data:
        emit(eoi, size)
        if nbits:
            out.append(acc & 255)
        return bytes(out)
    prefix = data[0]
    for k in data[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix, size)
        if next_code == 4096:
            emit(clear, size)
            table.clear()
            next_code, size = eoi + 1, min_code_size + 1
        else:
            table[key] = next_code
            # the decoder adds this entry one code later, so the width grows
            # once the code just added no longer fits
            if next_code == (1 << size) and size < 12:
                size += 1
            next_code += 1
        prefix = k
    emit(prefix, size)
    emit(eoi, size)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    """Data as GIF sub-blocks of at most 255 bytes, then the terminator."""
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def _le16(v: int) -> bytes:
    return int(v).to_bytes(2, "little")


def write_gif(path: str | Path, frames: Sequence[np.ndarray], duration_ms: float = 100.0,
              loop: int = 0) -> None:
    """Write uint8 RGB frames ``[H, W, 3]`` (one size) as an animated GIF89a.

    Each frame carries its own color table (``quantize``: exact up to 256
    colors), a graphic control extension with its delay (``duration_ms``
    rounded to hundredths of a second) and LZW-coded pixels; a NETSCAPE2.0
    block sets the loop count (0: forever).
    """
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames to write")
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) for f in frames):
        raise ValueError("every frame must be [H, W, 3] of one size")
    delay = max(0, int(round(duration_ms / 10.0)))
    parts: List[bytes] = [b"GIF89a", _le16(w), _le16(h), b"\x00\x00\x00",
                          b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + _le16(loop) + b"\x00"]
    for f in frames:
        idx, pal = quantize(f)
        bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))  # table of 2^bits colors
        table = np.zeros((1 << bits, 3), dtype=np.uint8)
        table[: len(pal)] = pal
        parts += [b"\x21\xf9\x04\x04" + _le16(delay) + b"\x00\x00",  # disposal 1: keep
                  b"\x2c" + _le16(0) + _le16(0) + _le16(w) + _le16(h) + bytes([0x80 | (bits - 1)]),
                  table.tobytes()]
        min_code_size = max(2, bits)
        parts += [bytes([min_code_size]), _sub_blocks(lzw_encode(idx, min_code_size))]
    parts.append(b"\x3b")
    Path(path).write_bytes(b"".join(parts))
