"""Image IO: PNG read and write, animated-GIF write, on uint8 arrays.

The port's own copy of ``minimal_nerf_tpu/utils/imageio.py``. PNG files are
read and written by the port itself (``imread``, ``encode_png``: ``zlib``,
``struct`` and numpy), whatever image packages are installed, so a machine
without imageio or PIL loads and writes scenes and the card and the CPU
write the same bytes. Other formats go through the ``imageio`` package, else
PIL, imported at first use; where neither imports, ``mimwrite`` writes the
GIF itself (``write_gif``).
"""

from __future__ import annotations

import struct
import zlib
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


# ----------------------------------------------------------------- PNG

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels: gray, RGB, gray + alpha, RGBA (3, palette, is not
# supported)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
PNG_FILTERS = ("none", "sub", "up", "average", "paeth")


def png_chunk(kind: bytes, data: bytes) -> bytes:
    """One chunk: length, type, data, CRC-32 of type and data."""
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int arrays: of left, up and upper-left, the
    one nearest ``a + b - c`` (ties in that order)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(image: np.ndarray, filter_type: int = 2, level: int = 6) -> bytes:
    """An 8-bit, non-interlaced PNG of ``image``: ``[H, W]`` gray or
    ``[H, W, C]`` with C = 1 (gray), 2 (gray + alpha), 3 (RGB) or 4 (RGBA),
    every row under the filter ``filter_type`` (an index of
    ``PNG_FILTERS``), the data deflated at ``level``."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoder takes uint8 images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) or 0 in img.shape:
        raise ValueError(f"PNG encoder takes [H, W] or [H, W, 1..4] images, got {img.shape}")
    if filter_type not in range(len(PNG_FILTERS)):
        raise ValueError(f"PNG filter type must be 0..4, got {filter_type}")
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    x = img.astype(np.int32)
    # the filters predict from the unfiltered bytes: left, up, upper-left
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    pred = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, cc)][filter_type]
    rows = ((x - pred) & 0xFF).astype(np.uint8).reshape(h, w * c)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (PNG_SIGNATURE + png_chunk(b"IHDR", ihdr)
            + png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + png_chunk(b"IEND", b""))


def _png_chunks(data: bytes):
    """``(type, payload)`` of every chunk, each CRC checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + payload) & 0xFFFFFFFF:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file has no IEND chunk")


def _unfilter_rows(f: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo None, Sub and Up rows, one row at a time (each is a running sum
    along the row or the sum with the row above, mod 256)."""
    out = np.empty_like(f)
    prev = np.zeros_like(f[0])
    for y, t in enumerate(types):
        if t == 0:
            out[y] = f[y]
        elif t == 1:
            out[y] = np.cumsum(f[y], axis=0, dtype=np.uint8)
        else:
            out[y] = f[y] + prev
        prev = out[y]
    return out


def _unfilter_wavefront(f: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Undo any mix of the five filters. A pixel depends on its left, upper
    and upper-left neighbours, all on earlier anti-diagonals, so each
    anti-diagonal of pixels is reconstructed at once."""
    h, w, c = f.shape
    r = np.zeros((h + 1, w + 1, c), np.int32)  # a zero row above, a zero column left
    fi = f.astype(np.int32)
    for k in range(h + w - 1):
        ys = np.arange(max(0, k - w + 1), min(h, k + 1))
        xs = k - ys
        a, b, cc = r[ys + 1, xs], r[ys, xs + 1], r[ys, xs]
        t = types[ys][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, _paeth(a, b, cc), 0))))
        r[ys + 1, xs + 1] = (fi[ys, xs] + pred) & 0xFF
    return r[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """``[H, W, C]`` uint8 of an 8-bit, non-interlaced gray, gray + alpha,
    RGB or RGBA PNG (C = 1, 2, 3, 4). Anything else (another bit depth, a
    palette, interlacing, a bad CRC, corrupt data) raises ``ValueError``
    naming it."""
    header, idat = None, []
    for kind, payload in _png_chunks(data):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise ValueError("bad PNG IHDR chunk")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("PNG file lacks an IHDR or IDAT chunk")
    w, h, depth, color_type, compression, filter_method, interlace = header
    if color_type not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG: color type {color_type}"
                         + (" (palette)" if color_type == 3 else ""))
    if depth != 8:
        raise ValueError(f"unsupported PNG: bit depth {depth} (only 8 is supported)")
    if interlace != 0:
        raise ValueError("unsupported PNG: interlaced (Adam7)")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"unsupported PNG: compression method {compression}, "
                         f"filter method {filter_method}")
    c = _PNG_CHANNELS[color_type]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) != h * (1 + w * c):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, want {h * (1 + w * c)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    types = rows[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(types.max())}")
    f = rows[:, 1:].reshape(h, w, c)
    if types.max(initial=0) <= 2:
        return _unfilter_rows(f, types)
    return _unfilter_wavefront(f, types)


def imread(path: str | Path) -> np.ndarray:
    """Read a PNG as ``[H, W, 3]`` uint8 RGB, as ``imageio.imread(mode="RGB")``
    and PIL's ``convert("RGB")`` do: alpha is dropped (not composited) and
    gray is repeated over the three channels."""
    img = decode_png(Path(path).read_bytes())
    c = img.shape[2]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imwrite(path: str | Path, image: np.ndarray) -> None:
    """Write a ``[H, W, 3]`` uint8 image (format from the extension; a
    ``.png`` through ``encode_png`` with the Up filter)."""
    image = np.asarray(image, dtype=np.uint8)
    if Path(path).suffix.lower() == ".png":
        Path(path).write_bytes(encode_png(image))
        return
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
