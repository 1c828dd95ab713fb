"""The port's own GIF writer (``minimal_nerf_torch/utils/imageio.py``),
decoded with PIL: exact frames up to 256 colors, the stated quantizer error
beyond, the delay and loop blocks, and the render CLI with no image
package importable. ``chip_smoke.py``'s block walker is held against the
same files. The port's PNG reader and writer against PIL: every colour
type under every row filter, PIL's own files, and the features it refuses."""

import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from minimal_nerf_torch import render as t_render
from minimal_nerf_torch.models import nerf as t_nerf
from minimal_nerf_torch.training import checkpoint as t_ckpt
from minimal_nerf_torch.training.config import TrainConfig
from minimal_nerf_torch.utils import imageio as mio


def _decode(path):
    """Every frame of a GIF as uint8 RGB, and the file's info per frame."""
    frames, infos = [], []
    with Image.open(path) as im:
        for i in range(im.n_frames):
            im.seek(i)
            frames.append(np.asarray(im.convert("RGB")))
            infos.append(dict(im.info))
    return frames, infos


def _paletted(rng, n_colors, n_frames, h, w):
    """Frames drawing each pixel from ``n_colors`` random colors."""
    out = []
    for _ in range(n_frames):
        colors = rng.integers(0, 256, size=(n_colors, 3), dtype=np.uint8)
        out.append(colors[rng.integers(0, n_colors, size=(h, w))])
    return out


@pytest.fixture
def builtin(monkeypatch):
    """``mimwrite`` as on a machine with neither imageio nor PIL."""
    monkeypatch.setattr(mio, "_backend", lambda: ("builtin", None))


@pytest.mark.parametrize("n_colors,n_frames,h,w,fps,loop", [
    (1, 1, 7, 5, 10.0, 0),        # one color: the smallest table (2 entries)
    (2, 3, 16, 24, 25.0, 0),
    (5, 2, 33, 1, 4.0, 3),        # one column, a loop count
    (256, 2, 40, 40, 10.0, 0),    # the largest exact palette
    (256, 1, 300, 300, 2.0, 1),   # 90,000 pixels: LZW table resets at 4,096 codes
])
def test_gif_frames_with_few_colors_read_back_identical(tmp_path, builtin, n_colors, n_frames,
                                                        h, w, fps, loop):
    frames = _paletted(np.random.default_rng(n_colors * 7 + n_frames), n_colors, n_frames, h, w)
    path = tmp_path / "a.gif"
    if loop:
        mio.write_gif(path, frames, duration_ms=1000.0 / fps, loop=loop)
    else:
        mio.mimwrite(path, frames, fps=fps)
    got, infos = _decode(path)
    assert len(got) == n_frames
    for a, b in zip(got, frames):
        np.testing.assert_array_equal(a, b)
    assert all(info["duration"] == round(100.0 / fps) * 10 for info in infos)
    assert infos[0]["loop"] == loop


def test_gif_frame_with_many_colors_within_the_quantizer_error(tmp_path, builtin):
    """A frame of 64k colors (every red/green pair, a blue ramp) reads back
    within QUANT_MAX_ERR per channel, and the bound is reached."""
    r, g = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    frame = np.stack([r, g, (r + g) % 256], axis=-1).astype(np.uint8)
    path = tmp_path / "q.gif"
    mio.mimwrite(path, [frame, frame[::-1]])
    got, _ = _decode(path)
    for a, b in zip(got, (frame, frame[::-1])):
        err = np.abs(a.astype(int) - b.astype(int)).reshape(-1, 3).max(axis=0)
        assert tuple(err) == mio.QUANT_MAX_ERR == (25, 21, 25)
    # the cube's 252 colors, each index into them
    idx, pal = mio.quantize(frame)
    assert len(pal) == 6 * 7 * 6 and idx.max() < 252


def test_lzw_matches_pil_decoding_of_a_long_run(tmp_path, builtin):
    """Long runs grow codes to 12 bits fastest; a constant frame and one
    alternating in long stripes decode exactly."""
    flat = np.zeros((512, 512, 3), dtype=np.uint8)
    stripes = np.zeros((512, 512, 3), dtype=np.uint8)
    stripes[:, ::37] = (255, 0, 7)
    path = tmp_path / "l.gif"
    mio.mimwrite(path, [flat, stripes])
    got, _ = _decode(path)
    np.testing.assert_array_equal(got[0], flat)
    np.testing.assert_array_equal(got[1], stripes)


def test_backend_falls_back_to_the_builtin_writer(monkeypatch, tmp_path):
    """Without imageio and PIL a PNG is still written (by the port's own
    encoder); another format raises."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert mio._backend() == ("builtin", None)
    image = np.arange(12, dtype=np.uint8).reshape(2, 2, 3)
    mio.imwrite(tmp_path / "x.png", image)
    np.testing.assert_array_equal(mio.imread(tmp_path / "x.png"), image)
    with pytest.raises(ImportError):
        mio.imwrite(tmp_path / "x.jpg", image)


def test_gif_walker_reads_both_writers(tmp_path, builtin):
    """``chip_smoke.gif_blocks`` finds the header, screen size, one image
    per frame, delays, loop and trailer in the builtin writer's file and in
    PIL's."""
    frames = _paletted(np.random.default_rng(3), 300, 3, 20, 30)
    ours = tmp_path / "ours.gif"
    mio.mimwrite(ours, frames, fps=10.0)
    theirs = tmp_path / "pil.gif"
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(theirs, save_all=True, append_images=ims[1:], duration=100, loop=0)
    for path in (ours, theirs):
        w, h, images, loop, trailer = chip_smoke.gif_blocks(path.read_bytes())
        assert (w, h, len(images), loop, trailer) == (30, 20, 3, 0, True)
        assert all(d == 10 and im[:4] == (0, 0, 30, 20) and im[5] > 0 for d, im in images)
    with pytest.raises(AssertionError):
        chip_smoke.gif_blocks(ours.read_bytes()[:-1])


def test_render_cli_writes_gif_without_an_image_package(tmp_path, monkeypatch):
    """``python -m minimal_nerf_torch.render --device cpu`` with neither
    imageio nor PIL importable writes ``{epoch}-360.gif``; PIL reads back
    the rendered frames within the quantizer's error."""
    cfg = t_nerf.NeRFConfig(coarse_samples=8, fine_samples=8)
    params = t_nerf.init_nerf_network(torch.Generator().manual_seed(0), cfg, device="cpu")
    for mlp in params.values():
        mlp["density"]["b"] += 0.5  # a visible frame
    ckpt = t_ckpt.save_checkpoint(tmp_path / t_ckpt.checkpoint_name("g", 2, 5), params, 5,
                                  cfg.to_dict(), TrainConfig(kernel="fused").to_dict())
    argv = ["-c", str(ckpt), "-r", "64", "-p", "2", "-s", str(tmp_path / "o"),
            "--height", "9", "--width", "11", "--device", "cpu"]
    with monkeypatch.context() as m:
        for name in ("imageio", "imageio.v2", "PIL", "PIL.Image"):
            m.setitem(sys.modules, name, None)
        assert mio._backend()[0] == "builtin"
        out = t_render.main(argv)
    assert out == tmp_path / "o" / "epoch=2-360.gif"
    got, infos = _decode(out)
    want = list(t_render.render_views(str(ckpt), rays=64, num_poses=2, height=9, width=11,
                                      device="cpu"))
    assert len(got) == 2 and infos[0]["loop"] == 0 and infos[0]["duration"] == 100
    for a, b in zip(got, want):
        assert a.shape == (9, 11, 3) and b.std() > 0
        err = np.abs(a.astype(int) - b.astype(int)).reshape(-1, 3).max(axis=0)
        assert all(e <= q for e, q in zip(err, mio.QUANT_MAX_ERR))
    assert Path(out).read_bytes()[:6] == b"GIF89a"


# ----------------------------------------------------------------- PNG

_PIL_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _png_image(channels, seed=0, h=29, w=31):
    """Noise with flat patches and ramps, so every filter sees runs,
    gradients and jumps."""
    rng = np.random.default_rng(seed + channels)
    img = rng.integers(0, 256, size=(h, w, channels), dtype=np.uint8)
    img[3:11, 4:20] = rng.integers(0, 256, size=channels, dtype=np.uint8)
    img[14:] = (np.arange(w)[None, :, None] * 9 + np.arange(h - 14)[:, None, None] * 5
                + np.arange(channels)[None, None, :] * 60) % 256
    return img


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("filter_type", range(5), ids=mio.PNG_FILTERS)
@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_imread_equals_pil_for_every_colour_type_and_filter(tmp_path, channels, filter_type):
    """The port's encoder with a forced row filter: PIL decodes the file to
    the image itself, and ``imread`` gives what PIL's ``convert("RGB")``
    gives (alpha dropped, gray repeated), bit for bit."""
    img = _png_image(channels)
    data = mio.encode_png(img, filter_type)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == _PIL_MODES[channels]
        raw = np.asarray(im)
    np.testing.assert_array_equal(raw.reshape(img.shape), img)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    got = mio.imread(path)
    assert got.shape == img.shape[:2] + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("channels", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_imread_equals_pil_on_files_pil_wrote(tmp_path, channels):
    """PIL's own files (its adaptive filters, several IDAT chunks when
    large) read the same through ``imread`` as through PIL."""
    img = _png_image(channels, seed=5, h=150, w=170)
    path = tmp_path / "p.png"
    Image.fromarray(img[..., 0] if channels == 1 else img, _PIL_MODES[channels]).save(path)
    np.testing.assert_array_equal(mio.imread(path), _pil_rgb(path.read_bytes()))


def test_pil_reads_imwrite_output(tmp_path):
    img = _png_image(3, seed=9, h=64, w=48)
    mio.imwrite(tmp_path / "w.png", img)
    with Image.open(tmp_path / "w.png") as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)


def _with_header(data: bytes, **fields) -> bytes:
    """``data`` with IHDR fields replaced (and its CRC made right)."""
    names = ("width", "height", "depth", "color_type", "compression", "filter", "interlace")
    values = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])), **fields)
    ihdr = mio.png_chunk(b"IHDR", struct.pack(">IIBBBBB", *values.values()))
    return data[:8] + ihdr + data[33:]


@pytest.mark.parametrize("case", ["16-bit", "palette", "interlaced", "bad CRC", "bad filter",
                                  "truncated", "not a PNG"])
def test_unsupported_png_raises(tmp_path, case):
    """A PNG the port does not decode raises a ValueError naming why, and
    never returns pixels."""
    img = _png_image(3, h=8, w=8)
    data = mio.encode_png(img)
    if case == "16-bit":
        buf = io.BytesIO()
        Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(buf, format="PNG")
        data, match = buf.getvalue(), "bit depth 16"
        assert data[24] == 16
    elif case == "palette":
        buf = io.BytesIO()
        Image.fromarray(img).convert("P").save(buf, format="PNG")
        data, match = buf.getvalue(), "palette"
    elif case == "interlaced":
        data, match = _with_header(data, interlace=1), "interlaced"
    elif case == "bad CRC":
        data, match = data[:40] + bytes([data[40] ^ 1]) + data[41:], "bad CRC"
    elif case == "bad filter":
        raw = bytearray(zlib.decompress(data[41:-16]))
        raw[0] = 7
        idat = mio.png_chunk(b"IDAT", zlib.compress(bytes(raw)))
        data, match = data[:33] + idat + mio.png_chunk(b"IEND", b""), "filter type 7"
    elif case == "truncated":
        data, match = data[:-20], "truncated|IEND"
    else:
        data, match = b"GIF89a" + data[6:], "signature"
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        mio.imread(path)
