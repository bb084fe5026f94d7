"""The port's image formats (``data/images.py``, ``native/``) against the
JAX package's PIL path, on the CPU.

Covered, each bit-equal to JAX's ``load_image`` (``Image.open(path)
.convert("RGB")`` and PIL's bilinear resize), at the file's own size and
resized: JPEG through libjpeg (baseline 4:2:0 and 4:4:4, progressive,
greyscale, low quality, odd sizes); PNG at 16 bits (grey, which PIL
clips to 255, and grey + alpha, RGB and RGBA, which it cuts to their high
bytes), at 1, 2 and 4 bits (grey and palette) and Adam7 interlaced at
every depth; BMP at 24 and 32 bits, bottom-up and top-down. Then a folder
of mixed JPEG, PNG and BMP through ``load_image_batch`` and
``ImageFolderDataset`` equal to JAX's, a folder of JPEGs through
``train_vae``, the committed JPEG fixture the chip smoke decodes, and the
typed refusals: a file of no format the port reads, and a JPEG where
libjpeg or g++ is missing. WebP: ``tests/test_torch_webp.py``.
"""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from dalle_pytorch_tpu.data import images as JIMG
from dalle_pytorch_tpu_torch import native
from dalle_pytorch_tpu_torch.data import images as TIMG
from dalle_pytorch_tpu_torch.native import build as NB

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.fixture
def pil_path(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_NATIVE_LOADER", "0")


# -- writers: PIL where it writes the case, by hand where it does not ---------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _scanlines(s: np.ndarray, depth: int, rng) -> bytes:
    """(h, w, ch) samples -> filtered scanlines, each row's filter type
    drawn from ``rng`` (the filters work on bytes, ``bpp`` apart)."""
    h, w, ch = s.shape
    bpp = max(1, ch * depth // 8)
    out, prev = [], None
    for r in range(h):
        if depth == 16:
            line = s[r].astype(">u2").tobytes()
        elif depth == 8:
            line = s[r].astype(np.uint8).tobytes()
        else:
            bits = (s[r].reshape(-1)[:, None]
                    >> np.arange(depth - 1, -1, -1)) & 1
            line = np.packbits(bits.astype(np.uint8).reshape(-1)).tobytes()
        x = np.frombuffer(line, np.uint8).astype(np.int32)
        up = np.zeros_like(x) if prev is None else prev
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, up, c))
        ftype = int(rng.integers(0, 5))
        pred = (0, a, up, (a + up) >> 1, paeth)[ftype]
        out.append(bytes([ftype]) + ((x - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = x
    return b"".join(out)


def png_raw(s, depth: int, ctype: int, palette=None,
            interlace: bool = False, seed: int = 0) -> bytes:
    """A PNG of samples ``s`` (h, w, ch) at any depth and colour type,
    plain or Adam7 — the cases PIL reads but does not write."""
    rng = np.random.default_rng(seed)
    h, w, _ = s.shape
    if interlace:
        data = b"".join(_scanlines(s[r0::dr, c0::dc], depth, rng)
                        for r0, c0, dr, dc in ADAM7
                        if s[r0::dr, c0::dc].size)
    else:
        data = _scanlines(s, depth, rng)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def _png_case(ctype: int, depth: int, interlace: bool, h=21, w=19,
              seed=0, high=None) -> bytes:
    rng = np.random.default_rng(seed)
    if ctype == 3:
        n = min(1 << depth, 11)
        return png_raw(rng.integers(0, n, (h, w, 1)), depth, 3,
                       rng.integers(0, 256, (n, 3)), interlace, seed)
    top = high or (1 << depth)
    return png_raw(rng.integers(0, top, (h, w, CHANNELS[ctype])), depth,
                   ctype, None, interlace, seed)


def _jpeg(mode="RGB", h=29, w=35, seed=0, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    arr = np.stack([(x * 7) % 256, (y * 5) % 256, ((x + y) * 3) % 256], -1)
    arr = np.clip(arr + rng.integers(-30, 31, arr.shape), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(arr.astype(np.uint8)).convert(mode).save(buf, "JPEG",
                                                             **kw)
    return buf.getvalue()


def _bmp(mode: str, top_down: bool, h=13, w=10, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "BMP")
    data = buf.getvalue()
    if not top_down:
        return data
    # rows stored first-to-last under a negative height
    off = struct.unpack("<I", data[10:14])[0]
    bits = struct.unpack("<H", data[28:30])[0]
    stride = ((bits * w + 31) // 32) * 4
    body = np.frombuffer(data, np.uint8, count=h * stride,
                         offset=off).reshape(h, stride)[::-1]
    out = bytearray(data)
    out[22:26] = struct.pack("<i", -h)
    out[off:off + h * stride] = body.tobytes()
    return bytes(out)


CASES = {
    "jpeg_420": lambda: _jpeg(),
    "jpeg_444": lambda: _jpeg(subsampling=0, quality=95),
    "jpeg_progressive": lambda: _jpeg(progressive=True, h=40, w=24),
    "jpeg_grey": lambda: _jpeg("L"),
    "jpeg_q20_odd": lambda: _jpeg(h=17, w=9, quality=20, seed=3),
    "png16_grey": lambda: _png_case(0, 16, False, high=700),
    "png16_grey_full": lambda: _png_case(0, 16, False, seed=1),
    "png16_rgb": lambda: _png_case(2, 16, False),
    "png16_rgba": lambda: _png_case(6, 16, False),
    "png16_grey_alpha": lambda: _png_case(4, 16, False),
    "png1_grey": lambda: _png_case(0, 1, False),
    "png2_grey": lambda: _png_case(0, 2, False),
    "png4_grey": lambda: _png_case(0, 4, False),
    "png1_palette": lambda: _png_case(3, 1, False),
    "png2_palette": lambda: _png_case(3, 2, False),
    "png4_palette": lambda: _png_case(3, 4, False),
    "adam7_rgb8": lambda: _png_case(2, 8, True),
    "adam7_rgba8": lambda: _png_case(6, 8, True, h=9, w=5),
    "adam7_grey1": lambda: _png_case(0, 1, True),
    "adam7_palette4": lambda: _png_case(3, 4, True),
    "adam7_rgb16": lambda: _png_case(2, 16, True),
    "adam7_tiny": lambda: _png_case(0, 8, True, h=3, w=2),
    "bmp24": lambda: _bmp("RGB", False),
    "bmp24_top_down": lambda: _bmp("RGB", True),
    "bmp32": lambda: _bmp("RGBA", False),
    "bmp32_top_down": lambda: _bmp("RGBA", True),
}
EXT = {"jpe": ".jpg", "png": ".png", "ada": ".png", "bmp": ".bmp"}


def _write(tmp_path, name: str) -> str:
    path = tmp_path / f"{name}{EXT[name[:3]]}"
    path.write_bytes(CASES[name]())
    return str(path)


@pytest.mark.parametrize("size", [None, 16], ids=["own_size", "resized"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_format_loads_bit_equal_to_jax_pil_path(tmp_path, name, size):
    path = _write(tmp_path, name)
    want = JIMG.load_image(path, size)
    got = TIMG.load_image(path, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_decode_equals_pil_convert_rgb_at_the_quirks():
    """The two 16-bit quirks named in the module: grey clips, colour
    keeps the high byte."""
    grey = png_raw(np.array([[[0], [100], [255], [256], [1000]]]), 16, 0)
    rgb = png_raw(np.array([[[0x0100, 0x00FF, 0xFFFF]]]), 16, 2)
    assert TIMG.decode_png(grey)[0, :, 0].tolist() == [0, 100, 255, 255,
                                                       255]
    assert TIMG.decode_png(rgb)[0, 0].tolist() == [1, 0, 255]
    for data in (grey, rgb):
        np.testing.assert_array_equal(
            TIMG.decode_png(data),
            np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_mixed_folder_batches_equal_jax(tmp_path, pil_path):
    folder = tmp_path / "0"
    folder.mkdir()
    names = ["jpeg_420", "png16_rgb", "bmp24", "adam7_rgb8",
             "jpeg_grey", "bmp32_top_down"]
    for n in names:
        _write(folder, n)
    files = sorted(p.name for p in folder.iterdir())
    np.testing.assert_array_equal(
        TIMG.load_image_batch(files, str(tmp_path), 16),
        JIMG.load_image_batch(files, str(tmp_path), 16))
    tds = TIMG.ImageFolderDataset(str(tmp_path), 16, 4, seed=3,
                                  drop_last=False)
    jds = JIMG.ImageFolderDataset(str(tmp_path), 16, 4, seed=3,
                                  drop_last=False)
    assert len(tds) == len(jds) == 2
    for t, j in zip(tds.epoch(1), jds.epoch(1)):
        np.testing.assert_array_equal(t, j)


def test_committed_fixture_equals_its_stored_pil_decode():
    """The chip smoke's JPEG check: the fixture's decode equals PIL's,
    stored beside it."""
    data = (FIXTURES / "smoke.jpg").read_bytes()
    want = np.load(FIXTURES / "smoke_pil_rgb.npy")
    np.testing.assert_array_equal(native.decode_jpeg(data), want)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), want)


def test_webp_and_unknown_files_are_refused_typed():
    """(Named for its first version: WebP now decodes,
    ``tests/test_torch_webp.py``.)"""
    with pytest.raises(TIMG.UnsupportedImage, match="not a PNG, JPEG"):
        TIMG.decode_image(b"GIF89a" + b"\x00" * 20)


@pytest.fixture
def fresh_loader(monkeypatch):
    """A process with no loader library loaded yet."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_path", None)
    return monkeypatch


def test_missing_libjpeg_raises_the_typed_error_naming_it(fresh_loader):
    fresh_loader.setattr(NB, "LIBS", ("-ljpeg_not_on_this_machine",))
    with pytest.raises(TIMG.UnsupportedImage, match="libjpeg"):
        TIMG.decode_image(CASES["jpeg_420"]())


def test_missing_compiler_raises_the_typed_error_naming_it(fresh_loader,
                                                           tmp_path):
    fresh_loader.setattr(NB, "BUILD_DIR", tmp_path)   # nothing built here
    fresh_loader.delenv("CXX", raising=False)
    fresh_loader.setattr(NB.shutil, "which", lambda name: None)
    with pytest.raises(TIMG.UnsupportedImage, match="g\\+\\+"):
        TIMG.decode_image(CASES["jpeg_420"]())


def test_a_folder_of_jpegs_trains_through_train_vae(tmp_path):
    from dalle_pytorch_tpu_torch.cli import train_vae
    folder = tmp_path / "imagedata" / "0"
    folder.mkdir(parents=True)
    for i in range(4):
        (folder / f"im{i}.jpg").write_bytes(
            _jpeg(h=16, w=16, seed=i, quality=90))
    argv = ["--dataPath", str(tmp_path / "imagedata"), "--imageSize", "16",
            "--batchSize", "4", "--num_layers", "2", "--num_tokens", "24",
            "--codebook_dim", "16", "--hidden_dim", "8", "--n_epochs", "1",
            "--log_interval", "1", "--metrics",
            str(tmp_path / "metrics.jsonl"),
            "--models_dir", str(tmp_path / "models"),
            "--results_dir", str(tmp_path / "results")]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_vae.main(argv, device="cpu")
    finally:
        torch.set_num_threads(n)
    import json
    losses = [json.loads(line).get("loss") for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    losses = [x for x in losses if x is not None]
    assert losses and all(np.isfinite(losses))
    assert any((tmp_path / "models").iterdir())


def test_a_loader_that_does_not_load_is_rebuilt_then_refused_typed(
        fresh_loader):
    """A library copied from another machine may name a libjpeg this one
    lacks: the loader rebuilds once, and where that fails too a JPEG is
    the typed refusal naming libjpeg."""
    import ctypes
    calls = []

    def no_dlopen(path):
        calls.append(path)
        raise OSError("libjpeg.so.62: cannot open shared object file")

    fresh_loader.setattr(ctypes, "CDLL", no_dlopen)
    with pytest.raises(TIMG.UnsupportedImage, match="libjpeg"):
        TIMG.decode_image(CASES["jpeg_420"]())
    assert len(calls) == 2
