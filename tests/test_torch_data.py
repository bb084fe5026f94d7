"""The port's data layer (``data/vocabulary.py``, ``captions.py``,
``images.py``, ``prefetch.py``) against the JAX package's and PIL, on
the CPU.

Covered: vocabulary and caption encodings and the vocabulary JSON file,
identical; the PNG decoder against PIL's ``.convert("RGB")`` on files
PIL wrote in modes L, LA, P, RGB and RGBA and on files with every row
filter (None, Sub, Up, Average, Paeth; PIL reads them as written); the
JPEG, 16-bit, interlaced and 1-bit files it once refused, now decoded
as PIL decodes them (``tests/test_torch_images.py`` covers every
format), and the typed refusal of a file that is no image;
``resize_bilinear`` against PIL's ``BILINEAR`` (up, down, uneven, one
axis), measured bit-equal (the bound held is 1 of 255);
``ImageFolderDataset`` batches and ``load_image_batch`` equal to JAX's
with ``DALLE_TPU_NATIVE_LOADER=0`` (JAX's PIL path), resizing included;
``save_image_grid`` PNGs read by PIL equal to JAX's grid; and the
prefetch thread (order, the device copy, errors on the consumer's side,
``max_bad_records`` and ``source_pos``).
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from dalle_pytorch_tpu.data import captions as JCAP
from dalle_pytorch_tpu.data import images as JIMG
from dalle_pytorch_tpu.data import vocabulary as JVOC
from dalle_pytorch_tpu_torch.data import captions as TCAP
from dalle_pytorch_tpu_torch.data import images as TIMG
from dalle_pytorch_tpu_torch.data import prefetch as TPF
from dalle_pytorch_tpu_torch.data import vocabulary as TVOC

CAPTIONS = ["a red  square", "the blue circle on a red square",
            "a  green one", "gray"]


@pytest.fixture
def pil_path(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_NATIVE_LOADER", "0")


def png_bytes(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


# -- vocabulary and captions --------------------------------------------------

def test_vocabulary_and_encodings_equal_jax(tmp_path):
    jv = JVOC.Vocabulary.from_captions(CAPTIONS)
    tv = TVOC.Vocabulary.from_captions(CAPTIONS)
    assert tv.word2index == jv.word2index and len(tv) == len(jv)
    assert tv.word2count == jv.word2count
    for text in CAPTIONS + ["red square"]:
        for pad in (None, 9):
            assert tv.encode(text, pad_to=pad) == jv.encode(text, pad_to=pad)
    assert tv.decode([3, 4, 0, 5]) == jv.decode([3, 4, 0, 5])
    with pytest.raises(KeyError):
        tv.encode("purple")
    with pytest.raises(ValueError):
        tv.encode(CAPTIONS[1], pad_to=3)
    jv.save(str(tmp_path / "j.json"))
    tv.save(str(tmp_path / "t.json"))
    assert (tmp_path / "j.json").read_bytes() == \
        (tmp_path / "t.json").read_bytes()
    back = TVOC.Vocabulary.load(str(tmp_path / "j.json"))
    assert back.word2index == jv.word2index


def test_caption_files_and_batches_equal_jax(tmp_path):
    (tmp_path / "only.txt").write_text("".join(c + "\n" for c in CAPTIONS))
    (tmp_path / "pairs.txt").write_text(
        "".join(f"img{i}.png : {c}\n" for i, c in enumerate(CAPTIONS * 2))
        + "\nlast.png : gray\n")
    args = (str(tmp_path / "only.txt"), str(tmp_path / "pairs.txt"), 12)
    (jv, jd), (tv, td) = JCAP.load_caption_data(*args), \
        TCAP.load_caption_data(*args)
    assert td == jd and tv.word2index == jv.word2index
    for shuffle, drop in ((False, False), (True, False), (True, True)):
        jds = JCAP.CaptionDataset(jd, batch_size=3, shuffle=shuffle, seed=5,
                                  drop_last=drop)
        tds = TCAP.CaptionDataset(td, batch_size=3, shuffle=shuffle, seed=5,
                                  drop_last=drop)
        assert len(tds) == len(jds)
        for epoch in (0, 1):
            for (jp, jt), (tp, tt) in zip(jds.epoch(epoch),
                                          tds.epoch(epoch), strict=True):
                assert tp == jp
                np.testing.assert_array_equal(tt, jt)
                assert tt.dtype == jt.dtype
    toks = np.asarray([r[1] for r in td])
    np.testing.assert_array_equal(TCAP.text_mask(toks), JCAP.text_mask(toks))


# -- PNG ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "LA", "P", "RGB", "RGBA"])
def test_png_decode_equals_pil(mode):
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, (21, 34, 4), dtype=np.uint8)
    rgba[4:12] = rgba[4:5]                 # flat runs: Up/Sub-friendly rows
    rgba[:, 20:] = np.linspace(0, 255, 14).astype(np.uint8)[None, :, None]
    src = Image.fromarray(rgba, "RGBA")
    img = src.convert("RGB").convert("P") if mode == "P" else \
        src.convert(mode)
    data = png_bytes(img)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = TIMG.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("gray", [False, True])
def test_png_every_row_filter_round_trips_through_pil(gray):
    rng = np.random.default_rng(2)
    shape = (40, 37) if gray else (40, 37, 3)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[10:20] = img[10:11]
    data = TIMG.encode_png(img, filters=[r % 5 for r in range(40)])
    filters = np.frombuffer(zlib.decompress(
        b"".join(b for k, b in TIMG._chunks(data) if k == b"IDAT")),
        np.uint8).reshape(40, -1)[:, 0]
    assert sorted(set(filters.tolist())) == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    want = img if not gray else np.repeat(img[..., None], 3, axis=-1)
    np.testing.assert_array_equal(TIMG.decode_png(data), want)


def _with_ihdr(data: bytes, depth: int = 8, interlace: int = 0) -> bytes:
    """A PNG's bytes with the IHDR's bit depth or interlace replaced."""
    w, h, _, ctype, comp, filt, _ = struct.unpack(">IIBBBBB", data[16:29])
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, comp, filt,
                       interlace)
    chunk = b"IHDR" + ihdr
    return data[:12] + chunk + struct.pack(">I", zlib.crc32(chunk)) + \
        data[33:]


def _adam7_png(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, Adam7 interlaced, every row filter None (PIL
    reads interlaced PNGs but does not write them)."""
    h, w, _ = img.shape
    raw = b""
    for r0, c0, dr, dc in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                           (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                           (1, 0, 2, 1)):
        sub = img[r0::dr, c0::dc]
        raw += b"".join(b"\x00" + row.tobytes() for row in sub
                        if sub.size)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case,match", [("gif", "not a PNG")])
def test_unsupported_images_raise_a_typed_error(case, match):
    data = {"gif": lambda: b"GIF89a" + b"\x00" * 20}[case]()
    with pytest.raises(TIMG.UnsupportedImage, match=match):
        TIMG.decode_png(data)


@pytest.mark.parametrize("case", ["jpeg", "sixteen", "interlaced",
                                  "one_bit"])
def test_formats_once_refused_now_decode_as_pil(case):
    """The JPEG, 16-bit, interlaced and 1-bit files the port used to
    refuse: each decodes to PIL's ``.convert("RGB")`` exactly."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, (11, 13, 3), dtype=np.uint8)
    jpeg = io.BytesIO()
    Image.fromarray(arr).save(jpeg, "JPEG")
    grey16 = rng.integers(0, 900, (11, 13)).astype(np.uint16)
    data = {"jpeg": jpeg.getvalue,
            "sixteen": lambda: png_bytes(Image.fromarray(grey16)),
            "interlaced": lambda: _adam7_png(arr),
            "one_bit": lambda: png_bytes(Image.fromarray(arr).convert("1")),
            }[case]()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(TIMG.decode_image(data), want)


def test_corrupt_png_is_refused():
    data = bytearray(TIMG.encode_png(np.ones((4, 4, 3), np.uint8)))
    data[40] ^= 0xFF
    with pytest.raises(ValueError, match="crc|truncated|broken"):
        TIMG.decode_png(bytes(data))


@pytest.mark.parametrize("src,dst", [
    ((16, 16), (8, 8)), ((17, 23), (16, 16)), ((50, 31), (64, 64)),
    ((300, 260), (256, 256)), ((97, 13), (7, 40)), ((32, 32), (32, 20))])
def test_resize_matches_pil_bilinear(src, dst):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    img[src[0] // 3:, :src[1] // 2] = np.linspace(
        0, 255, src[1] // 2).astype(np.uint8)[None, :, None]
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]),
                                                  Image.BILINEAR))
    got = TIMG.resize_bilinear(img, dst[1], dst[0])
    diff = np.abs(got.astype(int) - want.astype(int)).max()
    assert diff == 0           # measured bit-equal; the bound held is 1/255


# -- image folders, batches and grids -----------------------------------------

@pytest.fixture
def image_dir(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "imgs"
    (root / "0").mkdir(parents=True)
    (root / "1").mkdir()
    for i in range(7):
        size = (20, 20) if i % 3 else (24, 17)
        arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        mode = ("RGB", "RGBA", "L", "P")[i % 4]
        img = Image.fromarray(arr)
        img = img.convert(mode) if mode != "P" else img.convert("P")
        img.save(root / str(i % 2) / f"im{i}.png")
    (root / "0" / "notes.txt").write_text("not an image")
    return root


def test_image_folder_batches_equal_jax(image_dir, pil_path):
    assert TIMG.list_image_folder(str(image_dir)) == \
        JIMG.list_image_folder(str(image_dir))
    for drop in (True, False):
        jds = JIMG.ImageFolderDataset(str(image_dir), 16, 3, seed=7,
                                      drop_last=drop)
        tds = TIMG.ImageFolderDataset(str(image_dir), 16, 3, seed=7,
                                      drop_last=drop)
        assert len(tds) == len(jds)
        for epoch in (0, 1):
            for jb, tb in zip(jds.epoch(epoch), tds.epoch(epoch),
                              strict=True):
                assert tb.dtype == np.float32 and tb.shape == jb.shape
                np.testing.assert_array_equal(tb, jb)


def test_load_image_batch_equals_jax(image_dir, pil_path):
    names = ["im0.png", "im2.png", str(image_dir / "1" / "im1.png")]
    for size, some in ((None, names[1:2]), (20, names), (32, names)):
        np.testing.assert_array_equal(
            TIMG.load_image_batch(some, str(image_dir), size),
            JIMG.load_image_batch(some, str(image_dir), size))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("channels", [3, 1])
def test_save_image_grid_equals_jax(tmp_path, normalize, channels):
    rng = np.random.default_rng(5)
    images = rng.uniform(-1.2, 1.1, (5, 6, 7, channels)).astype(np.float32)
    np.testing.assert_array_equal(TIMG.to_uint8(images, normalize),
                                  JIMG.to_uint8(images, normalize))
    JIMG.save_image_grid(images, str(tmp_path / "j.png"), nrow=2,
                         normalize=normalize)
    TIMG.save_image_grid(torch.from_numpy(images), str(tmp_path / "t.png"),
                         nrow=2, normalize=normalize)
    want = Image.open(tmp_path / "j.png")
    got = Image.open(tmp_path / "t.png")
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        TIMG.decode_png((tmp_path / "t.png").read_bytes()),
        np.asarray(want.convert("RGB")))


# -- prefetch -----------------------------------------------------------------

def test_prefetch_order_values_and_device_copy():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "t": np.arange(4, dtype=np.int32) + i} for i in range(5)]
    pf = TPF.prefetch(iter(batches), depth=2, device="cpu",
                      transform=lambda b: {**b, "x": b["x"] * 2})
    got = list(pf)
    assert len(got) == 5 and pf.source_pos == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["t"].dtype == \
            torch.int32
        assert float(b["x"][0, 0]) == 2 * i and int(b["t"][0]) == i
    # without a device the batches stay numpy
    assert isinstance(next(iter(TPF.prefetch(iter([np.ones(2)])))),
                      np.ndarray)


def test_prefetch_errors_reach_the_consumer_after_good_batches():
    def source():
        yield 1
        yield 2
        raise RuntimeError("disk gone")

    pf = TPF.prefetch(source(), depth=4)
    assert next(pf) == 1 and next(pf) == 2
    with pytest.raises(RuntimeError, match="disk gone"):
        next(pf)


def test_prefetch_skips_bad_records_up_to_the_cap():
    events = []

    def transform(x):
        if x in (1, 3):
            raise ValueError(f"unreadable record {x}")
        return x

    pf = TPF.prefetch(iter(range(6)), transform=transform,
                      max_bad_records=2, on_event=events.append)
    assert list(pf) == [0, 2, 4, 5]
    assert pf.bad_records == 2 and pf.source_pos == 6
    assert [e["kind"] for e in events] == ["prefetch_bad_record"] * 2
    pf = TPF.prefetch(iter(range(6)), transform=transform,
                      max_bad_records=1)
    with pytest.raises(ValueError, match="record 3"):
        list(pf)


def test_shard_for_host():
    assert TPF.shard_for_host(list(range(10))) == list(range(10))
    assert TPF.shard_for_host(list(range(10)), 1, 3) == [3, 4, 5]
    with pytest.raises(ValueError):
        TPF.shard_for_host([1], 0, 2)
