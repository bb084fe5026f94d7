"""WebP in the port's image IO (``data/images.py::decode_webp``: libwebp
through ``ctypes``) against the JAX package's PIL path, on the CPU.

The files are written by PIL here. Lossless RGB and RGBA decode bit-equal
to PIL's ``.convert("RGB")`` (alpha dropped, as PIL drops it), at the
file's own size and resized through ``load_image``. Lossy files at two
qualities are held to ``LOSSY_MAX_ABS``: the port decodes with the
host's libwebp, PIL with the libwebp it bundles, and the two may round
the YUV to RGB conversion apart; on this host (libwebp 1.2.4 against
PIL's 1.6.0) they agree exactly, so the bound is 0. A WebP in the image
folder goes through ``load_image_batch`` and ``ImageFolderDataset``
equal to JAX's; an animated WebP, a broken one and a host without
libwebp are the typed ``UnsupportedImage``.
"""

import io

import numpy as np
import pytest
from PIL import Image

from dalle_pytorch_tpu.data import images as JIMG
from dalle_pytorch_tpu_torch.data import images as TIMG

# largest |port - PIL| of a lossy file's 8-bit samples (module docstring)
LOSSY_MAX_ABS = 0


@pytest.fixture(autouse=True)
def libwebp():
    """Decided per test, never at import: a host without libwebp skips."""
    if TIMG._libwebp() is None:
        pytest.skip("the host has no libwebp")


def picture(mode: str, h: int = 37, w: int = 53, seed: int = 0):
    """A smooth ramp with seeded noise; RGBA adds a seeded alpha with a
    fully transparent band."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // w, y * 255 // h,
                     (x + y) * 255 // (h + w)], -1)
    arr = np.clip(base + rng.integers(0, 40, base.shape), 0,
                  255).astype(np.uint8)
    if mode == "RGBA":
        alpha = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        alpha[:5] = 0
        arr = np.concatenate([arr, alpha], -1)
    return Image.fromarray(arr, mode)


def webp(mode: str, **save) -> bytes:
    buf = io.BytesIO()
    picture(mode).save(buf, "WEBP", **save)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_lossless_is_bit_equal_to_pil(mode):
    data = webp(mode, lossless=True)
    got = TIMG.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, pil_rgb(data))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("quality", [90, 40])
def test_lossy_is_within_the_stated_bound_of_pil(mode, quality):
    data = webp(mode, quality=quality)
    got = TIMG.decode_webp(data)
    want = pil_rgb(data)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= LOSSY_MAX_ABS


@pytest.mark.parametrize("size", [None, 16], ids=["own_size", "resized"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_load_image_equals_jax(tmp_path, mode, size):
    path = tmp_path / "x.webp"
    path.write_bytes(webp(mode, lossless=True))
    want = JIMG.load_image(str(path), size)
    got = TIMG.load_image(str(path), size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_a_webp_in_the_image_folder_batches_equal_jax(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("DALLE_TPU_NATIVE_LOADER", "0")
    folder = tmp_path / "0"
    folder.mkdir()
    (folder / "a.webp").write_bytes(webp("RGB", lossless=True))
    (folder / "b.webp").write_bytes(webp("RGBA", quality=90))
    picture("RGB", 20, 20, seed=1).save(folder / "c.png")
    picture("RGB", 24, 16, seed=2).save(folder / "d.bmp")
    files = sorted(p.name for p in folder.iterdir())
    np.testing.assert_array_equal(
        TIMG.load_image_batch(files, str(tmp_path), 16),
        JIMG.load_image_batch(files, str(tmp_path), 16))
    tds = TIMG.ImageFolderDataset(str(tmp_path), 16, 2, seed=3)
    jds = JIMG.ImageFolderDataset(str(tmp_path), 16, 2, seed=3)
    assert len(tds) == len(jds) == 2
    for t, j in zip(tds.epoch(0), jds.epoch(0)):
        np.testing.assert_array_equal(t, j)


def test_animated_broken_and_missing_libwebp_are_typed(monkeypatch):
    buf = io.BytesIO()
    picture("RGB").save(buf, "WEBP", save_all=True, lossless=True,
                        append_images=[picture("RGB", seed=1)])
    with pytest.raises(TIMG.UnsupportedImage, match="animated"):
        TIMG.decode_image(buf.getvalue())
    with pytest.raises(TIMG.UnsupportedImage, match="libwebp"):
        TIMG.decode_image(b"RIFF\x00\x00\x00\x00WEBPVP8 " + b"\x00" * 16)
    monkeypatch.setattr(TIMG, "_libwebp", lambda: None)
    with pytest.raises(TIMG.UnsupportedImage, match="needs libwebp"):
        TIMG.decode_image(webp("RGB", lossless=True))


def test_committed_fixture_equals_its_stored_pil_decode():
    """The chip smoke's WebP check: the lossless RGBA fixture's decode
    equals PIL's, stored beside it."""
    from pathlib import Path
    fixtures = Path(__file__).resolve().parent / "fixtures" / "images"
    data = (fixtures / "smoke.webp").read_bytes()
    want = np.load(fixtures / "smoke_webp_rgb.npy")
    np.testing.assert_array_equal(TIMG.decode_image(data), want)
    np.testing.assert_array_equal(pil_rgb(data), want)
