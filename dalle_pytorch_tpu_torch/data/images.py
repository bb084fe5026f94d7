"""Image IO: decode and resize training images, write sample grids.

Port of ``dalle_pytorch_tpu/data/images.py``, which reads through PIL
(``Image.open(path).convert("RGB")``, ``:68``) and its native loader;
the port has no PIL, so it carries its own codecs and holds them to
PIL's pixels, quirks included:

* ``decode_png`` reads every PNG: colour types 0 (grey), 2 (RGB), 3
  (palette), 4 (grey + alpha) and 6 (RGBA) at every bit depth the format
  allows (1, 2, 4, 8 and 16), every row filter, plain or Adam7
  interlaced, and converts as PIL's ``.convert("RGB")`` does: alpha
  dropped, grey repeated, palettes looked up, 1-, 2- and 4-bit grey
  scaled to 8 bits, 16-bit grey (PIL's ``I;16``) CLIPPED to 255 and
  16-bit colour reduced to its HIGH byte;
* ``decode_bmp`` reads 24- and 32-bit BMPs, bottom-up or top-down (the
  fourth byte of a 32-bit pixel is dropped, as PIL's ``BGRX`` does);
* JPEG goes through libjpeg in ``native`` (built with g++ on first use):
  the same library and defaults as PIL's decoder, so the same pixels.
  Where g++ or libjpeg is missing a JPEG raises ``UnsupportedImage``
  naming it;
* ``decode_webp`` calls libwebp's ``WebPGetInfo``, ``WebPDecodeRGB`` and
  ``WebPFree`` through ``ctypes`` (nothing is built): a lossless file
  gives PIL's pixels bit for bit (alpha dropped, as ``.convert("RGB")``
  drops it), a lossy one whatever the host's libwebp decodes. Where
  libwebp is missing it raises ``UnsupportedImage`` naming it; an
  animated WebP (which PIL reads as its first frame) is refused the
  same way;
* ``resize_bilinear`` is PIL's ``Image.resize(..., BILINEAR)`` for 8-bit
  images: the same separable passes (horizontal, then vertical, each
  rounded to 8 bits), the triangle filter's support widened by the scale
  when downscaling, and its coefficients in PIL's 22-bit fixed point;
* ``encode_png`` writes 8-bit grey or RGB PNGs (``save_image_grid``).

The rarer BMP depths raise ``UnsupportedImage``. The rest follows the
JAX module: ``load_image``
(resized only when the size differs), ``load_image_batch``,
``list_image_folder``, ``ImageFolderDataset`` (the same batches, in the
same order), ``to_uint8`` and ``save_image_grid``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import os
import struct
import zlib
from typing import Iterable, List, Optional, Sequence

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PRECISION_BITS = 32 - 8 - 2          # PIL's Resample.c


class UnsupportedImage(ValueError):
    """An image file the port's decoder does not read."""


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"broken PNG file (bad {kind!r} crc)")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND)")


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo PNG's row filters (None, Sub, Up, Average, Paeth) on the
    inflated scanlines. Sub, Average and Paeth chain along a row and Up,
    Average and Paeth down the columns, so the pixels are reconstructed
    one anti-diagonal at a time, each diagonal vectorised across all the
    rows: in the skewed layout ``sk[d, 1 + r] = pixel (r, d - r)`` a
    diagonal's left neighbours are diagonal d - 1 at the same row, its
    upper ones diagonal d - 1 a row up, its upper-left ones diagonal
    d - 2 a row up (index 0 is the zero row above the image; entries off
    the image stay zero, the zero column left of it)."""
    rows = raw.reshape(h, 1 + w * bpp)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    data = rows[:, 1:].reshape(h, w, bpp)
    if not ftype.any():
        return data
    r = np.arange(h)[:, None]
    ndiag = h + w - 1
    diag = r + np.arange(w)[None, :]                  # (h, w): r + c
    src = np.zeros((ndiag, h, bpp), np.int32)
    src[diag, np.broadcast_to(r, (h, w))] = data
    sk = np.zeros((ndiag + 2, h + 1, bpp), np.int32)  # two zero diagonals
    f = ftype.astype(np.int32)[:, None]
    sel = [np.broadcast_to(f == k, (h, bpp)) for k in (1, 2, 3, 4)]
    paeth_rows = bool(sel[3].any())
    for d in range(ndiag):
        a = sk[d + 1, 1:]
        b = sk[d + 1, :-1]
        pred = np.where(sel[0], a, 0)
        pred = np.where(sel[1], b, pred)
        pred = np.where(sel[2], (a + b) >> 1, pred)
        if paeth_rows:
            ul = sk[d, :-1]
            p = a + b - ul
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
            pred = np.where(sel[3], np.where((pa <= pb) & (pa <= pc), a,
                                             np.where(pb <= pc, b, ul)),
                            pred)
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1  # rows on the image
        sk[d + 2, 1 + lo:1 + hi] = (src[d, lo:hi] + pred[lo:hi]) & 0xFF
    return sk[diag + 2, np.broadcast_to(r + 1, (h, w))].astype(np.uint8)


# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}


def _samples(raw: np.ndarray, h: int, w: int, depth: int,
             ch: int) -> np.ndarray:
    """One (sub)image's filtered scanlines -> (h, w, ch) integer samples
    (uint16 at depth 16)."""
    if depth >= 8:
        bpp = ch * depth // 8
        px = _unfilter(raw, h, w, bpp)                    # (h, w, bpp)
        if depth == 16:
            px = px.reshape(h, w, ch, 2).astype(np.uint16)
            return (px[..., 0] << 8) | px[..., 1]
        return px
    # sub-byte: the filters work on whole bytes, one byte apart
    rowbytes = (w * depth + 7) // 8
    packed = _unfilter(raw, h, rowbytes, 1).reshape(h, rowbytes)
    bits = np.unpackbits(packed, axis=1)[:, :w * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, w, depth) * weights).sum(
        -1, dtype=np.uint8)[..., None]


def _deinterlace(raw: np.ndarray, h: int, w: int, depth: int,
                 ch: int) -> np.ndarray:
    """Adam7: each pass's scanlines are a small image of their own,
    filtered on their own; scatter them into the full grid."""
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for r0, c0, dr, dc in _ADAM7:
        ph, pw = (h - r0 + dr - 1) // dr, (w - c0 + dc - 1) // dc
        if ph <= 0 or pw <= 0:
            continue
        n = ph * (1 + (pw * depth * ch + 7) // 8)
        if pos + n > raw.size:
            raise ValueError("truncated interlaced PNG image data")
        out[r0::dr, c0::dc] = _samples(raw[pos:pos + n], ph, pw, depth, ch)
        pos += n
    if pos != raw.size:
        raise ValueError(f"PNG image data of {raw.size} bytes, expected "
                         f"{pos}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's ``.convert("RGB")``."""
    if data[:8] != PNG_SIGNATURE:
        raise UnsupportedImage("not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"bad PNG bit depth {depth} for colour type "
                         f"{ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"bad PNG interlace method {interlace}")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        px = _deinterlace(raw, h, w, depth, ch)
    else:
        n = h * (1 + (w * depth * ch + 7) // 8)
        if raw.size != n:
            raise ValueError(f"PNG image data of {raw.size} bytes, "
                             f"expected {n}")
        px = _samples(raw, h, w, depth, ch)
    if ctype == 3:
        if palette is None or int(px.max()) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[px[..., 0]]
    if depth == 16:
        # PIL opens 16-bit grey as I;16, which converts to RGB clipped at
        # 255; every other 16-bit type unpacks to its high bytes
        px = np.minimum(px, 255) if ctype == 0 else px >> 8
        px = px.astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))    # 1-, 2-, 4-bit grey
    if ctype in (2, 6):
        return np.ascontiguousarray(px[..., :3])
    return np.repeat(px[..., :1], 3, axis=-1)            # grey (+ alpha)


# ---------------------------------------------------------------------------
# BMP
# ---------------------------------------------------------------------------

def decode_bmp(data: bytes) -> np.ndarray:
    """24- and 32-bit BMP bytes, bottom-up or top-down -> (H, W, 3) uint8,
    as PIL's ``.convert("RGB")``."""
    if data[:2] != b"BM" or len(data) < 26:
        raise UnsupportedImage("not a BMP file")
    offset, hsize = struct.unpack("<II", data[10:18])
    if hsize < 40:
        raise UnsupportedImage(f"BMP with a {hsize}-byte (OS/2) header: "
                               "the port reads Windows BMP headers only")
    w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
    if bits not in (24, 32):
        raise UnsupportedImage(f"{bits}-bit BMP: the port reads 24- and "
                               "32-bit BMPs only")
    if comp == 3 and bits == 32 and hsize >= 52:
        masks = struct.unpack("<III", data[54:66])
        if masks != (0xFF0000, 0xFF00, 0xFF):
            raise UnsupportedImage(f"BMP bit fields {masks}: the port "
                                   "reads BGR(X) order only")
    elif comp != 0:
        raise UnsupportedImage(f"compressed BMP (compression {comp}): "
                               "the port reads uncompressed BMPs only")
    if w <= 0 or h == 0:
        raise ValueError(f"bad BMP size {w}x{h}")
    rows, stride = abs(h), ((bits * w + 31) // 32) * 4
    body = np.frombuffer(data, np.uint8, count=rows * stride, offset=offset)
    px = body.reshape(rows, stride)[:, :w * bits // 8].reshape(
        rows, w, bits // 8)
    if h > 0:
        px = px[::-1]                                     # bottom-up
    return np.ascontiguousarray(px[..., 2::-1])           # BGR(X) -> RGB


# ---------------------------------------------------------------------------
# any image file
# ---------------------------------------------------------------------------

def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 through libjpeg (``native``);
    ``UnsupportedImage`` naming g++ or libjpeg where the loader cannot be
    built."""
    from dalle_pytorch_tpu_torch import native
    from dalle_pytorch_tpu_torch.native.build import BuildError
    try:
        return native.decode_jpeg(data)
    except BuildError as e:
        raise UnsupportedImage(f"JPEG decoding needs the native loader, "
                               f"built with g++ against libjpeg: {e}") from e


@functools.lru_cache(maxsize=1)
def _libwebp():
    """libwebp through ``ctypes``, its three entry points typed; None
    where the host has no libwebp."""
    name = ctypes.util.find_library("webp")
    if name is None:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    size, ptr, intp = ctypes.c_size_t, ctypes.c_char_p, ctypes.POINTER(
        ctypes.c_int)
    lib.WebPGetInfo.argtypes = [ptr, size, intp, intp]
    lib.WebPGetInfo.restype = ctypes.c_int
    lib.WebPDecodeRGB.argtypes = [ptr, size, intp, intp]
    lib.WebPDecodeRGB.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    lib.WebPFree.restype = None
    return lib


def _webp_animated(data: bytes) -> bool:
    """Whether the file's extended header (``VP8X``) sets the animation
    flag."""
    return data[12:16] == b"VP8X" and len(data) > 20 \
        and bool(data[20] & 0x02)


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> (H, W, 3) uint8 through libwebp's ``WebPDecodeRGB``
    (alpha dropped). ``UnsupportedImage`` where libwebp is missing, for
    an animated file, and for bytes libwebp cannot decode."""
    lib = _libwebp()
    if lib is None:
        raise UnsupportedImage("WebP decoding needs libwebp "
                               "(libwebp.so), which this host lacks")
    if _webp_animated(data):
        raise UnsupportedImage("an animated WebP is not read (PIL would "
                               "take its first frame)")
    w, h = ctypes.c_int(), ctypes.c_int()
    if not lib.WebPGetInfo(data, len(data), ctypes.byref(w),
                           ctypes.byref(h)):
        raise UnsupportedImage("libwebp does not read this WebP header")
    out = lib.WebPDecodeRGB(data, len(data), ctypes.byref(w),
                            ctypes.byref(h))
    if not out:
        raise UnsupportedImage("libwebp could not decode this WebP")
    try:
        px = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.WebPFree(out)
    return px


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes (PNG, JPEG, BMP or WebP, told apart by their magic) ->
    (H, W, 3) uint8, as PIL's ``Image.open(...).convert("RGB")``."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data)
    raise UnsupportedImage("not a PNG, JPEG, BMP or WebP file")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray,
               filters: Optional[Iterable[int]] = None) -> bytes:
    """(H, W) grey or (H, W, 3) RGB uint8 -> PNG bytes, every row with
    filter None unless ``filters`` gives each row's type (0-4)."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    ctype = {2: 0, 3: 2}[img.ndim]
    h, w = img.shape[:2]
    bpp = 1 if ctype == 0 else 3
    rows = img.reshape(h, w * bpp).astype(np.int32)
    ftypes = np.zeros(h, np.uint8) if filters is None else \
        np.asarray(list(filters), np.uint8)
    lines = []
    prev = np.zeros(w * bpp, np.int32)
    for r in range(h):
        x = rows[r]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        p = a + prev - c
        pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) >> 1, paeth)[int(ftypes[r])]
        lines.append(bytes([ftypes[r]]) + ((x - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = x
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(b"".join(lines), 6))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# PIL's bilinear resize
# ---------------------------------------------------------------------------

def _coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` for the bilinear filter and
    ``normalize_coeffs_8bpc``: (first input index, fixed-point weights
    (out_size, ksize)) of each output position."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        ww = 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            kk[xx, x] = 1.0 - t if t < 1.0 else 0.0
            ww += kk[xx, x]
        if ww != 0.0:
            kk[xx, :xmax] /= ww
        first[xx] = xmin
    fixed = np.where(kk < 0, -0.5 + kk * (1 << _PRECISION_BITS),
                     0.5 + kk * (1 << _PRECISION_BITS))
    return first, np.trunc(fixed).astype(np.int64)


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass of PIL's resampling along ``axis`` (0 rows, 1
    columns) of an (H, W, C) uint8 image."""
    first, k = _coeffs(img.shape[axis], out_size)
    idx = np.minimum(first[:, None] + np.arange(k.shape[1]),
                     img.shape[axis] - 1)             # zero weights past
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (n, ..., C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for t in range(k.shape[1]):
        acc += src[idx[:, t]] * k[:, t].reshape((-1,) + (1,) *
                                                (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C), as PIL's
    ``Image.resize((width, height), Image.BILINEAR)``."""
    if img.shape[1] != width:
        img = _resample(img, width, axis=1)
    if img.shape[0] != height:
        img = _resample(img, height, axis=0)
    return img


# ---------------------------------------------------------------------------
# the JAX module's interface
# ---------------------------------------------------------------------------

def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def load_image(path: str, image_size: Optional[int] = None) -> np.ndarray:
    """-> (H, W, 3) float32 in [-1, 1]."""
    img = read_image(path)
    if image_size is not None and img.shape[:2] != (image_size, image_size):
        img = resize_bilinear(img, image_size, image_size)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0


def load_image_batch(paths: Sequence[str], data_path: str = "",
                     image_size: Optional[int] = None,
                     subdir: str = "0") -> np.ndarray:
    """A minibatch of images by file name -> (b, H, W, 3) in [-1, 1].
    Names resolve under ``{data_path}/{subdir}/{name}``; absolute paths
    and paths that exist are used as they are."""
    full_paths = []
    for p in paths:
        full = p
        if not os.path.isabs(p) and not os.path.exists(p):
            full = os.path.join(data_path, subdir, p)
        full_paths.append(full)
    return np.stack([load_image(p, image_size) for p in full_paths])


def list_image_folder(root: str) -> List[str]:
    """All image files under an ImageFolder-style root (class subdirs, or
    a flat dir), sorted — the JAX package's walk."""
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp"}
    files = []
    for dirpath, _, names in os.walk(root):
        for n in sorted(names):
            if os.path.splitext(n)[1].lower() in exts:
                files.append(os.path.join(dirpath, n))
    return sorted(files)


class ImageFolderDataset:
    """Fixed-size shuffled batches of normalised NHWC images, the batches
    and order of the JAX package's (``default_rng((seed, epoch))``)."""

    def __init__(self, root: str, image_size: int, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.files = list_image_folder(root)
        if not self.files:
            raise FileNotFoundError(f"no images under {root!r}")
        self.image_size = image_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.files)
        if self.drop_last and n >= self.batch_size:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int = 0):
        order = np.arange(len(self.files))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idx) < self.batch_size:  # wrap the ragged tail
                idx = np.concatenate([idx, order[:self.batch_size - len(idx)]])
            yield np.stack([load_image(self.files[i], self.image_size)
                            for i in idx])

    def __iter__(self):
        return self.epoch(0)


def to_uint8(images, normalize: bool = True) -> np.ndarray:
    """(..., H, W, C) float -> uint8. ``normalize=True`` rescales by the
    batch min/max like torchvision's save_image(normalize=True);
    otherwise assumes [-1, 1]."""
    if hasattr(images, "detach"):
        images = images.detach().float().cpu().numpy()
    x = np.asarray(images, dtype=np.float32)
    if normalize:
        lo, hi = float(x.min()), float(x.max())
        x = (x - lo) / max(hi - lo, 1e-8)
    else:
        x = (x + 1.0) / 2.0
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_image_grid(images, path: str, nrow: int = 8,
                    normalize: bool = True, padding: int = 2) -> None:
    """Tile (b, H, W, C) into a row-major grid PNG, the JAX package's
    layout."""
    x = to_uint8(images, normalize=normalize)
    b, h, w, c = x.shape
    ncol = min(nrow, b)
    nrows = math.ceil(b / ncol)
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), np.uint8)
    for i in range(b):
        r, col = divmod(i, ncol)
        y0 = r * (h + padding) + padding
        x0 = col * (w + padding) + padding
        grid[y0:y0 + h, x0:x0 + w] = x[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
