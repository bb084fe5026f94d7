"""Native runtime pieces of the port, bound over a plain C ABI with
ctypes: JPEG decoding through libjpeg.

Port of the JPEG half of ``dalle_pytorch_tpu/native/`` (``loader.cc``,
``build.py``, ``__init__.py:28-114``). ``decode_jpeg`` turns JPEG bytes
into (H, W, 3) uint8 RGB, the pixels PIL's ``.convert("RGB")`` gives;
``data/images.py`` resizes them with its copy of PIL's bilinear filter,
so the two packages' images agree bit for bit. The library is built with
g++ on first use (``native/build.py``). Where g++ or libjpeg is missing,
``decode_jpeg`` raises ``build.BuildError`` naming what is missing; there
is no other JPEG path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib = None
_lib_path: Optional[str] = None


def load_library() -> ctypes.CDLL:
    """The loader library, built first if needed (one build and one
    dlopen a process, under a lock: data-loader threads may race here).
    Raises ``build.BuildError``."""
    from dalle_pytorch_tpu_torch.native import build
    global _lib, _lib_path
    with _lock:
        path = str(build.library_path())
        if _lib is not None and _lib_path == path:
            return _lib
        try:
            # racelint: disable=RL003 — the lock exists precisely to
            # serialize this one-time compile (double-checked dlopen);
            # nothing else contends on it during a build
            lib = ctypes.CDLL(str(build.build()))
        except OSError:
            # a library copied from another machine may name a libjpeg
            # this one lacks: build it here, once
            try:
                # racelint: disable=RL003 — the same one-time compile,
                # serialized by the same lock
                lib = ctypes.CDLL(str(build.build(force=True)))
            except OSError as e:
                raise build.BuildError(
                    f"the native JPEG loader does not load against this "
                    f"machine's libjpeg: {e}") from e
        lib.dtl_jpeg_header.restype = ctypes.c_int
        lib.dtl_jpeg_header.argtypes = [
            ctypes.c_char_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
        lib.dtl_jpeg_decode.restype = ctypes.c_int
        lib.dtl_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_ulong, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        _lib, _lib_path = lib, path
        return lib


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB. Raises ``ValueError`` on a
    corrupt or unsupported file (libjpeg's message), ``build.BuildError``
    where the loader cannot be built."""
    lib = load_library()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    if lib.dtl_jpeg_header(data, len(data), ctypes.byref(w),
                           ctypes.byref(h), err, len(err)) != 0:
        raise ValueError(f"bad JPEG: {err.value.decode(errors='replace')}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.dtl_jpeg_decode(data, len(data), out.ctypes.data, w.value,
                           h.value, err, len(err)) != 0:
        raise ValueError(f"bad JPEG: {err.value.decode(errors='replace')}")
    return out


__all__ = ["decode_jpeg", "load_library"]
