"""Build the native JPEG loader.

``loader.cc`` is one translation unit with a plain C ABI (bound with
ctypes, no CPython headers), compiled by ``g++`` against libjpeg into
``build/kernels/`` at the repository root, beside the CUDA kernels
(``ops/build.py``), never beside the source. The library's name carries
a hash of the source, the flags and the libraries, so an edited loader
is rebuilt and a stale one is never loaded. Nothing here runs at import
time.

    python -m dalle_pytorch_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-ljpeg",)


class BuildError(RuntimeError):
    """The loader cannot be built here: no C++ compiler, or no libjpeg
    (its header or its library)."""


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"jpeg_loader-{h.hexdigest()[:12]}.so"


def build(force: bool = False) -> Path:
    """Compile ``loader.cc`` unless its library exists (``force``: even
    so); returns the library's path. Raises ``BuildError`` with the
    compiler's output."""
    out = library_path()
    if out.exists() and not force:
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") \
        or shutil.which("c++")
    if cxx is None:
        raise BuildError("no C++ compiler (g++) found to build the "
                         "native JPEG loader (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", tmp, *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):        # the linker may have removed it
            os.unlink(tmp)
        raise BuildError(
            f"building the native JPEG loader against libjpeg failed "
            f"(is libjpeg installed: jpeglib.h and {' '.join(LIBS)}?):\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)            # atomic: a racing build just wins
    return out


if __name__ == "__main__":
    try:
        print(build())
    except BuildError as e:
        sys.exit(str(e))
