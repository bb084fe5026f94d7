"""Build and load the port's CUDA kernels.

Every kernel is a ``csrc/*.cu`` file with a plain C entry point, compiled
by ``nvcc`` for ``sm_90a`` into a shared library under ``build/kernels/``
at the repository root on first use, and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). The library's
file name carries a hash of its source, so an edited kernel is rebuilt
and a stale one is never loaded. ``build_all`` starts one nvcc per
source, all at once, and waits for them together. Nothing here runs at
import time.

    python -m dalle_pytorch_tpu_torch.ops.build     # build every kernel
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {"paged_attention": "paged_attention.cu",
                           "flash_attention": "flash_attention.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every kernel in ``names`` whose library does not exist,
    one nvcc process per source, all started together; returns each
    library's path. Raises with the compiler's output if any nvcc
    fails (after every process has ended)."""
    out = {name: library_path(name) for name in names}
    todo = [name for name, path in out.items() if not path.exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        running.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out[name])    # atomic: a racing build just wins
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return out


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library exists; returns the
    library's path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    return ctypes.CDLL(str(build(name)))


if __name__ == "__main__":
    for kernel, path in build_all().items():
        print(kernel, path)
