"""Build `csrc/filterbank.cu` into a shared library, at first use.

The source has a plain C interface and is compiled by `nvcc` for Hopper
(`sm_90a`) into `_build/libfilterbank-<hash>.so`, where the hash covers the
source and the flags, so an edited source is rebuilt and a built one is
reused.  `library()` builds it if needed and loads it with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

SOURCE = pathlib.Path(__file__).parent / "csrc" / "filterbank.cu"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    """The `nvcc` of the CUDA toolkit: $CUDA_HOME, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
            return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(set CUDA_HOME)")
    return found


def target() -> pathlib.Path:
    """Where the library for the current source and flags is (or will be) built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfilterbank-{digest.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, str]:
    """Compile the source unless it is built already.

    Returns (library path, compiler output); the output is empty when the
    library was already built.  Raises with the compiler's output if it fails.
    """
    path = target()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCE.name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path, log


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built filterbank kernels, loaded (built first if needed)."""
    return ctypes.CDLL(str(build()[0]))
