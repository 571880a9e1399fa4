"""Build the port's native sources into shared libraries, at first use.

Each source has a plain C interface and becomes one library,
`_build/lib<name>-<hash>.so`, where the hash covers the flags, the source
and the headers it includes by `#include "..."` (`csrc/fft.cuh`, shared by
the analysis and the synthesis; `utils/csrc/audio.cpp` includes the WAV
I/O and the corpus loader sources, which become one library), so an
edited source or header is rebuilt and a built one is reused.  The CUDA
sources (`csrc/*.cu`) are compiled by `nvcc` for Hopper (`sm_90a`); the
host code (the WFST core `asr/fsm/csrc/wfst.cpp`, the audio library
`utils/csrc/audio.cpp`) by `g++` with the flags of `native/Makefile`
(its `-lpthread` as `-pthread`: the streamer and the loader run threads).  `library(name)` builds a source if needed and loads it
with ctypes; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

PACKAGE = pathlib.Path(__file__).resolve().parents[2]
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread")
# name -> (source, compiler)
SOURCES = {
    "analysis": (PACKAGE / "ops" / "cuda" / "csrc" / "analysis.cu", "nvcc"),
    "filterbank": (PACKAGE / "ops" / "cuda" / "csrc" / "filterbank.cu", "nvcc"),
    "select": (PACKAGE / "ops" / "cuda" / "csrc" / "select.cu", "nvcc"),
    "gsc": (PACKAGE / "ops" / "cuda" / "csrc" / "gsc.cu", "nvcc"),
    "steering": (PACKAGE / "ops" / "cuda" / "csrc" / "steering.cu", "nvcc"),
    "viterbi": (PACKAGE / "ops" / "cuda" / "csrc" / "viterbi.cu", "nvcc"),
    "traceback": (PACKAGE / "ops" / "cuda" / "csrc" / "traceback.cu", "nvcc"),
    "wfst": (PACKAGE / "asr" / "fsm" / "csrc" / "wfst.cpp", "g++"),
    "audio": (PACKAGE / "utils" / "csrc" / "audio.cpp", "g++"),
}


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


def gxx() -> str:
    """The host C++ compiler: $CXX, or `g++` on PATH."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("g++ not found: the WFST core and the audio library need a "
                           "C++17 compiler (set CXX)")
    return found


def _command(name: str) -> list[str]:
    source, compiler = SOURCES[name]
    if compiler == "nvcc":
        return [nvcc(), *NVCC_FLAGS, str(source)]
    return [gxx(), *GXX_FLAGS, str(source)]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(path: pathlib.Path) -> list[pathlib.Path]:
    """`path` and the files it includes by `#include "..."`, found beside the
    including file, recursively, each once, in the order first met."""
    seen: list[pathlib.Path] = []
    todo = [path]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        todo += [p.parent / inc.decode() for inc in _INCLUDE.findall(p.read_bytes())
                 if (p.parent / inc.decode()).exists()]
    return seen


def target(name: str) -> pathlib.Path:
    """Where the library of source `name` for its current text, the headers
    it includes and the flags is (or will be) built."""
    source, compiler = SOURCES[name]
    flags = NVCC_FLAGS if compiler == "nvcc" else GXX_FLAGS
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources_of(source):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile source `name` unless it is built already.

    Returns (library path, compiler output); the output is empty when the
    library was already built.  Raises with the compiler's output if it fails.
    """
    path = target(name)
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*_command(name), "-o", str(tmp)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCES[name][0].name} failed "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)
    return path, log


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The built library of source `name`, loaded (built first if needed)."""
    return ctypes.CDLL(str(build(name)[0]))
