"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

All of `csrc/*.cu` is compiled in one `nvcc` call into
`vi_slam_tpu_torch/_build/<hash>/libvst_kernels.so`, where the hash covers
the sources and the flags. The sources use plain C interfaces and include
no PyTorch header, so the build takes seconds. `load_library` builds at
most once per process and is called only when a kernel is first launched;
importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libvst_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, $CUDA_PATH/bin/nvcc, /usr/local/cuda/bin/nvcc,
    then `nvcc` on PATH; raises if there is none."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda, PATH)"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return srcs


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0 when the library was already built
    log: str  # nvcc's output, with ptxas's register and shared-memory use


def build() -> BuildResult:
    """Compile csrc/*.cu into the shared library unless it already exists.
    Raises with nvcc's output if the compile fails."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return BuildResult(lib, seconds, log)


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (once per process) and load the kernel library. Each wrapper
    declares the argument types of the launcher it calls."""
    return ctypes.CDLL(str(build().path))
