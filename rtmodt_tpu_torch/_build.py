"""Build the port's native sources and load them with ctypes.

Every ``*.cu`` file in ``csrc/`` (a CUDA kernel, built with plain ``nvcc``)
and every ``*.cpp`` file (host code, built with the host C++ compiler; the
frame packer with ``-march=native``) becomes its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  Libraries go to ``build/kernels-<hash of the
sources and flags>/`` under the repository root (listed in ``.gitignore``),
so an unchanged source is not rebuilt.  A failed build raises with the
compiler's stderr; nothing falls back.

Building is explicit or happens at a library's first use (a kernel's first
launch on a CUDA tensor), never at import.  ``load`` logs the cache hit or
the build at DEBUG.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from rtmodt_tpu_torch.utils.logging import logger

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build")

# -fmad=false: the NMS IoU must round every step as the plain version does
# (the source also uses explicitly rounded intrinsics); no fast math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# Flags of one source only.  The packer's AVX-512 paths compile only where the
# compiler targets AVX-512BW/VL, so it is built for the host it runs on; its
# float rounding is written out in the source, so the compiler fuses nothing.
SOURCE_FLAGS = {"framepack.cpp": ("-march=native", "-ffp-contract=off")}
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Every native source: CUDA (``.cu``) and host C++ (``.cpp``)."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cpp")))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the port's CUDA kernels cannot be built")
    return nvcc


def find_cxx() -> str:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH; the port's host "
                           "sources cannot be built")
    return cxx


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + CXX_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, f"kernels-{h.hexdigest()[:16]}")


def compile_source(src: str, out: str, extra: tuple[str, ...] | None = None) -> None:
    """Compile one source into the shared library ``out``.  ``extra``: flags
    after the common ones (default: the source's ``SOURCE_FLAGS``)."""
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    if extra is None:
        extra = SOURCE_FLAGS.get(os.path.basename(src), ())
    if src.endswith(".cu"):
        cmd = [find_nvcc(), *NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o", tmp, src]
    else:
        cmd = [find_cxx(), *CXX_FLAGS, *extra, "-o", tmp, src]
    tool = os.path.basename(cmd[0])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{tool} timed out after {BUILD_TIMEOUT_S} s on {src}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{tool} failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    with open(out + ".log", "w") as f:   # ptxas register / shared-memory report
        f.write(proc.stderr)
    os.replace(tmp, out)                 # atomic: a concurrent build never sees half a file


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile every source (or those of ``names``) whose library is
    missing, all compiler runs at once.  Returns {library name: seconds} for
    the libraries built in this call."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    todo = []
    for src in sources():
        name = os.path.splitext(os.path.basename(src))[0]
        out = os.path.join(out_dir, f"lib{name}.so")
        if (names is None or name in names) and not os.path.exists(out):
            todo.append((name, src, out))
    if not todo:
        return {}

    def one(item):
        name, src, out = item
        t0 = time.perf_counter()
        compile_source(src, out)
        return name, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        return dict(pool.map(one, todo))


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` or ``.cpp`` (built on
    first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = os.path.join(build_dir(), f"lib{name}.so")
            where = os.path.relpath(path, BUILD_ROOT)
            if os.path.exists(path):
                logger.debug(f"kernel cache hit: {where}")
            else:
                seconds = build_all([name]).get(name, 0.0)
                logger.debug(f"kernel cache store: {where} (built in {seconds:.2f} s)")
            lib = ctypes.CDLL(path)
            _libs[name] = lib
        return lib
