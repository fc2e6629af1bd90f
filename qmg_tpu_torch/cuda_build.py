"""Build a source of ``csrc/`` into a shared library and load it.

Sources have a plain C interface. The CUDA ones are compiled by ``nvcc``
for Hopper (``sm_90a``), the host ones (``*.cpp``) by the host C++
compiler; both at first use, into ``qmg_tpu_torch/_build/`` under a name
keyed by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads at once. There is no fallback: without the
compiler the build raises, naming it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# No contraction into fused multiply-adds: the host sources reproduce
# qmg_tpu/native's results bit for bit, and that library is built so.
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of qmg_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def find_cxx() -> str:
    """Path of the host C++ compiler: $CXX, else ``c++`` or ``g++`` on
    PATH."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler found ($CXX, c++, g++): the host sources of "
        "qmg_tpu_torch/csrc are built at first use")


def build_library(source: str):
    """Compile ``csrc/<source>`` (if not built yet) and return
    (ctypes.CDLL, build seconds; 0.0 when the library was already built).
    ``*.cu`` goes through nvcc, ``*.cpp`` through the host compiler."""
    src_path = os.path.join(CSRC_DIR, source)
    host = source.endswith(".cpp")
    flags = CXX_FLAGS if host else NVCC_FLAGS
    with open(src_path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    lib_path = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    seconds = 0.0
    if not os.path.exists(lib_path):
        compiler = find_cxx() if host else find_nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([compiler, *flags, "-o", tmp, src_path],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{compiler} failed on {source}:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        seconds = time.perf_counter() - t0
    return ctypes.CDLL(lib_path), seconds
