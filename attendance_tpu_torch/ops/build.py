"""Build and load the port's CUDA kernels (nvcc + ctypes).

The kernels in ``attendance_tpu_torch/csrc`` expose a plain C interface,
so they compile in seconds with ``nvcc`` alone (no PyTorch headers) and
bind through :mod:`ctypes`. The library is built on first use into
``build/kernels/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. The compiler's resource report (``-Xptxas -v``: registers,
shared memory, spills per kernel) is kept beside the library as
``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "sketch_kernels.cu",)
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# name -> argtypes of every C entry point (see csrc/sketch_kernels.cu).
SIGNATURES = {
    "atp_hll_histogram": (_P, _P, _I, _I, _I, _P),
    "atp_hll_histogram_rows": (_P, _I, _I, _P, _I, _I, _P, _P),
    "atp_hll_union_histogram": (_P, _I, _I, _P, _I, _I, _P, _P),
    "atp_fused_step": (_P, _I, _I, _I, _P, _U, _I, _P, _I, _I, _P, _P, _P),
    "atp_fused_step_seg": (_P, _I, _I, _I, _P, _U, _I, _P, _I, _I, _P, _P,
                           _P),
    "atp_fused_step_delta": (_P, _I, _I, _I, _P, _P, _U, _I, _P, _I, _I,
                             _P, _P, _P),
    "atp_bloom_add": (_P, _P, _I, _U, _I, _I, _I, _P, _P),
    "atp_bloom_contains": (_P, _U, _I, _P, _I, _P, _P),
    "atp_hll_add": (_P, _I, _I, _P, _P, _P, _I, _P),
    "atp_cms_step": (_P, _I, _U, _P, _P, _I, _P, _P),
    "atp_bloom_add_bytes": (_P, _U, _I, _I, _P, _P, _I, _I, _P, _P),
    "atp_bloom_contains_bytes": (_P, _U, _I, _I, _P, _I, _P, _P, _P),
    "atp_bloom_pack_bytes": (_P, _U, _P, _P),
    "atp_bloom_contains_slice": (_P, _U, _U, _U, _I, _P, _I, _I, _P, _I,
                                 _P),
    "atp_hll_add_slice": (_P, _I, _I, _U, _I, _P, _P, _I, _P, _I, _I, _P,
                          _P),
    "atp_bloom_add_slice": (_P, _U, _U, _U, _I, _P, _P, _I, _I, _I, _P, _P),
    "atp_decode_seg": (_P, _I, _I, _I, _I, _P, _P, _P),
    "atp_decode_delta": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsketch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    returns its path. Raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    tmp.replace(out)  # atomic: a concurrent build never loads a partial
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with argtypes
    declared so pointers and the stream pass as full 64-bit values."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
