"""Build the port's native host pack (``hostpipe.c``) with the system C
compiler.

The library is built on first use into ``build/native/`` at the
repository root, named by a hash of the source, the flags and the
compiler (its path and version line), so an edited source or another
compiler rebuilds and an unchanged one is reused. The flags leave out
``-march=native``: ``build/`` may move between hosts, and a library
tuned for another CPU can die there on an illegal instruction. The
compiler is ``$CC`` when set, else the first of ``cc``, ``gcc`` and
``clang`` on the PATH. A missing compiler or a failed build raises with
the compiler's output; only ``ATP_NATIVE=0`` selects the numpy pack
(``native.load``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "hostpipe.c"
BUILD_DIR = _PKG.parent / "build" / "native"
CFLAGS = ("-O3", "-std=c17", "-shared", "-fPIC", "-pthread")


def compiler() -> str:
    """Full path of the C compiler; raises when there is none."""
    wanted = os.environ.get("CC")
    for cc in ((wanted,) if wanted else ("cc", "gcc", "clang")):
        found = shutil.which(cc)
        if found:
            return found
    raise RuntimeError(
        f"no C compiler ({wanted or 'cc, gcc or clang'}) for the native "
        "host pack; set CC, or ATP_NATIVE=0 for the numpy pack")


def library_path(cc: str) -> Path:
    """Where the library for this source, these flags and ``cc`` lives."""
    version = subprocess.run([cc, "--version"], capture_output=True,
                             text=True).stdout.partition("\n")[0]
    h = hashlib.sha256("\0".join((cc, version, *CFLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libhostpipe-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host pack unless a library for this source, these flags
    and this compiler exists; returns its path. Raises with the
    compiler's output on failure."""
    cc = compiler()
    out = library_path(cc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host pack build failed ({cc}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)  # atomic: a concurrent build never loads a partial
    return out
