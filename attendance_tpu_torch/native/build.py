"""Build the port's native host pack (``hostpipe.c``) with the system C
compiler.

The library is built on first use into ``build/native/`` at the
repository root, named by a hash of the sources, the flags and the
compiler (its path and version line), so an edited source or another
compiler rebuilds and an unchanged one is reused. The flags leave out
``-march=native``: ``build/`` may move between hosts, and a library
tuned for another CPU can die there on an illegal instruction. The
compiler is ``$CC`` when set, else the first of ``cc``, ``gcc`` and
``clang`` on the PATH.

When ``sysconfig``'s include directory holds ``Python.h`` the library is
``hostpipe_py.c``, which includes ``hostpipe.c`` and adds the CPython
list scan (``atp_parse_json_list``); its name carries ``-py`` and its
hash the include directory too. Without the header the library is
``hostpipe.c`` alone and has no list scan. A missing compiler or a
failed build raises with the compiler's output (never a quiet fallback
to a build without the list scan); only ``ATP_NATIVE=0`` selects the
numpy pack (``native.load``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "hostpipe.c"
SOURCE_PY = _PKG / "native" / "hostpipe_py.c"
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


def python_include() -> Optional[str]:
    """The directory holding ``Python.h``, or None when the interpreter's
    headers are not installed."""
    inc = sysconfig.get_paths().get("include")
    if inc and (Path(inc) / "Python.h").exists():
        return inc
    return None


def library_path(cc: str, include: Optional[str] = None) -> Path:
    """Where the library for these sources, these flags, ``cc`` and (for
    the list-scan build) the Python include directory lives."""
    version = subprocess.run([cc, "--version"], capture_output=True,
                             text=True).stdout.partition("\n")[0]
    h = hashlib.sha256("\0".join((cc, version, *CFLAGS)).encode())
    h.update(SOURCE.read_bytes())
    if include is None:
        return BUILD_DIR / f"libhostpipe-{h.hexdigest()[:16]}.so"
    h.update(b"\0" + include.encode() + b"\0")
    h.update(SOURCE_PY.read_bytes())
    return BUILD_DIR / f"libhostpipe-py-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the host pack (with the list scan when ``Python.h`` is
    there) unless a library for these sources, these flags and this
    compiler exists; returns its path. Raises with the compiler's
    output on failure."""
    cc = compiler()
    include = python_include()
    out = library_path(cc, include)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if include is None:
        cmd = [cc, *CFLAGS, "-o", str(tmp), str(SOURCE)]
    else:
        cmd = [cc, *CFLAGS, f"-I{include}", "-o", str(tmp), str(SOURCE_PY)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host pack build failed ({cc}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    tmp.replace(out)  # atomic: a concurrent build never loads a partial
    return out
