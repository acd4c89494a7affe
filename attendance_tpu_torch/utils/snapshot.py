"""Durable writes of the snapshot chain.

Counterpart of ``attendance_tpu/utils/snapshot.py:125-180``: an npz
published by tmp write + fsync + atomic rename (returning the digest of
its clean bytes), a directory fsync, and the manifest write whose rename
is a chain snapshot's durability point.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

from attendance_tpu_torch.utils.integrity import file_digest


def fsync_write_npz(path, arrays: Dict) -> str:
    """Durably publish one npz: tmp write + fsync + atomic rename.
    Returns the hex sha256 of the published bytes, computed off the tmp
    file before the rename."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    digest = file_digest(tmp)
    tmp.replace(path)
    return digest


def fsync_dir(dir_path) -> None:
    """fsync a directory: a rename or unlink inside it is durable only
    once the directory entry is."""
    dir_fd = os.open(Path(dir_path), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def write_manifest_atomic(dir_path, doc: Dict, name: str) -> None:
    """tmp + fsync + rename + directory fsync of a JSON manifest: the
    rename IS a chain snapshot's durability point."""
    dir_path = Path(dir_path)
    path = dir_path / name
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)
    fsync_dir(dir_path)
