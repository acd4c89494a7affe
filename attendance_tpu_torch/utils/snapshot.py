"""Snapshots of the generic sketch store, and the durable writes of
every snapshot chain.

Counterpart of ``attendance_tpu/utils/snapshot.py``. The durable writes:
an npz published by tmp write + fsync + atomic rename (returning the
digest of its clean bytes), a directory fsync, and the manifest write
whose rename is a chain snapshot's durability point; the fused
pipeline's chain uses them too. Each carries the chaos plane's disk
hooks (``utils.integrity.chaos_pre_write`` before it, ``chaos_post_publish``
after the publish; the digest is always taken from the clean tmp file
first). The generic store's two layouts, byte-compatible with the JAX
package's (each package restores the other's files):

* **One-shot npz** (:func:`snapshot_sketch_store`, and
  :func:`restore_sketch_store` with a file path): every Bloom
  sub-filter's bytes, the HLL registers and a JSON manifest (chain
  params, the HLL name -> bank map), written atomically.
* **Base + delta chain** (:func:`snapshot_sketch_store_chain`, and
  :func:`restore_sketch_store` with a directory): a full base plus
  ``delta-NNNN.npz`` files holding only the keys written since the
  previous snapshot (the store's dirty-key sets), chained by an fsync'd
  ``MANIFEST.json`` whose rename is the durability point; every
  ``compact_every`` deltas the chain folds into a fresh base.

Device state (the card store's tensors) is copied to the host to write
and put back on the store's device to restore.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from attendance_tpu_torch.models.bloom import BloomParams
from attendance_tpu_torch.utils.integrity import (
    ChainIntegrityError, chaos_post_publish, chaos_pre_write, file_digest,
    quarantine_artifact, verify_file)

CHAIN_MANIFEST = "MANIFEST.json"  # the generic store chain's manifest


def _host(arr) -> np.ndarray:
    """A host copy of a device tensor; any other array as it is."""
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.asarray(arr)


def fsync_write_npz(path, arrays: Dict, site: str = "disk.chain") -> str:
    """Durably publish one npz: tmp write + fsync + atomic rename.
    Returns the hex sha256 of the published bytes, computed off the tmp
    file before the rename (and before the chaos rot hook at ``site``
    can mangle the published copy: the recorded digest describes clean
    bytes, so verification notices the rot)."""
    chaos_pre_write(site)
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    digest = file_digest(tmp)
    tmp.replace(path)
    chaos_post_publish(site, path)
    return digest


def fsync_dir(dir_path) -> None:
    """fsync a directory: a rename or unlink inside it is durable only
    once the directory entry is."""
    dir_fd = os.open(Path(dir_path), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def write_manifest_atomic(dir_path, doc: Dict,
                          name: str = CHAIN_MANIFEST) -> None:
    """tmp + fsync + rename + directory fsync of a JSON manifest: the
    rename IS a chain snapshot's durability point."""
    chaos_pre_write("disk.manifest")
    dir_path = Path(dir_path)
    path = dir_path / name
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    tmp.replace(path)
    fsync_dir(dir_path)
    chaos_post_publish("disk.manifest", path)


def _bloom_manifest_entry(chain, key: str, arrays: Dict, tag: str) -> Dict:
    """Serialize one ScalableBloom chain into ``arrays`` (under
    ``{tag}/{key}/{i}`` names) and return its manifest entry; shared by
    the full base and the per-dirty-key delta writers."""
    filters = []
    for i, (handle, params) in enumerate(zip(chain.filters,
                                             chain.params)):
        name = f"{tag}/{key}/{i}"
        arrays[name] = _host(handle)
        filters.append({"array": name, "params": list(params[:2]) + [
            params.layout, params.capacity, params.error_rate]})
    return {
        "base_capacity": chain.base_capacity,
        "base_error": chain.base_error,
        "layout": chain.layout,
        "counts": chain.counts,
        "filters": filters,
    }


def _restore_bloom_key(store, key: str, info: Dict, data) -> None:
    """Rebuild one key's ScalableBloom chain from a manifest entry;
    shared by the one-shot restore and the delta apply."""
    # Imported here: the sketch package's stores import this module's
    # callers, not the other way round.
    from attendance_tpu_torch.sketch.base import ScalableBloom

    chain = ScalableBloom.__new__(ScalableBloom)
    chain.store = store
    chain.base_capacity = info["base_capacity"]
    chain.base_error = info["base_error"]
    chain.layout = info["layout"]
    chain.counts = list(info["counts"])
    chain.filters, chain.params = [], []
    for finfo in info["filters"]:
        m_bits, k, layout, capacity, error_rate = finfo["params"]
        params = BloomParams(int(m_bits), int(k), layout,
                             int(capacity), float(error_rate))
        bits = data[finfo["array"]]
        chain.params.append(params)
        chain.filters.append(store._restore_filter(params, bits))
    store._blooms[key] = chain


def _hll_row(store, key: str):
    """Host copy of one key's HLL registers, or None when the key has
    none: the banked (card), per-key dict (memory) and redis-sim
    layouts."""
    hll = getattr(store, "_hll", None)
    if hll is not None:  # TpuSketchStore: banked device tensor
        bank = hll.bank_index(key, create=False)
        if bank < 0:
            return None
        return _host(hll.regs[bank])
    regs = getattr(store, "_hll_regs", None)
    if regs is None:
        regs = getattr(store, "_hlls", {})
    row = regs.get(key)
    return None if row is None else np.asarray(row)


def _apply_hll_row(store, key: str, row: np.ndarray) -> None:
    hll = getattr(store, "_hll", None)
    if hll is not None:
        bank = hll.bank_index(key)  # creates/grows the bank
        hll.regs[bank] = torch.from_numpy(
            np.array(row, dtype=np.uint8)).to(hll.regs.device)
        return
    regs = getattr(store, "_hll_regs", None)
    if regs is None:
        regs = getattr(store, "_hlls", None)
    regs[key] = np.array(row, dtype=np.uint8)


def _hll_precision(store) -> int:
    hll = getattr(store, "_hll", None)
    if hll is not None:
        return hll.precision
    return getattr(store, "precision", 14)


def snapshot_sketch_store(store, path) -> Dict:
    """Write the store's full sketch state to ``path`` (.npz); returns
    the manifest with the file's digest under ``__digest__``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict = {"blooms": {}, "hll": {}}

    for key, chain in store._blooms.items():
        manifest["blooms"][key] = _bloom_manifest_entry(
            chain, key, arrays, "bloom")

    hll = getattr(store, "_hll", None)
    if hll is not None:  # TpuSketchStore: one banked tensor + name map
        arrays["hll/regs"] = _host(hll.regs)
        manifest["hll"] = {"kind": "banked", "precision": hll.precision,
                           "bank_of": hll._bank_of}
    else:  # MemorySketchStore: dict of per-key register arrays
        regs = getattr(store, "_hll_regs", {})
        for i, (key, arr) in enumerate(regs.items()):
            arrays[f"hll/{i}"] = arr
        manifest["hll"] = {
            "kind": "per_key",
            "precision": getattr(store, "precision", 14),
            "keys": list(regs.keys()),
        }

    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8)
    chaos_pre_write("disk.chain")
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        # fsync before the rename: a chain deletes superseded files once
        # a new base is published, so the base itself must be durable.
        f.flush()
        os.fsync(f.fileno())
    manifest["__digest__"] = file_digest(tmp)
    tmp.replace(path)
    chaos_post_publish("disk.chain", path)
    return manifest


def snapshot_sketch_store_chain(store, dir_path,
                                compact_every: int = 16) -> Dict:
    """Incremental snapshot of a generic SketchStore into ``dir_path``.

    Writes a full base when the chain needs one (fresh directory, a
    structural reset like flush, or ``compact_every`` deltas
    accumulated), otherwise one ``delta-NNNN.npz`` holding only the keys
    written since the last snapshot (the store's drained dirty sets).
    Either way the fsync'd ``MANIFEST.json`` rename is the durability
    point: on return, state up to here is durable (the processor's ack
    barrier). Returns the published manifest."""
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    dirty_all, dirty_blooms, dirty_hll = store.drain_dirty()
    try:
        manifest_path = dir_path / CHAIN_MANIFEST
        chain = None
        if manifest_path.exists():
            try:
                chain = json.loads(manifest_path.read_text())
            except ValueError as exc:
                # The writer's own manifest rotted under it: memory
                # holds the truth, so quarantine the torn manifest and
                # restart the chain with a full base.
                quarantine_artifact(manifest_path, reason="torn_manifest",
                                    detail=str(exc))
                dirty_all = True
        seq = (chain["seq"] if chain else 0) + 1
        if (dirty_all or chain is None
                or len(chain.get("deltas", ())) + 1 >= compact_every):
            base = f"base-{seq:04d}.npz"
            base_manifest = snapshot_sketch_store(store, dir_path / base)
            doc = {"seq": seq, "base": base, "deltas": [],
                   # Payload digests: restore verifies each file against
                   # these before trusting it.
                   "digests": {base: base_manifest["__digest__"]}}
            write_manifest_atomic(dir_path, doc)
            _gc_chain_files(dir_path, keep={base})
            return doc
        name = f"delta-{seq:04d}.npz"
        arrays: Dict[str, np.ndarray] = {}
        manifest: Dict = {"blooms": {}, "hll": {}}
        for key in sorted(dirty_blooms):
            bloom = store._blooms.get(key)
            if bloom is not None:
                manifest["blooms"][key] = _bloom_manifest_entry(
                    bloom, key, arrays, "bloom")
        keys = []
        for key in sorted(dirty_hll):
            row = _hll_row(store, key)
            if row is not None:
                arrays[f"hll/{len(keys)}"] = row
                keys.append(key)
        manifest["hll"] = {"kind": "rows", "keys": keys,
                           "precision": _hll_precision(store)}
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        digest = fsync_write_npz(dir_path / name, arrays)
        chain["seq"] = seq
        chain["deltas"].append(name)
        chain.setdefault("digests", {})[name] = digest
        write_manifest_atomic(dir_path, chain)
        return chain
    except Exception:
        # The drained marks describe writes that never became durable:
        # a caller retrying the barrier would otherwise publish an empty
        # delta and ack events no snapshot holds. Put the marks back and
        # force a full base next time (the disk state is uncertain).
        store._dirty_all = True
        store._dirty_blooms |= dirty_blooms
        store._dirty_hll |= dirty_hll
        raise


def _gc_chain_files(dir_path: Path, keep: set) -> None:
    """Delete superseded base/delta files after the manifest that
    stopped naming them became durable."""
    for p in list(dir_path.glob("base-*.npz")) + \
            list(dir_path.glob("delta-*.npz")):
        if p.name not in keep:
            try:
                p.unlink()
            except OSError:
                pass


def _apply_sketch_delta(store, path) -> None:
    """Fold one delta file into a restored store: replace the chains of
    the Bloom keys it names, overwrite the register rows of the HLL keys
    it names."""
    with np.load(Path(path)) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        for key, info in manifest["blooms"].items():
            _restore_bloom_key(store, key, info, data)
        hinfo = manifest["hll"]
        for i, key in enumerate(hinfo.get("keys", ())):
            _apply_hll_row(store, key, data[f"hll/{i}"])


def restore_sketch_store(store, path) -> None:
    """Load a snapshot into a freshly constructed store (same backend).

    ``path`` is a one-shot npz file, or a chain directory written by
    :func:`snapshot_sketch_store_chain`: then the manifest's base loads
    first and every listed delta is applied in order (delta files the
    manifest does not name are crash orphans and ignored). Every chain
    file with a recorded digest is verified first; a failure raises a
    classified :class:`ChainIntegrityError` (``digest_mismatch`` /
    ``missing`` / ``torn_manifest`` / ``unreadable``), never a silent
    wrong restore.
    """
    p = Path(path)
    if p.is_dir():
        manifest_path = p / CHAIN_MANIFEST
        try:
            manifest = json.loads(manifest_path.read_text())
        except ValueError as exc:  # torn JSON or non-UTF8 bytes
            raise ChainIntegrityError("torn_manifest", manifest_path,
                                      str(exc)) from exc
        digests = manifest.get("digests", {})
        base = manifest["base"]
        if base in digests:
            verify_file(p / base, digests[base])
        try:
            _restore_npz(store, p / base)
        except ChainIntegrityError:
            raise
        except Exception as exc:  # noqa: BLE001 — classify, not crash
            raise ChainIntegrityError(
                "unreadable", p / base,
                f"{type(exc).__name__}: {exc}") from exc
        for name in manifest.get("deltas", ()):
            dpath = p / name
            if name in digests:
                verify_file(dpath, digests[name])
            elif not dpath.exists():
                raise ChainIntegrityError(
                    "missing", dpath,
                    "chain manifest names it but the delta file is "
                    "absent — snapshot directory is corrupt")
            try:
                _apply_sketch_delta(store, dpath)
            except ChainIntegrityError:
                raise
            except Exception as exc:  # noqa: BLE001
                raise ChainIntegrityError(
                    "unreadable", dpath,
                    f"{type(exc).__name__}: {exc}") from exc
    else:
        _restore_npz(store, p)
    if hasattr(store, "mark_clean"):
        # Disk now equals memory: the next chain snapshot appends a delta
        # of new writes instead of a spurious base.
        store.mark_clean()
    # Restore REPLACES the store's filter handles and HLL registers:
    # re-register its health gauges so they read the restored
    # generation (a no-op when the store was never registered or
    # telemetry is down).
    from attendance_tpu_torch.obs.health import reregister_store
    reregister_store(store)


def _restore_npz(store, path) -> None:
    with np.load(Path(path)) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())

        store._blooms.clear()
        for key, info in manifest["blooms"].items():
            _restore_bloom_key(store, key, info, data)

        hinfo = manifest["hll"]
        if hinfo.get("kind") == "banked":
            store._restore_hll_banked(data["hll/regs"], hinfo["bank_of"],
                                      hinfo["precision"])
        elif hinfo.get("kind") == "per_key":
            regs = {key: data[f"hll/{i}"]
                    for i, key in enumerate(hinfo["keys"])}
            store._restore_hll_per_key(regs, hinfo["precision"])
