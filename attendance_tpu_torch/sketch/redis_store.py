"""Redis Stack sketch store (``--sketch-backend=redis``, import-gated).

Counterpart of ``attendance_tpu/sketch/redis_store.py``: a thin adapter
over redis-py matching the reference's usage, used by the parity
harness when a Redis Stack server is reachable. Nothing else imports
this module unless the backend is selected.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from attendance_tpu_torch.sketch.base import ResponseError, SketchStore

try:
    import redis as _redis
    HAVE_REDIS = True
except ImportError:  # pragma: no cover - environment without redis-py
    _redis = None
    HAVE_REDIS = False

_BATCH = 512  # members per BF.MADD/MEXISTS chunk


def _translated(fn):
    """Re-raise redis.exceptions.ResponseError as the facade's
    ResponseError so callers (processor bootstrap, parity harness) catch
    ONE exception type across every backend."""
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except _redis.exceptions.ResponseError as e:
            raise ResponseError(str(e)) from e
    return wrapper


class RedisSketchStore(SketchStore):
    def __init__(self, config):
        if not HAVE_REDIS:
            raise RuntimeError(
                "sketch_backend='redis' requires the redis-py package")
        super().__init__(config)
        self.client = _redis.Redis(
            host=config.redis_host, port=config.redis_port,
            decode_responses=True)

    # The public surface forwards wholesale; the local-filter primitives
    # are never reached.
    def _filter_create(self, params):  # pragma: no cover
        raise NotImplementedError

    def _filter_add(self, handle, params, keys):  # pragma: no cover
        raise NotImplementedError

    def _filter_contains(self, handle, params, keys):  # pragma: no cover
        raise NotImplementedError

    def _hll_add(self, key, keys_u32, mask=None,
                 want_changed=True):  # pragma: no cover
        raise NotImplementedError

    def _hll_count(self, keys):  # pragma: no cover
        raise NotImplementedError

    @_translated
    def execute_command(self, *args):
        return self.client.execute_command(*args)

    @_translated
    def bf_reserve(self, key, error_rate, capacity):
        return self.client.execute_command(
            "BF.RESERVE", key, error_rate, capacity)

    def bf_add_many(self, key: str, members) -> np.ndarray:
        out = []
        members = list(np.asarray(members).tolist())
        pipe = self.client.pipeline()
        for i in range(0, len(members), _BATCH):
            pipe.execute_command("BF.MADD", key, *members[i:i + _BATCH])
        for res in pipe.execute():
            out.extend(int(x) for x in res)
        return np.array(out, dtype=np.int64)

    def bf_exists_many(self, key: str, members) -> np.ndarray:
        out = []
        members = list(np.asarray(members).tolist())
        pipe = self.client.pipeline()
        for i in range(0, len(members), _BATCH):
            pipe.execute_command("BF.MEXISTS", key, *members[i:i + _BATCH])
        for res in pipe.execute():
            out.extend(bool(int(x)) for x in res)
        return np.array(out, dtype=bool)

    def pfadd(self, key: str, *members) -> int:
        return int(self.client.pfadd(key, *members))

    def pfadd_many(self, key: str, members,
                   mask: Optional[np.ndarray] = None,
                   want_changed: bool = False) -> int:
        members = np.asarray(members)
        if mask is not None:
            members = members[mask]
        changed = 0
        members = list(members.tolist())
        pipe = self.client.pipeline()
        for i in range(0, len(members), _BATCH):
            pipe.pfadd(key, *members[i:i + _BATCH])
        for res in pipe.execute():
            changed |= int(res)
        return changed

    def pfcount(self, *keys: str) -> int:
        return int(self.client.pfcount(*keys))

    def flush(self) -> None:
        self.client.flushall()

    def close(self) -> None:
        self.client.close()
