"""Prepared-IR caches — the expensive-artifact "checkpoints" (counterpart
of convopeq_tpu/engine/cache.py; the port's own host copy).

Rebuild of the reference's cache plane:
- CacheManager (src/CacheManager.{h,cpp}): prepared-IR cache keyed by
  content hash + build parameters, LRU with max 10 entries.
- MixedPhasePersistentCache (src/MixedPhasePersistentCache.{h,cpp}):
  on-disk cache of mixed-phase conversion results keyed by
  (fileHash, sampleRate, mode, f1, f2, length), LRU-evicted.

Here: an in-RAM LRU for prepared NUC states (device tensors) and a disk
.npz LRU for mixed-phase IRs, by default under the port's own directory
(~/.cache/convopeq_tpu_torch/mixedphase), never the JAX package's.
"""
from __future__ import annotations

import hashlib
import os
from collections import OrderedDict
from pathlib import Path

import numpy as np

MAX_RAM_ENTRIES = 10        # CacheManager.h:34-72 (LRU max 10)
MAX_DISK_ENTRIES = 10


def content_hash(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:32]


class LRUCache:
    """In-RAM LRU (prepared NUC states / compiled chains)."""

    def __init__(self, max_entries: int = MAX_RAM_ENTRIES):
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()

    def get(self, key):
        if key in self._d:
            self._d.move_to_end(key)
            return self._d[key]
        return None

    def put(self, key, value):
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            self._d.popitem(last=False)

    def __len__(self):
        return len(self._d)

    def clear(self):
        self._d.clear()


class MixedPhaseDiskCache:
    """Persistent mixed-phase IR cache (MixedPhasePersistentCache.h:17-52).

    Key: (ir content hash, sample rate, mode, f1, f2, length)."""

    def __init__(self, directory: str | os.PathLike | None = None,
                 max_entries: int = MAX_DISK_ENTRIES):
        self.dir = Path(directory) if directory else (
            Path.home() / ".cache" / "convopeq_tpu_torch" / "mixedphase")
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_entries = max_entries

    def _path(self, key: str) -> Path:
        return self.dir / f"{key}.npz"

    @staticmethod
    def make_key(ir: np.ndarray, sample_rate: float, mode: str,
                 f1: float, f2: float) -> str:
        return content_hash(ir, sample_rate, mode, f1, f2, ir.shape[-1])

    def load(self, key: str) -> np.ndarray | None:
        p = self._path(key)
        if not p.exists():
            return None
        try:
            with np.load(p) as z:
                data = z["ir"]
            os.utime(p)           # touch for LRU ordering
            return data
        except Exception:
            return None

    def store(self, key: str, ir: np.ndarray) -> None:
        np.savez_compressed(self._path(key), ir=np.asarray(ir))
        self._evict()

    def _evict(self) -> None:
        entries = sorted(self.dir.glob("*.npz"), key=lambda p: p.stat().st_mtime)
        while len(entries) > self.max_entries:
            try:
                entries[0].unlink()
            except OSError:
                pass
            entries = entries[1:]
