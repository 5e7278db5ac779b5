"""On-disk shard cache with checksum verification (``repro.data.cache``).

The cache materializes a :class:`~repro_torch.data.source.Source` once
and serves later runs from disk (the paper's cached input pipeline). A
partial or corrupt cache (a preempted build, a torn write, bit rot) must
never be trained on silently, so:

- each shard is written to a temp file, fsynced and renamed into place;
  the ledger (shard names, sha256 checksums, the source's fingerprint)
  is committed last, so a crashed build leaves no ledger and the next
  run rebuilds;
- ``check_cache`` recomputes the checksums against the ledger and
  reports missing and corrupt shards; ``ShardCache.ensure`` raises
  :class:`CacheCorruptError` instead of returning bad data;
- a ledger whose fingerprint differs from the source's raises
  :class:`CacheMismatchError`.

The files are the reference's (``shard_00000.npz`` holding
``"<batch>.<field>"`` arrays, ``ledger.json`` version 1), so a cache
directory built by either package is read by the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
from typing import Dict, List, Optional

import numpy as np

LEDGER = "ledger.json"
_VERSION = 1


class CacheError(RuntimeError):
    """Base class for shard-cache failures."""


class CacheCorruptError(CacheError):
    """The ledger promises shards the directory cannot deliver intact."""


class CacheMismatchError(CacheError):
    """The cache was built from a different source (seed or geometry)."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _shard_name(i: int) -> str:
    return f"shard_{i:05d}.npz"


def _write_atomic(path: str, payload: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _pack_shard(batches: List[Dict[str, np.ndarray]]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{f"{i}.{k}": v
                     for i, b in enumerate(batches) for k, v in b.items()})
    return buf.getvalue()


def _unpack_shard(path: str) -> List[Dict[str, np.ndarray]]:
    with np.load(path) as data:
        grouped: Dict[int, Dict[str, np.ndarray]] = {}
        for key in data.files:
            idx, _, field = key.partition(".")
            grouped.setdefault(int(idx), {})[field] = data[key]
    return [grouped[i] for i in sorted(grouped)]


@dataclasses.dataclass(frozen=True)
class CacheStatus:
    """What the ledger promised against what the directory holds."""

    exists: bool
    n_shards: int = 0
    missing: tuple = ()
    corrupt: tuple = ()

    @property
    def ok(self) -> bool:
        return self.exists and not self.missing and not self.corrupt


def check_cache(directory: str) -> CacheStatus:
    """Verify a cache directory against its ledger (sha256 per shard)."""
    ledger_path = os.path.join(directory, LEDGER)
    if not os.path.exists(ledger_path):
        return CacheStatus(exists=False)
    with open(ledger_path) as f:
        ledger = json.load(f)
    missing, corrupt = [], []
    for entry in ledger["shards"]:
        path = os.path.join(directory, entry["name"])
        if not os.path.exists(path):
            missing.append(entry["name"])
        elif _sha256(path) != entry["sha256"]:
            corrupt.append(entry["name"])
    return CacheStatus(exists=True, n_shards=len(ledger["shards"]),
                       missing=tuple(missing), corrupt=tuple(corrupt))


class ShardCache:
    """Read-through shard store bound to one directory: ``ensure(source)``
    builds the cache if it has no ledger (shards first, ledger last) and
    verifies it otherwise; ``shard(i)`` then reads from disk. Every
    verification failure raises."""

    def __init__(self, directory: str):
        self.directory = directory
        self._ledger: Optional[dict] = None

    def ensure(self, source, *, verify: bool = True) -> "ShardCache":
        ledger_path = os.path.join(self.directory, LEDGER)
        if not os.path.exists(ledger_path):
            self._build(source)
            return self
        with open(ledger_path) as f:
            ledger = json.load(f)
        if ledger.get("fingerprint") != source.fingerprint():
            raise CacheMismatchError(
                f"{self.directory}: cache was built from a different "
                f"source: cached {ledger.get('fingerprint')} vs "
                f"requested {source.fingerprint()}")
        if verify:
            status = check_cache(self.directory)
            if not status.ok:
                raise CacheCorruptError(
                    f"{self.directory}: cache failed verification — "
                    f"missing {list(status.missing)}, corrupt "
                    f"{list(status.corrupt)}; delete the directory to "
                    "rebuild")
        self._ledger = ledger
        return self

    def _build(self, source) -> None:
        os.makedirs(self.directory, exist_ok=True)
        shards = []
        for i in range(source.n_shards):
            name = _shard_name(i)
            batches = source.shard(i)
            payload = _pack_shard(batches)
            _write_atomic(os.path.join(self.directory, name), payload)
            shards.append({"name": name,
                           "sha256": hashlib.sha256(payload).hexdigest(),
                           "n_batches": len(batches)})
        ledger = {"version": _VERSION, "fingerprint": source.fingerprint(),
                  "shards": shards}
        # the ledger commits last: a crash mid-build leaves shards but no
        # ledger, and the next ensure() rebuilds
        _write_atomic(os.path.join(self.directory, LEDGER),
                      json.dumps(ledger, indent=1).encode())
        self._ledger = ledger

    def _opened(self) -> dict:
        if self._ledger is None:
            raise CacheError("ShardCache not opened; call ensure() first")
        return self._ledger

    @property
    def n_shards(self) -> int:
        return len(self._opened()["shards"])

    def shard(self, i: int) -> List[Dict[str, np.ndarray]]:
        entry = self._opened()["shards"][i]
        return _unpack_shard(os.path.join(self.directory, entry["name"]))

    def fingerprint(self) -> Dict:
        return self._opened()["fingerprint"]
