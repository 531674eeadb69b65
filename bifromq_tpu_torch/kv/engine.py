"""KV engine SPI + in-memory engine (copy of ``bifromq_tpu/kv/engine.py``;
≈ base-kv-local-engine-spi / -memory).

Reference shape: ``IKVEngine`` owns named ``IKVSpace``s (one per range;
column-family-per-space in the RocksDB engine), each with point reads, range
iteration over byte-ordered keys, batched writes, metadata, and either
checkpoints (ICPableKVSpace) or WAL fsync (IWALableKVSpace) — see
base-kv/base-kv-local-engine-spi .../localengine/IKVEngine.java, IKVSpace.java,
ICPableKVSpace.java.

The in-memory engine (≈ localengine/memory/InMemKVEngine.java) is the
port's only engine so far; the durable native engine plugs in behind the
same SPI with its slice (ROADMAP A.5b).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterator, List, Optional, Tuple


class KVWriteBatch:
    """Atomic multi-op write (≈ IKVSpaceWriter)."""

    def __init__(self, space: "IKVSpace") -> None:
        self._space = space
        self._ops: List[Tuple[str, bytes, Optional[bytes]]] = []

    def put(self, key: bytes, value: bytes) -> "KVWriteBatch":
        self._ops.append(("put", key, value))
        return self

    def delete(self, key: bytes) -> "KVWriteBatch":
        self._ops.append(("del", key, None))
        return self

    def delete_range(self, start: bytes, end: bytes) -> "KVWriteBatch":
        self._ops.append(("del_range", start, end))
        return self

    def done(self) -> None:
        self._space._apply(self._ops)
        self._ops = []


class IKVSpace:
    """One named keyspace (≈ IKVSpace): byte-ordered, range-iterable."""

    name: str

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def exists(self, key: bytes) -> bool:
        return self.get(key) is not None

    def iterate(self, start: Optional[bytes] = None,
                end: Optional[bytes] = None,
                reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        """Yield (key, value) with start <= key < end in byte order."""
        raise NotImplementedError

    def writer(self) -> KVWriteBatch:
        return KVWriteBatch(self)

    def size(self, start: Optional[bytes] = None,
             end: Optional[bytes] = None) -> int:
        """Approximate byte size of the range (used by split hinters)."""
        raise NotImplementedError

    def checkpoint(self) -> "IKVSpaceCheckpoint":
        raise NotImplementedError

    def destroy(self) -> None:
        raise NotImplementedError

    # metadata (≈ IKVSpace.metadata(): small control records, e.g. range
    # boundary + raft state, kept separate from data keys)
    def get_metadata(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def put_metadata(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def _apply(self, ops) -> None:
        raise NotImplementedError


class IKVSpaceCheckpoint:
    """Read-only snapshot of a space (≈ IKVSpaceCheckpoint / RocksDB ckpt)."""

    def iterate(self, start: Optional[bytes] = None,
                end: Optional[bytes] = None) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class IKVEngine:
    """Engine = a collection of named spaces (≈ IKVEngine)."""

    def create_space(self, name: str) -> IKVSpace:
        raise NotImplementedError

    def get_space(self, name: str) -> Optional[IKVSpace]:
        raise NotImplementedError

    def spaces(self) -> Dict[str, IKVSpace]:
        raise NotImplementedError

    def close(self) -> None:
        pass


# --------------------------- in-memory engine -------------------------------

class _SortedBytesMap:
    """Sorted byte-key map: a dict plus a key list put in order lazily.

    Unlike the reference's bisect-maintained list, a new key appends to
    the list, so a range that grows by a million keys in random order
    pays no O(n) insert per key. The list is put in order when a delete
    or a scan needs it: a short unsorted tail is insorted key by key, a
    long one sorted with the rest in one Timsort. Reads are O(1), deletes
    O(n) memmoves and range scans O(log n + k) once ordered.
    """

    _INSORT_TAIL = 32   # at 1M keys, 32 insorts cost less than one sort

    def __init__(self) -> None:
        self._keys: List[bytes] = []
        self._map: Dict[bytes, bytes] = {}
        self._n_sorted = 0      # _keys[:_n_sorted] is in order

    def _order(self) -> List[bytes]:
        keys, n = self._keys, self._n_sorted
        if n < len(keys):
            if len(keys) - n <= self._INSORT_TAIL:
                tail = keys[n:]
                del keys[n:]
                for k in tail:
                    bisect.insort(keys, k)
            else:
                keys.sort()
            self._n_sorted = len(keys)
        return keys

    def put(self, key: bytes, value: bytes) -> None:
        if key not in self._map:
            keys = self._keys
            if self._n_sorted == len(keys) and (not keys or key > keys[-1]):
                self._n_sorted += 1
            keys.append(key)
        self._map[key] = value

    def delete(self, key: bytes) -> None:
        if key in self._map:
            del self._map[key]
            keys = self._order()
            del keys[bisect.bisect_left(keys, key)]
            self._n_sorted -= 1

    def delete_range(self, start: bytes, end: bytes) -> None:
        keys = self._order()
        lo = bisect.bisect_left(keys, start)
        hi = bisect.bisect_left(keys, end)
        for k in keys[lo:hi]:
            del self._map[k]
        del keys[lo:hi]
        self._n_sorted = len(keys)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._map.get(key)

    def scan(self, start: Optional[bytes], end: Optional[bytes],
             reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        keys = self._order()
        lo = 0 if start is None else bisect.bisect_left(keys, start)
        hi = len(keys) if end is None else bisect.bisect_left(keys, end)
        keys = keys[lo:hi]
        if reverse:
            keys = reversed(keys)
        for k in keys:
            yield k, self._map[k]

    def copy(self) -> "_SortedBytesMap":
        c = _SortedBytesMap()
        c._keys = list(self._order())
        c._map = dict(self._map)
        c._n_sorted = len(c._keys)
        return c

    def __len__(self) -> int:
        return len(self._keys)


class InMemKVSpace(IKVSpace):
    def __init__(self, engine: "InMemKVEngine", name: str) -> None:
        self.name = name
        self._engine = engine
        self._data = _SortedBytesMap()
        self._meta: Dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._data.get(key)

    def iterate(self, start: Optional[bytes] = None,
                end: Optional[bytes] = None,
                reverse: bool = False) -> Iterator[Tuple[bytes, bytes]]:
        with self._lock:
            yield from list(self._data.scan(start, end, reverse))

    def size(self, start: Optional[bytes] = None,
             end: Optional[bytes] = None) -> int:
        with self._lock:
            return sum(len(k) + len(v)
                       for k, v in self._data.scan(start, end))

    def checkpoint(self) -> IKVSpaceCheckpoint:
        with self._lock:
            return _InMemCheckpoint(self._data.copy())

    def destroy(self) -> None:
        self._engine._drop(self.name)

    def get_metadata(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._meta.get(key)

    def put_metadata(self, key: bytes, value: bytes) -> None:
        with self._lock:
            self._meta[key] = value

    def _apply(self, ops) -> None:
        with self._lock:
            for op, a, b in ops:
                if op == "put":
                    self._data.put(a, b)
                elif op == "del":
                    self._data.delete(a)
                elif op == "del_range":
                    self._data.delete_range(a, b)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


class _InMemCheckpoint(IKVSpaceCheckpoint):
    def __init__(self, snapshot: _SortedBytesMap) -> None:
        self._snap = snapshot

    def iterate(self, start: Optional[bytes] = None,
                end: Optional[bytes] = None) -> Iterator[Tuple[bytes, bytes]]:
        yield from self._snap.scan(start, end)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._snap.get(key)


class InMemKVEngine(IKVEngine):
    def __init__(self) -> None:
        self._spaces: Dict[str, InMemKVSpace] = {}
        self._lock = threading.Lock()

    def create_space(self, name: str) -> IKVSpace:
        with self._lock:
            sp = self._spaces.get(name)
            if sp is None:
                sp = InMemKVSpace(self, name)
                self._spaces[name] = sp
            return sp

    def get_space(self, name: str) -> Optional[IKVSpace]:
        return self._spaces.get(name)

    def spaces(self) -> Dict[str, IKVSpace]:
        return dict(self._spaces)

    def _drop(self, name: str) -> None:
        with self._lock:
            self._spaces.pop(name, None)
