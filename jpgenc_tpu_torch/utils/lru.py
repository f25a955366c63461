"""Bounded LRU mapping for process-wide per-layout caches (copy of
jpgenc_tpu/utils/lru.py).

The decoder caches per-layout index tables. Those caches must be bounded: a
long-lived service decoding heterogeneous image sizes would otherwise
accumulate one entry per distinct geometry forever.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Hashable


class LRUCache:
    """Tiny insertion/access-ordered bounded mapping (not thread-safe, same
    as the plain dicts it replaces — the process-wide caches are only
    mutated under the GIL between device dispatches)."""

    __slots__ = ("_d", "maxsize")

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError("maxsize must be >= 1")
        self.maxsize = maxsize
        self._d: OrderedDict[Hashable, Any] = OrderedDict()

    def get(self, key: Hashable, default: Any = None) -> Any:
        try:
            self._d.move_to_end(key)
            return self._d[key]
        except KeyError:
            # the key may be evicted by another thread between the
            # move_to_end and the lookup — a miss, never a crash
            return default

    def __getitem__(self, key: Hashable) -> Any:
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key: Hashable, value: Any) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()
