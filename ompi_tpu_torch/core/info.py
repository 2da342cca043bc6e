"""MPI_Info — string key/value hints (mirrors ``ompi/info``)."""
from __future__ import annotations

from typing import Dict, Optional


class Info:
    def __init__(self, initial: Optional[Dict[str, str]] = None):
        self._kv: Dict[str, str] = dict(initial or {})

    def set(self, key: str, value: str) -> None:
        self._kv[str(key)] = str(value)

    def get(self, key: str) -> Optional[str]:
        return self._kv.get(key)

    def delete(self, key: str) -> None:
        self._kv.pop(key, None)

    def get_nkeys(self) -> int:
        return len(self._kv)

    def get_nthkey(self, n: int) -> str:
        return list(self._kv.keys())[n]

    def dup(self) -> "Info":
        return Info(self._kv)

    def free(self) -> None:
        self._kv.clear()


INFO_NULL = Info()
INFO_ENV = Info()   # populated at Init with environment facts
