"""Deterministic object hashing for change detection (the port's own copy
of ``tpu_operator/utils/hash.py``).

The reference guards DaemonSet updates with an FNV-32a hash of the spec
stored in an annotation (internal/utils/utils.go:71-84 GetObjectHash,
consumed at object_controls.go:4303-4346). We keep the same idea with a
canonical-JSON FNV-1a 64-bit hash: deterministic across processes, cheap,
and stable under dict ordering.
"""

from __future__ import annotations

import json
from typing import Any

_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x100000001B3


def fnv1a_64(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


def object_hash(obj: Any) -> str:
    """Hex FNV-1a of the canonical JSON encoding of ``obj``."""
    payload = json.dumps(obj, sort_keys=True, separators=(",", ":"), default=str)
    return format(fnv1a_64(payload.encode("utf-8")), "016x")
