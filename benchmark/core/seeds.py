"""Seeds: every stream a run draws from comes from `--seed` and a name."""

from __future__ import annotations

import hashlib


def sub_seed(seed: int, *names) -> int:
    """A 63-bit seed for the stream `names` of run seed `seed` (any whole
    number: the driver's seeds pass 32 bits)."""
    key = ":".join([str(int(seed))] + [str(n) for n in names]).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1
