"""Small environment helpers (copies of ``horovod_tpu/common/util.py:10-36``,
which the port may not import)."""

from __future__ import annotations

import os
import random


def float_env(name: str, default: float) -> float:
    """Parse a float knob; malformed or empty values keep the default
    (an env typo must never take init or recovery down)."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def int_env(name: str, default: int) -> int:
    """Integer twin of ``float_env``: same malformed-value policy."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def failure_backoff_seconds(streak: int, base: float, cap: float) -> float:
    """Jittered exponential backoff of the elastic run wrapper: 0 for the
    first failure in a streak (a single rank death recovers immediately),
    then min(base * 2**(n-2), cap) scaled by uniform(0.5, 1.0) so that
    restarting workers desynchronize. ``base <= 0`` disables the wait."""
    if streak < 2 or base <= 0:
        return 0.0
    return min(base * 2 ** (streak - 2), cap) * random.uniform(0.5, 1.0)
