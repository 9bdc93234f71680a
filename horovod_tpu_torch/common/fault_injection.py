"""Fault-injection shim over the native core's chaos hooks.

Port of ``horovod_tpu/common/fault_injection.py`` (stdlib only). The
port's copy of the core (``core/src/comm.cc``, ``ParseFaultEnv``) compiles
in the same env-driven injector, zero-cost when unarmed, which sabotages a
chosen rank's TCP connections so that the failure paths (the
``HOROVOD_COMM_TIMEOUT_SEC`` progress deadline, the abort cascade, the
self-healing wire's in-place reconnect, elastic recovery) run on purpose.
Tests and operators' drills build those environments here.

On the card the core still negotiates over its TCP connections while NCCL
carries the payload (``core/device_plane.py``). So the injector reaches the
negotiation: ``drop``, ``half_close`` and ``stall`` stop the core, and the
failure watch (``common/failure.py``) then aborts the NCCL groups, so that
the survivors raise ``HorovodInternalError`` instead of spinning in a
collective; ``reset`` heals the TCP link in place and leaves NCCL alone.

Modes (the injector arms only on the rank matching ``HVD_FAULT_RANK``):

- ``drop``: shutdown() every connection; the process survives, and its
  peers see FIN, so the typed ``HorovodAbortedError`` comes fast.
- ``stall``: park the background thread forever: the open-but-silent
  socket, which only the progress deadline detects.
- ``half_close``: shutdown(SHUT_WR) toward ``peer`` (or all peers): the
  victim keeps reading but never writes again.
- ``delay``: sleep ``delay_ms`` before each frame (latency only; never
  fails anything by itself).
- ``reset``: SO_LINGER-0 close of the target connection(s), a hard RST,
  which the self-healing wire reconnects from in place. One-shot. With
  ``after_subchunks`` the RST fires inside a pipelined ring transfer,
  after that many sub-chunk reductions, instead of at a frame boundary.
- ``reconnect_storm``: ``reset`` repeated every ``every_frames`` frames,
  at most ``count`` times.

The fault fires on the first framed send or duplex transfer after
``after_frames`` of them completed, so bootstrap and N healthy
collectives go through before it.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

MODES = ("drop", "stall", "half_close", "delay", "reset",
         "reconnect_storm")

#: Env vars the native injector reads (core/src/comm.cc ParseFaultEnv).
FAULT_ENV_KEYS = (
    "HVD_FAULT_RANK",
    "HVD_FAULT_MODE",
    "HVD_FAULT_PEER",
    "HVD_FAULT_AFTER_FRAMES",
    "HVD_FAULT_DELAY_MS",
    "HVD_FAULT_AFTER_SUBCHUNKS",
    "HVD_FAULT_EVERY_FRAMES",
    "HVD_FAULT_COUNT",
)


def fault_env(rank: int, mode: str, *, peer: int = -1,
              after_frames: int = 0, delay_ms: int = 0,
              after_subchunks: int = 0, every_frames: int = 1,
              count: int = 5) -> Dict[str, str]:
    """The env-var dict that arms the injector on ``rank``.

    The same dict may be exported to every rank of a job: the injector
    arms only where ``HVD_FAULT_RANK`` matches. ``after_subchunks``
    applies to ``reset`` (fire inside a pipelined transfer);
    ``every_frames`` and ``count`` to ``reconnect_storm``.
    """
    if mode not in MODES:
        raise ValueError("unknown fault mode %r (choose from %s)"
                         % (mode, ", ".join(MODES)))
    if rank < 0:
        raise ValueError("rank must be >= 0, got %d" % rank)
    if after_frames < 0 or delay_ms < 0 or after_subchunks < 0:
        raise ValueError(
            "after_frames/delay_ms/after_subchunks must be >= 0")
    if every_frames < 1 or count < 0:
        raise ValueError("every_frames must be >= 1 and count >= 0")
    return {
        "HVD_FAULT_RANK": str(rank),
        "HVD_FAULT_MODE": mode,
        "HVD_FAULT_PEER": str(peer),
        "HVD_FAULT_AFTER_FRAMES": str(after_frames),
        "HVD_FAULT_DELAY_MS": str(delay_ms),
        "HVD_FAULT_AFTER_SUBCHUNKS": str(after_subchunks),
        "HVD_FAULT_EVERY_FRAMES": str(every_frames),
        "HVD_FAULT_COUNT": str(count),
    }


def clear_fault_env(env: Optional[Dict[str, str]] = None) -> None:
    """Disarm: remove every injector variable from ``env`` (default
    ``os.environ``). Takes effect at the next ``init``: the core parses
    them when it builds its communicator."""
    env = os.environ if env is None else env
    for key in FAULT_ENV_KEYS:
        env.pop(key, None)


def is_armed(env: Optional[Dict[str, str]] = None,
             rank: Optional[int] = None) -> bool:
    """True when the injector would arm (for ``rank``, if given)."""
    env = os.environ if env is None else env
    target = env.get("HVD_FAULT_RANK", "")
    mode = env.get("HVD_FAULT_MODE", "")
    if target == "" or mode not in MODES:
        return False
    return rank is None or target == str(rank)
