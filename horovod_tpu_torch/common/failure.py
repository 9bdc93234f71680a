"""A collective whose peer is gone raises ``HorovodInternalError``.

Elastic recovery (``elastic/worker.py``) catches ``HorovodInternalError``,
as the reference's run wrapper does. The JAX package's collectives all go
through its native core, which raises it (``HorovodAbortedError``) when a
peer dies. The port also calls ``torch.distributed`` directly: the
bucketed optimizer, the in-graph collectives and the core's device plane.
There a dead peer surfaces otherwise:

* under gloo, as a plain ``RuntimeError`` at the collective or its wait,
  within milliseconds ("Connection reset by peer");
* under NCCL, usually not at all: the collective's kernel spins on the
  card until the group's timeout, and then PyTorch's watchdog may kill
  the whole process.

So each ``init`` starts a ``Watch``. The native core sees a peer's death
first: its background loop does a network round every cycle, idle or
not, and stops on a closed connection or after HOROVOD_COMM_TIMEOUT_SEC
without progress. The watch polls the core every ``POLL_SEC``; when the
core stopped on its own, it marks the world failed and aborts every
process group, which ends the NCCL kernels a dead peer would hang (a host
blocked on them returns). ``init`` turns NCCL's own error handling off
(``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``, unless the caller set it), so
that the watchdog does not tear the process down as well.

Before it aborts the groups the watch dumps both flight-recorder rings
(``utils/flightrec.py`` ``dump_on_abort``), as the core's session does
when a collective fails with ``HorovodAbortedError``.

Every wait point runs inside ``mapped()``: it raises
``HorovodInternalError`` when the world has failed, before and after the
call, and maps the backend's ``RuntimeError`` to it, marking the world
failed. A collective that an abort ended early leaves garbage in its
output, so the check after the call is what keeps it from being used; a
commit checks too (``elastic/state.py``). Under gloo an abort does not
end a wait already pending: the wait runs on until the peer closes its
end, and a peer that failed over to the next world keeps it open. So an
async collective's wait goes through ``wait``, which on the CPU polls the
work and raises once the watch has failed the world.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodInternalError

# Seconds between two looks at the core: one ctypes call each.
POLL_SEC = 0.05


def abort_groups() -> None:
    """Abort every process group of this process, newest first, as
    ``torch.distributed``'s own ``_abort_process_group`` does, but leave
    them registered: the main thread may be using them, and ``shutdown``
    destroys them."""
    c10d = dist.distributed_c10d
    groups = sorted(c10d._world.pg_names, key=c10d._world.pg_names.get,
                    reverse=True)
    default = c10d._world.default_pg
    nccl = None
    if default is not None and dist.is_nccl_available():
        try:
            nccl = default._get_backend(torch.device("cuda"))
        except RuntimeError:
            nccl = None
        if not isinstance(nccl, dist.ProcessGroupNCCL):
            nccl = None
    # One NCCL group around the aborts, so that the communicators' aborts
    # cannot wait on one another (pytorch/pytorch#119797).
    if nccl is not None:
        nccl._group_start()
    try:
        for pg in groups:
            try:
                pg.abort()
            except RuntimeError:  # a backend without abort: nothing hangs
                pass
    finally:
        if nccl is not None:
            nccl._group_end()


class Watch:
    """Watches one world's core from a daemon thread (see the module's
    docstring). ``failed`` is the reason the world failed, None while it
    is healthy; ``failed_at`` is when, on ``time.monotonic()``."""

    def __init__(self, core):
        self._core = core
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.failed: Optional[str] = None
        self.failed_at: Optional[float] = None
        self.aborted = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-failure-watch")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(POLL_SEC):
            if not self._core.running():
                self.fail("the coordination core stopped: a peer closed "
                          "its connection or made no progress")
                return

    def fail(self, why: str) -> None:
        """Mark the world failed (the first reason wins), dump both
        flight-recorder rings and abort its process groups, once."""
        with self._lock:
            if self.failed is None:
                self.failed = why
                self.failed_at = time.monotonic()
            if self.aborted or self._stop.is_set():
                return
            self.aborted = True
        from horovod_tpu_torch.utils import flightrec

        # Evidence first, while the rings still hold what explains it
        # (rate-limited, and it never raises).
        flightrec.dump_on_abort(why)
        abort_groups()

    def stop(self) -> None:
        """Stop watching (``shutdown``): a peer that shuts down cleanly
        closes its connections too, and must not read as a failure."""
        with self._lock:
            self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    def check(self) -> None:
        if self.failed is not None:
            raise HorovodInternalError("collective on a failed world: %s"
                                       % self.failed)


def check() -> None:
    """Raise ``HorovodInternalError`` when this process's world has
    failed."""
    watch = basics.watch()
    if watch is not None:
        watch.check()


# Seconds between two looks at a pending gloo collective in ``wait``.
WAIT_POLL_SEC = 0.001


def settle(work) -> None:
    """Wait until an async collective's ``work`` has completed, polling
    it, and raise ``HorovodInternalError`` as soon as the watch has failed
    the world; inside ``mapped()``. For a result the host reads next: on
    the card a blocking read of a collective whose root has left held the
    stream while the watch aborted NCCL, and the abort then hung
    (ROADMAP C11)."""
    watch = basics.watch()
    if watch is not None:
        while not work.is_completed():
            watch.check()
            time.sleep(WAIT_POLL_SEC)
    work.wait()


def wait(work) -> None:
    """``work.wait()`` of an async collective, inside ``mapped()``. On the
    card NCCL's wait orders the caller's stream and an abort ends its
    kernels, so it is called as it is; on the CPU (gloo) it ``settle``s,
    since gloo's abort alone would not end a pending wait."""
    if basics.init_device() == "cpu":
        settle(work)
    else:
        work.wait()


@contextlib.contextmanager
def mapped():
    """Run a wait point: raise ``HorovodInternalError`` if the world has
    failed, before or after it, and map the backend's error to it."""
    watch = basics.watch()
    if watch is None:
        yield
        return
    watch.check()
    try:
        yield
    except HorovodInternalError:
        raise
    except RuntimeError as e:
        why = "%s: %s" % (type(e).__name__, e)
        watch.fail(why)
        raise HorovodInternalError("collective failed: %s" % why) from e
    watch.check()
