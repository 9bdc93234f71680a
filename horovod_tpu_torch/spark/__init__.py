"""Spark integration: run horovod_tpu_torch training inside Spark tasks.

Port of ``horovod_tpu/spark/__init__.py`` (``run`` :29, ``run_elastic``
:95; reference: horovod/spark/runner.py:48-195 — a Spark job spawns one
task per slot, the driver collects addresses, sets the worker env,
launches the training function, and returns per-rank results). Requires
pyspark, which is imported when ``run`` is called, not when this module
is imported.

The device: every task's ``init()`` takes the card of its local rank
(``cuda:<local_rank>``), and raises when the task's host has no such
card; ``platform="cpu"`` sets ``HOROVOD_WORKER_PLATFORM=cpu``, and the
tasks run on the CPU over gloo. The controller address: a task on rank
0's host reaches it at 127.0.0.1, so that a host whose own name does not
resolve still rendezvous; a task on another host uses rank 0's host name.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import Any, Callable, Dict, List, Optional

from horovod_tpu_torch.runner.launch import worker_platform_env


def _require_pyspark():
    try:
        import pyspark  # noqa: F401

        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark "
            "(pip install pyspark)") from e


def task_env(rank: int, size: int, hosts: List[str], controller: str,
             platform: str) -> Dict[str, str]:
    """The HOROVOD_* environment of the task of ``rank``, from every
    task's host name (``hosts``, by rank) and rank 0's ``host:port``
    (``controller``). The local rank counts the lower ranks on this
    task's host; the cross rank is the index of this host among the hosts
    that have a task of this local rank, in order of first appearance."""
    host = hosts[rank]
    local_rank = sum(1 for h in hosts[:rank] if h == host)
    order: List[str] = []
    for h in hosts:
        if h not in order:
            order.append(h)
    cross = [h for h in order if hosts.count(h) > local_rank]
    controller_host, controller_port = controller.rsplit(":", 1)
    env = worker_platform_env(platform)
    env.update({
        "HOROVOD_RANK": str(rank),
        "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(local_rank),
        "HOROVOD_LOCAL_SIZE": str(hosts.count(host)),
        "HOROVOD_CROSS_RANK": str(cross.index(host)),
        "HOROVOD_CROSS_SIZE": str(len(cross)),
        "HOROVOD_CONTROLLER_ADDR": ("127.0.0.1" if host == hosts[0]
                                    else controller_host),
        "HOROVOD_CONTROLLER_PORT": controller_port,
        "HOROVOD_HOSTNAME": host,
    })
    return env


def _controller(ctx, rank: int) -> str:
    """Rank 0's ``host:port``, a port free on its host, through the
    barrier's ``allGather`` (the role the rendezvous server plays in the
    launcher); every task waits there for the others."""
    payload = ""
    if rank == 0:
        s = socket.socket()
        s.bind(("0.0.0.0", 0))
        payload = "%s:%d" % (socket.gethostname(), s.getsockname()[1])
        s.close()
    return ctx.allGather(payload)[0]


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        extra_env=None, verbose: int = 1, platform: str = "gpu") -> List[Any]:
    """Run ``fn`` on ``num_proc`` Spark tasks as horovod_tpu_torch ranks
    and return the list of per-rank results (reference:
    spark/runner.py:197-429).

    Uses a barrier-mode RDD so all ranks schedule together; rank 0's
    host:port is exchanged through the barrier context for the process
    group's rendezvous. ``fn`` calls ``init()`` itself, as under the
    launcher; ``platform`` picks its device (see the module's
    docstring).
    """
    _require_pyspark()
    worker_platform_env(platform)  # validates
    from pyspark import BarrierTaskContext
    from pyspark.sql import SparkSession

    kwargs = kwargs or {}
    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext
    if num_proc is None:
        num_proc = max(int(sc.defaultParallelism), 1)

    driver_env = dict(extra_env or {})

    def _task(_):
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        controller = _controller(ctx, rank)
        hosts = ctx.allGather(socket.gethostname())
        os.environ.update(task_env(rank, num_proc, hosts, controller,
                                   platform))
        os.environ.update(driver_env)
        result = fn(*args, **kwargs)
        # The core's orderly teardown, if the call initialised the port
        # and left it so (as the launcher's worker script does).
        hvd = sys.modules.get("horovod_tpu_torch")
        if hvd is not None and hvd.is_initialized():
            hvd.shutdown()
        ctx.barrier()
        return [(rank, result)]

    rdd = sc.parallelize(range(num_proc), num_proc).barrier()
    results = rdd.mapPartitions(_task).collect()
    return [r for _, r in sorted(results, key=lambda rr: rr[0])]


def run_elastic(fn, args=(), kwargs=None, num_proc=None,
                min_np=None, max_np=None, retries: int = 3,
                extra_env=None, verbose: int = 1, platform: str = "gpu"):
    """Fault-tolerant variant (reference: spark/runner.py:309-429).

    Spark owns the executor set, so unlike the launcher's elastic driver
    the world size is FIXED at ``num_proc`` for the lifetime of the
    barrier job (min_np/max_np only validate that num_proc is inside the
    allowed range). Fault tolerance is retry-from-committed-state: the
    first positional argument is expected to be an elastic ``State``;
    every task initialises the port, syncs the state and runs ``fn``; on
    ``HorovodInternalError`` each rank restores the last commit, calls
    ``shutdown()`` then ``init()`` (the same topology, the rendezvous on a
    fresh port from rank 0), and retries, up to ``retries`` times.
    Executor loss beyond that surfaces as a failed Spark job (Spark's own
    task retry resubmits the barrier stage)."""
    if num_proc is not None:
        if min_np is not None and num_proc < min_np:
            raise ValueError("num_proc=%d < min_np=%d" % (num_proc, min_np))
        if max_np is not None and num_proc > max_np:
            raise ValueError("num_proc=%d > max_np=%d" % (num_proc, max_np))

    _require_pyspark()
    # Resolved here and carried by the pickled call, as ``run``'s task
    # carries it: the task's process imports its module by name.
    from pyspark import BarrierTaskContext

    def resilient(*a, **kw):
        from horovod_tpu_torch.common import basics
        from horovod_tpu_torch.common.exceptions import HorovodInternalError

        # Before the first sync: a state's sync reads the world's size.
        basics.init()
        state = a[0] if a else None
        for attempt in range(retries + 1):
            try:
                if state is not None and hasattr(state, "sync"):
                    state.sync()
                return fn(*a, **kw)
            except HorovodInternalError:
                if attempt == retries:
                    raise
                if state is not None and hasattr(state, "restore"):
                    state.restore()
                # Every rank sees the error; re-initialise cooperatively
                # before the next sync() (the shutdown-then-init of
                # elastic/worker.py). The barrier world is fixed, so the
                # topology is reused as it is; the rendezvous is not: a
                # rank whose shutdown ended first would find rank 0's old
                # store still on the old port, and its stale addresses.
                basics.shutdown()
                ctx = BarrierTaskContext.get()
                os.environ["HOROVOD_CONTROLLER_PORT"] = _controller(
                    ctx, ctx.partitionId()).rsplit(":", 1)[1]
                basics.init()

    return run(resilient, args=args, kwargs=kwargs, num_proc=num_proc,
               extra_env=extra_env, verbose=verbose, platform=platform)
