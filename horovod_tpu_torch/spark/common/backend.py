"""Training backends for estimators.

Port of ``horovod_tpu/spark/common/backend.py`` (reference:
horovod/spark/common/backend.py — SparkBackend runs the training fn
across Spark executors via horovod.spark.run; a Backend is anything with
``run(fn, args, env)``). ``LocalBackend`` runs the fn across local
processes through the port's launcher, ``python -m
horovod_tpu_torch.runner`` (``num_proc=1`` executes inline);
``SparkBackend`` through the port's ``spark.run``.

The device: both take ``platform``, as ``horovod_tpu_torch.run`` does.
Under ``"gpu"`` (the default) every rank's ``init()`` takes the card of
its local rank, and raises when there is none; ``"cpu"`` sets
``HOROVOD_WORKER_PLATFORM=cpu``, and the ranks run on the CPU over gloo.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Optional

from horovod_tpu_torch.runner.launch import worker_platform_env


class Backend:
    """(reference: spark/common/backend.py Backend)"""

    def num_processes(self) -> int:
        raise NotImplementedError()

    def run(self, fn: Callable, args=(), env=None) -> List[Any]:
        """Run ``fn(*args)`` on every rank; returns per-rank results."""
        raise NotImplementedError()


class SparkBackend(Backend):
    """(reference: spark/common/backend.py SparkBackend)"""

    def __init__(self, num_proc: Optional[int] = None, env=None,
                 verbose: int = 1, platform: str = "gpu"):
        self._num_proc = num_proc
        self._env = dict(env or {})
        self._verbose = verbose
        self._platform = platform

    def num_processes(self) -> int:
        if self._num_proc:
            return self._num_proc
        from pyspark.sql import SparkSession

        spark = SparkSession.builder.getOrCreate()
        return max(int(spark.sparkContext.defaultParallelism), 1)

    def run(self, fn, args=(), env=None) -> List[Any]:
        from horovod_tpu_torch import spark as hvd_spark

        merged = dict(self._env)
        merged.update(env or {})
        return hvd_spark.run(fn, args=args,
                             num_proc=self.num_processes(),
                             extra_env=merged, verbose=self._verbose,
                             platform=self._platform)


class LocalBackend(Backend):
    """Run the training fn on N local ranks through the port's launcher,
    ``horovod_tpu_torch.runner.run`` (the call cloudpickled, the ranks'
    output on this process's); ``num_proc=1`` runs inline in-process,
    with the platform's ``HOROVOD_WORKER_PLATFORM`` and ``env`` set in
    this process."""

    def __init__(self, num_proc: int = 1, env=None, platform: str = "gpu"):
        self._num_proc = num_proc
        self._env = dict(env or {})
        self._env.update(worker_platform_env(platform))
        self._platform = platform

    def num_processes(self) -> int:
        return self._num_proc

    def run(self, fn, args=(), env=None) -> List[Any]:
        merged = dict(self._env)
        merged.update(env or {})
        if self._num_proc == 1:
            os.environ.update(merged)
            return [fn(*args)]
        from horovod_tpu_torch.runner import run

        return run(fn, args=args, np=self._num_proc, env=merged,
                   platform=self._platform)
