"""Dynamic micro-batching queue: the serving hot path.

Port of ``horovod_tpu/serve/batching.py``: the reference's jax-free module,
copied with the port's imports; its behaviour is the reference's.


Individual ``POST /v1/predict`` requests are tiny (often one row), but
the jitted ``apply_fn`` amortizes well over a batch. ``MicroBatcher``
accumulates concurrent requests and fires a batch when EITHER trigger
lands, whichever is first:

- **size**: queued rows reach ``HVD_SERVE_MAX_BATCH``;
- **deadline**: the oldest queued request has waited
  ``HVD_SERVE_BATCH_DEADLINE_MS`` milliseconds.

Batches are padded to a small set of bucketed batch shapes (powers of
two from ``HVD_SERVE_MIN_BUCKET`` up to ``HVD_SERVE_MAX_BATCH``), so a
jitted model compiles at most ``len(buckets)`` programs — recompiles
are bounded no matter what request sizes traffic brings.

Bit-exactness discipline (the bucket rule): a request's result
must not depend on which bucket it rode in or on its co-batched rows.
``assert_bucket_equality`` asserts exactly that — same row, every
bucket shape, bitwise-equal output — and the replica runs it at
startup before admitting traffic. The default ``HVD_SERVE_MIN_BUCKET``
of 4 is the smallest bucket for which XLA's CPU backend compiles the
repo models to row-stable programs (batch 1/2 vectorize differently by
one ulp; tests/test_serve_batching.py pins both directions).

The queue is framework-agnostic: ``run_batch`` is any callable taking
a padded ``np.ndarray`` batch to a batch of outputs, so the same queue
serves a jitted flax model, a torch module, or the numpy identity
model the bench harness uses to stay jax-free.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.common.util import int_env
from horovod_tpu_torch.utils import metrics as _metrics

_G_QUEUE_DEPTH = _metrics.gauge(
    "hvd_serve_queue_depth",
    "Rows currently queued in the serving micro-batcher, waiting for "
    "the size or deadline trigger.")
_H_BATCH_SIZE = _metrics.histogram(
    "hvd_serve_batch_size",
    "Real (unpadded) rows per executed inference batch.",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0))
_C_BATCHES = _metrics.counter(
    "hvd_serve_batches_total",
    "Inference batches the micro-batcher executed.")


def bucket_sizes(max_batch: int, min_bucket: int) -> List[int]:
    """Powers of two from ``min_bucket`` doubling up to ``max_batch``
    (``max_batch`` itself is always the last bucket, even when it is
    not a power-of-two multiple of ``min_bucket``)."""
    if max_batch < 1:
        raise ValueError("max_batch must be >= 1, got %d" % max_batch)
    min_bucket = max(1, min(min_bucket, max_batch))
    sizes = []
    b = min_bucket
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` rows."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError("batch of %d rows exceeds the largest bucket %d"
                     % (n, buckets[-1]))


def pad_to_bucket(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad a ``(n, ...)`` batch up to ``(bucket, ...)``."""
    n = rows.shape[0]
    if n == bucket:
        return rows
    pad = np.zeros((bucket - n,) + rows.shape[1:], dtype=rows.dtype)
    return np.concatenate([rows, pad], axis=0)


def assert_bucket_equality(run_batch: Callable[[np.ndarray], np.ndarray],
                           buckets: Sequence[int],
                           sample: np.ndarray) -> None:
    """Assert the bucket bit-exactness contract: the same input row
    produces bitwise-identical output from every bucket shape, and the
    output is independent of co-batched rows. Raises ``AssertionError``
    naming the offending bucket pair otherwise.

    ``sample`` is one input row (no batch dimension); deterministic
    pseudo-random co-rows fill the other slots so row cross-talk (a
    batch-coupled op like batch-norm in training mode, or an XLA
    program whose row math changes with batch size) cannot hide behind
    zero padding. Each bucket is run with TWO different co-row fills —
    within-bucket row independence is the serving invariant even for a
    single-bucket configuration.
    """
    sample = np.asarray(sample)
    rng = np.random.RandomState(0)
    outputs = {}
    for b in buckets:
        fills = []
        for _ in range(2):
            batch = rng.standard_normal((b,) + sample.shape) \
                .astype(sample.dtype, copy=False)
            batch[0] = sample
            fills.append(np.asarray(run_batch(batch))[0])
        if b > 1 and not np.array_equal(fills[0], fills[1]):
            raise AssertionError(
                "bucket bit-exactness violated: the same row's output "
                "in bucket %d depends on its co-batched rows — the "
                "model couples rows across the batch axis (batch "
                "norm in training mode?) and cannot be micro-batched "
                "safely." % b)
        outputs[b] = fills[0]
    base_bucket = buckets[0]
    base = outputs[base_bucket]
    for b in buckets[1:]:
        if not np.array_equal(base, outputs[b]):
            diff = float(np.max(np.abs(
                base.astype(np.float64) - outputs[b].astype(np.float64))))
            raise AssertionError(
                "bucket bit-exactness violated: the same row differs "
                "between bucket %d and bucket %d (max abs diff %g). "
                "Raise HVD_SERVE_MIN_BUCKET (docs/serving.md) until "
                "every bucket compiles to row-stable programs."
                % (base_bucket, b, diff))


class _Request:
    __slots__ = ("rows", "future", "ts")

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.future: "Future[np.ndarray]" = Future()
        self.ts = time.monotonic()


class MicroBatcher:
    """Accumulate concurrent requests; run them as padded, bucketed
    batches on a dedicated thread.

    ``submit`` returns a ``concurrent.futures.Future`` resolving to
    this request's slice of the batch output (or raising the batch's
    exception). Requests are never split across batches; a request
    larger than ``max_batch`` rows is rejected at submit time.
    """

    def __init__(self, run_batch: Callable[[np.ndarray], np.ndarray],
                 max_batch: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 min_bucket: Optional[int] = None,
                 name: str = "serve"):
        if max_batch is None:
            max_batch = int_env("HVD_SERVE_MAX_BATCH", 8)
        if deadline_ms is None:
            try:
                deadline_ms = float(os.environ.get(
                    "HVD_SERVE_BATCH_DEADLINE_MS", 5.0))
            except ValueError:
                deadline_ms = 5.0
        if min_bucket is None:
            min_bucket = int_env("HVD_SERVE_MIN_BUCKET", 4)
        self.run_batch = run_batch
        self.max_batch = int(max_batch)
        # The configured maximum is a hard ceiling: buckets (and the
        # compiled programs behind them) are sized from it once, and
        # submit() rejects against it, so the online tuner can only
        # move the FIRE trigger below it (set_tunables).
        self.hard_max_batch = self.max_batch
        self.deadline_s = max(0.0, float(deadline_ms) / 1000.0)
        self.buckets = bucket_sizes(self.max_batch, int(min_bucket))
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._pending_rows = 0
        self._busy = False
        self._stopped = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="hvd-serve-batcher-%s" % name)
        self._thread.start()

    # --- client side --------------------------------------------------------

    def submit(self, rows: np.ndarray) -> "Future[np.ndarray]":
        rows = np.asarray(rows)
        if rows.ndim < 1 or rows.shape[0] < 1:
            raise ValueError("submit expects a (n, ...) batch of rows, "
                             "got shape %r" % (rows.shape,))
        if rows.shape[0] > self.hard_max_batch:
            # Rejection is against the CONFIGURED ceiling, not the
            # tuned fire trigger: the online tuner lowering max_batch
            # must never start bouncing requests that were legal when
            # the client sized them.
            raise ValueError(
                "request of %d rows exceeds HVD_SERVE_MAX_BATCH=%d; "
                "split it client-side"
                % (rows.shape[0], self.hard_max_batch))
        req = _Request(rows)
        with self._cond:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            self._pending.append(req)
            self._pending_rows += rows.shape[0]
            _G_QUEUE_DEPTH.set(self._pending_rows)
            self._cond.notify_all()
        return req.future

    def set_tunables(self, max_batch: Optional[float] = None,
                     deadline_ms: Optional[float] = None):
        """Online-tuner apply path (utils/online_tuner.py, schema
        knobs ``serve_max_batch``/``serve_deadline_ms``): retune the
        batch FIRE triggers live. ``max_batch`` is clamped to
        [1, hard_max_batch] — buckets above the configured ceiling
        were never compiled, so the tuner can only move the trigger
        down; ``deadline_ms`` clamps at 0. Wakes the batcher thread so
        a shorter deadline takes effect on the batch currently
        accumulating, not just the next one."""
        with self._cond:
            if max_batch is not None:
                self.max_batch = min(max(int(max_batch), 1),
                                     self.hard_max_batch)
            if deadline_ms is not None:
                self.deadline_s = max(0.0, float(deadline_ms) / 1000.0)
            self._cond.notify_all()

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every queued request has executed and resolved
        its future — the graceful-drain contract (docs/serving.md):
        callers stop accepting NEW work first (the replica 503s new
        predicts once draining), then wait here for the queue to run
        dry, batch currently executing included. Returns ``False``
        when ``timeout`` expired with work still in flight; the queue
        keeps running either way — ``stop()`` is still the teardown."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        with self._cond:
            while self._pending or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def stop(self):
        """Drain nothing further: fail queued requests and stop the
        batcher thread."""
        with self._cond:
            self._stopped = True
            pending = list(self._pending)
            self._pending.clear()
            self._pending_rows = 0
            _G_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        for req in pending:
            if not req.future.cancelled():
                req.future.set_exception(
                    RuntimeError("MicroBatcher stopped"))
        self._thread.join(timeout=5)

    # --- batcher thread -----------------------------------------------------

    def _take_batch(self) -> List[_Request]:
        """Block until a batch is due (size or deadline trigger), then
        drain whole requests up to ``max_batch`` rows."""
        with self._cond:
            while not self._pending and not self._stopped:
                self._cond.wait()
            if self._stopped:
                return []
            deadline = self._pending[0].ts + self.deadline_s
            while (self._pending_rows < self.max_batch
                   and not self._stopped):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
                if not self._pending:
                    # stop() drained us mid-wait
                    return []
            batch: List[_Request] = []
            n = 0
            # Always drain at least one request: a tuned-down
            # max_batch may sit below an already-queued (hard-max-
            # legal) request's row count, and skipping it forever
            # would wedge the queue.
            while self._pending and (
                    not batch
                    or n + self._pending[0].rows.shape[0]
                    <= self.max_batch):
                req = self._pending.popleft()
                n += req.rows.shape[0]
                self._pending_rows -= req.rows.shape[0]
                batch.append(req)
            _G_QUEUE_DEPTH.set(self._pending_rows)
            # Flagged inside the same critical section as the pop:
            # drain() must never observe "queue empty, nothing busy"
            # while a popped batch is still on its way to run_batch.
            self._busy = bool(batch)
            return batch

    def _loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                with self._cond:
                    if self._stopped:
                        return
                continue
            rows = np.concatenate([r.rows for r in batch], axis=0) \
                if len(batch) > 1 else batch[0].rows
            n = rows.shape[0]
            try:
                bucket = pick_bucket(n, self.buckets)
                # asanyarray, not asarray: run_batch may return an
                # ndarray subclass carrying per-batch metadata (the
                # replica tags outputs with the checkpoint step that
                # produced them); the per-request slices below preserve
                # the subclass, so the metadata reaches each future.
                out = np.asanyarray(
                    self.run_batch(pad_to_bucket(rows, bucket)))
                if out.shape[0] != bucket:
                    raise RuntimeError(
                        "run_batch returned %d rows for a bucket of %d"
                        % (out.shape[0], bucket))
            except Exception as e:  # analysis: allow-broad-except —
                # the batch's failure belongs to its requests' futures,
                # not to the batcher thread (which must keep serving).
                from horovod_tpu_torch.utils import flightrec

                flightrec.record("serve_batch_error", rows=n,
                                 requests=len(batch),
                                 detail=str(e)[:200])
                for req in batch:
                    if not req.future.cancelled():
                        req.future.set_exception(e)
                self._batch_done()
                continue
            _C_BATCHES.inc()
            _H_BATCH_SIZE.observe(n)
            from horovod_tpu_torch.utils import flightrec

            flightrec.record("serve_batch", rows=n, bucket=bucket,
                             requests=len(batch))
            off = 0
            for req in batch:
                k = req.rows.shape[0]
                if not req.future.cancelled():
                    req.future.set_result(out[off:off + k])
                off += k
            self._batch_done()

    def _batch_done(self):
        with self._cond:
            self._busy = False
            self._cond.notify_all()
