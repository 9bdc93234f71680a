"""Async data loading: background-thread prefetch over any iterable loader.

Port of ``horovod_tpu/data/data_loader.py`` (``BaseDataLoader`` :41,
``AsyncDataLoaderMixin`` :46; reference: horovod/data/
data_loader_base.py:20-130): a producer thread fills a bounded queue ahead
of the consumer, so that host-side batch preparation (pinning, say)
overlaps the steps on the card; an error in the producer is raised in the
consumer. ``close_async_loader()`` stops the thread. The ``hvd_data_*``
metrics wait for ROADMAP A14.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional


class BaseDataLoader:
    def __iter__(self):
        raise NotImplementedError


class AsyncDataLoaderMixin:
    """Mix into a loader class to add background prefetch::

        class AsyncLoader(AsyncDataLoaderMixin, MyLoader):
            pass

    (reference: data/data_loader_base.py:48-130, the same MRO pattern).
    ``async_loader_queue_size <= 0`` iterates the loader in the caller's
    thread."""

    def __init__(self, *args, async_loader_queue_size: int = 4, **kwargs):
        self.async_loader_queue_size = async_loader_queue_size
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        super().__init__(*args, **kwargs)

    def close_async_loader(self):
        self._shutdown.set()
        if self._queue is not None:
            try:  # unblock a full producer
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._worker is not None:
            self._worker.join(timeout=10)
            self._worker = None

    def _producer(self):
        try:
            for batch in super().__iter__():
                if self._shutdown.is_set():
                    return
                self._queue.put(batch)
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            self._queue.put(_LoaderError(e))
        finally:
            self._queue.put(_END)

    def __iter__(self):
        if self.async_loader_queue_size <= 0:
            yield from super().__iter__()
            return
        self._shutdown.clear()
        self._queue = queue.Queue(maxsize=self.async_loader_queue_size)
        self._worker = threading.Thread(target=self._producer, daemon=True,
                                        name="hvd-async-loader")
        self._worker.start()
        while True:
            item = self._queue.get()
            if item is _END:
                break
            if isinstance(item, _LoaderError):
                raise item.error
            yield item
        self._worker.join(timeout=10)
        self._worker = None


class _LoaderError:
    def __init__(self, error):
        self.error = error


_END = object()
