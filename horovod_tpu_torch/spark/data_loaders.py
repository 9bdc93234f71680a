"""Data loaders for estimator training processes.

Port of ``horovod_tpu/spark/data_loaders.py`` over the port's
``data/data_loader.py``; the batches are numpy arrays, as the
reference's.

Parity with the reference's Spark data loaders
(reference: horovod/spark/data_loaders/pytorch_data_loaders.py:1-156 —
Petastorm reader wrappers with an async-prefetch variant). Reading here
is Parquet-via-pandas shards (see spark.common.estimator.read_shard);
these loaders batch a pandas shard and optionally prefetch batches on a
background thread via AsyncDataLoaderMixin.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from horovod_tpu_torch.data.data_loader import (
    AsyncDataLoaderMixin, BaseDataLoader,
)


class PandasShardDataLoader(BaseDataLoader):
    """Batches (features, labels) numpy arrays out of a pandas shard
    (reference: pytorch_data_loaders.py PytorchDataLoader)."""

    def __init__(self, pdf, feature_cols: List[str], label_cols: List[str],
                 batch_size: int = 32, shuffle: bool = True,
                 seed: Optional[int] = None):
        from horovod_tpu_torch.spark.common.convert import (
            build_feature_matrix,
        )

        # Mixed scalar/array/sparse columns flatten into one design
        # matrix (reference: util.py shape flattening).
        self._x = build_feature_matrix(pdf, feature_cols)
        self._y = build_feature_matrix(pdf, label_cols)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return (len(self._x) + self.batch_size - 1) // self.batch_size

    def _iterate(self) -> Iterator:
        order = np.arange(len(self._x))
        if self.shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            yield self._x[idx], self._y[idx]

    def __iter__(self) -> Iterator:
        return self._iterate()


class AsyncPandasShardDataLoader(AsyncDataLoaderMixin,
                                 PandasShardDataLoader):
    """Background-thread prefetching variant
    (reference: pytorch_data_loaders.py PytorchAsyncDataLoader)."""


class ShufflingBufferDataLoader(BaseDataLoader):
    """Windowed-shuffle wrapper over any batch iterable.

    Petastorm readers shuffle with a bounded in-memory buffer rather
    than a full permutation (reference: petastorm's
    RandomShufflingBuffer used via pytorch_data_loaders.py
    shuffling_queue_capacity): batches stream into a buffer of
    ``capacity`` samples and each yield draws a random batch from it —
    bounded memory over arbitrarily large shards.
    """

    def __init__(self, source, capacity: int = 1024,
                 seed: Optional[int] = None):
        self._source = source
        self.capacity = max(int(capacity), 1)
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self._source)

    def _iterate(self) -> Iterator:
        buf: List = []
        for item in self._source:
            buf.append(item)
            if len(buf) >= self.capacity:
                i = self._rng.randint(len(buf))
                buf[i], buf[-1] = buf[-1], buf[i]
                yield buf.pop()
        while buf:
            i = self._rng.randint(len(buf))
            buf[i], buf[-1] = buf[-1], buf[i]
            yield buf.pop()

    def __iter__(self) -> Iterator:
        return self._iterate()
