"""Elastic dataset sampling: repartition unprocessed indices on rescale.

Port of ``horovod_tpu/data/sampler.py`` (``ElasticSampler`` :25), which
reworks the reference's elastic sampler
(reference: horovod/torch/elastic/sampler.py:24-140): the sampler shards
dataset indices across the current world like a distributed sampler, but
additionally records which indices each completed batch covered. After an
elastic reset (world grew/shrank), ``reset()`` re-shards only the
*unprocessed* indices over the new world, so a partially completed epoch
resumes mid-way instead of restarting.

The core class is framework-agnostic (iterates plain ints);
``horovod_tpu_torch.torch.elastic.ElasticSampler`` wraps it for
``torch.utils.data.DataLoader``. The order, the strided shard and the
looped tail padding are the JAX package's, so that both packages shard
identically (tests/test_torch_port_data.py).
"""

from __future__ import annotations

import math
import random
from typing import Iterator, List, Set

from horovod_tpu_torch.common import basics


class ElasticSampler:
    """Shards indices across ranks; repartitions remaining work on reset.

    Usage contract (mirrors the reference):
      1. Register with an elastic ``State`` so reset re-shards.
      2. Call ``record_batch``/``record_indices`` after each step.
      3. Call ``set_epoch`` at the END of each epoch (clears progress).
    """

    def __init__(self, dataset, shuffle: bool = True, seed: int = 0):
        self.dataset = dataset
        self._dataset_len = dataset if isinstance(dataset, int) \
            else len(dataset)
        self.shuffle = shuffle
        self.seed = seed

        self.epoch = 0
        self.processed_indices: Set[int] = set()

        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices: List[int] = []
        self.num_samples = 0
        self.total_size = 0
        self.indices: List[int] = []

        self.reset()

    def set_epoch(self, epoch: int) -> None:
        """Advance the shuffle epoch and clear processed indices. Call at
        the end of an epoch so a partial epoch is not re-processed."""
        self.epoch = epoch
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        self.record_indices(self.get_indices(batch_idx, batch_size))

    def record_indices(self, indices) -> None:
        self.processed_indices.update(indices)

    def get_indices(self, batch_idx: int, batch_size: int) -> List[int]:
        start = batch_idx * batch_size
        end = min(start + batch_size, len(self.indices))
        return self.indices[start:end]

    def state_dict(self) -> dict:
        return {"epoch": self.epoch,
                "processed_indices": set(self.processed_indices)}

    def load_state_dict(self, state_dict: dict) -> None:
        self.epoch = state_dict["epoch"]
        self.processed_indices = set(state_dict["processed_indices"])
        self.reset()

    def reset(self) -> None:
        """Re-shard the unprocessed indices over the current world size.
        Rebuilds ``self.indices`` immediately so record_batch/get_indices
        between a reset and the next ``__iter__`` see the new shard, not
        the pre-reset topology's."""
        if basics.is_initialized():
            self.num_replicas = max(basics.size(), 1)
            self.rank = basics.rank()
        else:
            # Sampler built before hvd.init() (e.g. during dataset setup)
            # or plain single-process use.
            self.num_replicas, self.rank = 1, 0
        self.remaining_indices = [
            i for i in range(self._dataset_len)
            if i not in self.processed_indices]
        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas
        self._reshard()

    def _reshard(self) -> None:
        indices = list(self.remaining_indices)
        if self.shuffle:
            # Same seed on every rank -> identical global order; each rank
            # then takes a strided slice, so shards are disjoint.
            random.Random(self.seed + self.epoch).shuffle(indices)
        # Pad to a multiple of the world size by wrapping around — looped,
        # because at an epoch tail the pad can exceed the remaining count
        # (e.g. 1 unprocessed index across 4 workers needs 3 repeats); a
        # single wrap would leave ranks with unequal shard lengths and
        # hang the next collective.
        while indices and len(indices) < self.total_size:
            indices += indices[:self.total_size - len(indices)]
        self.indices = indices[self.rank:self.total_size:self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        self._reshard()
        return iter(self.indices)

    def __len__(self) -> int:
        return self.num_samples
