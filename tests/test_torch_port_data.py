"""The port's data package against the JAX package's.

``ElasticSampler``: both packages' samplers are built on the same dataset
under the same world (sizes 1-5 and every rank, set by monkeypatching each
package's ``basics`` as tests/test_elastic_sampler.py does), with shuffle
on and off, over several epochs and processed sets up to the epoch's tail;
``indices``, ``len``, ``state_dict`` and the reshard after ``reset`` must
be equal. ``AsyncDataLoaderMixin``: the cases of
tests/test_data_loader.py:29-57 against the port's mixin, and its
``hvd_data_*`` families against the reference's: the same loaders move
the batch count and the wait histogram's count by the same amounts, and
leave the queue-depth gauge within the queue's size.
"""

import random
import time

import numpy as np
import pytest
import torch

from horovod_tpu.common import basics as jax_basics
from horovod_tpu.data.sampler import ElasticSampler as JaxSampler
from horovod_tpu_torch.common import basics as port_basics
from horovod_tpu_torch.data import AsyncDataLoaderMixin, ElasticSampler
from horovod_tpu_torch.torch.elastic import ElasticSampler as TorchSampler


@pytest.fixture
def world(monkeypatch):
    """``world(size, rank)`` sets the world both packages' samplers see."""
    jax_basics.init()
    monkeypatch.setattr(port_basics, "is_initialized", lambda: True)

    def set_world(size, rank):
        for mod in (jax_basics, port_basics):
            monkeypatch.setattr(mod, "size", lambda: size)
            monkeypatch.setattr(mod, "rank", lambda: rank)

    return set_world


def _same(jax_s, port_s):
    assert port_s.indices == jax_s.indices
    assert list(port_s) == list(jax_s)
    assert len(port_s) == len(jax_s)
    assert port_s.state_dict() == jax_s.state_dict()
    assert (port_s.num_samples, port_s.total_size) == \
        (jax_s.num_samples, jax_s.total_size)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("size", [1, 2, 3, 4, 5])
def test_samplers_shard_identically(world, size, shuffle):
    n = 23
    rng = random.Random(size * 10 + shuffle)
    for rank in range(size):
        world(size, rank)
        jax_s = JaxSampler(n, shuffle=shuffle, seed=5)
        port_s = ElasticSampler(n, shuffle=shuffle, seed=5)
        _same(jax_s, port_s)
        for epoch in range(3):
            jax_s.set_epoch(epoch)
            port_s.set_epoch(epoch)
            _same(jax_s, port_s)
            jax_s.record_batch(0, 2)
            port_s.record_batch(0, 2)
            _same(jax_s, port_s)
            # Processed sets up to the tail: n - 1 processed leaves one
            # index to pad across the whole world.
            for left in (n - 7, 3, 1):
                processed = set(rng.sample(range(n), n - left))
                sd = {"epoch": epoch, "processed_indices": processed}
                jax_s.load_state_dict(sd)
                port_s.load_state_dict(sd)
                _same(jax_s, port_s)
                assert len(set(port_s) & processed) == 0
                # The world changes under the sampler: reshard after reset.
                world(size % 5 + 1, rank % (size % 5 + 1))
                jax_s.reset()
                port_s.reset()
                _same(jax_s, port_s)
                world(size, rank)
                jax_s.reset()
                port_s.reset()
                _same(jax_s, port_s)


def test_torch_sampler_is_a_torch_sampler(world):
    world(2, 1)
    port_s = TorchSampler(list(range(10)), shuffle=True, seed=3)
    assert isinstance(port_s, torch.utils.data.Sampler)
    _same(JaxSampler(list(range(10)), shuffle=True, seed=3), port_s)
    loader = torch.utils.data.DataLoader(list(range(10)), batch_size=2,
                                         sampler=port_s)
    assert [int(x) for b in loader for x in b] == port_s.indices


class SlowLoader:
    def __init__(self, n=10, delay=0.01):
        self.n = n
        self.delay = delay

    def __iter__(self):
        for i in range(self.n):
            time.sleep(self.delay)
            yield np.full(4, i)


class AsyncSlowLoader(AsyncDataLoaderMixin, SlowLoader):
    pass


def test_async_loader_yields_everything_in_order():
    loader = AsyncSlowLoader(n=12, async_loader_queue_size=3)
    assert [int(b[0]) for b in loader] == list(range(12))
    # Reusable for a second epoch.
    assert [int(b[0]) for b in loader] == list(range(12))


def test_async_loader_propagates_errors():
    class FailingLoader:
        def __iter__(self):
            yield np.zeros(1)
            raise RuntimeError("boom")

    class AsyncFailing(AsyncDataLoaderMixin, FailingLoader):
        pass

    loader = AsyncFailing(async_loader_queue_size=2)
    with pytest.raises(RuntimeError, match="boom"):
        list(loader)


def test_async_loader_disabled_queue():
    loader = AsyncSlowLoader(n=3, delay=0.0, async_loader_queue_size=0)
    assert len(list(loader)) == 3


def test_async_loader_close_stops_its_thread():
    loader = AsyncSlowLoader(n=50, delay=0.001, async_loader_queue_size=2)
    it = iter(loader)
    assert int(next(it)[0]) == 0
    worker = loader._worker
    loader.close_async_loader()
    worker.join(timeout=10)
    assert not worker.is_alive()


@pytest.mark.parametrize("queue_size", [0, 1, 3])
def test_data_metrics_move_as_the_references(queue_size):
    from horovod_tpu.data.data_loader import (
        AsyncDataLoaderMixin as JaxMixin,
    )
    from horovod_tpu.utils import metrics as jax_metrics
    from horovod_tpu_torch.utils import metrics as port_metrics

    def counts(mod):
        wait = mod.REGISTRY.value("hvd_data_wait_seconds") or {"count": 0}
        return (mod.REGISTRY.value("hvd_data_batches_total") or 0,
                wait["count"])

    moved = {}
    for name, mixin, mod in (("jax", JaxMixin, jax_metrics),
                             ("port", AsyncDataLoaderMixin,
                              port_metrics)):
        class Loader(mixin, SlowLoader):
            pass

        before = counts(mod)
        loader = Loader(n=9, delay=0.001, async_loader_queue_size=queue_size)
        assert [int(b[0]) for b in loader] == list(range(9))
        after = counts(mod)
        moved[name] = (after[0] - before[0], after[1] - before[1])
        depth = mod.REGISTRY.value("hvd_data_queue_depth") or 0
        assert 0 <= depth <= queue_size
    assert moved["port"] == moved["jax"] == (9, 9 if queue_size else 0)
