"""``horovod_tpu_torch.introspect`` on the CPU, under ``init(device="cpu")``
(a gloo group of one, where the bucket allreduces really run).

- ``collective_counts`` of the bucketed ``DistributedOptimizer``'s step
  counts one ``allreduce_`` a bucket (at least 2 buckets here) and passes
  ``assert_bucketed_gradient_sync``; one monolithic allreduce of every
  gradient trips it, and a plain optimizer's step, which dispatches no
  collective, trips ``assert_in_graph_gradient_sync``;
- ``assert_donation_survives_lowering`` (the port's in-place check) passes
  for SGD with momentum and for AdamW, and fails for a step that rebinds
  ``p.data`` to a new tensor.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import introspect
from horovod_tpu_torch.ops import collective_ops

_LAUNCHER_ENV = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
                 "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK",
                 "HOROVOD_CROSS_SIZE", "HOROVOD_WORKER_PLATFORM")


@pytest.fixture
def world_of_one(monkeypatch):
    for name in _LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    # Small buckets, so that the small model's gradients take several.
    monkeypatch.setenv("HVD_GRAD_BUCKET_BYTES", "4096")
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.Tanh(),
                               torch.nn.Linear(32, 32), torch.nn.Tanh(),
                               torch.nn.Linear(32, 4))


def _stepper(model, opt):
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))

    def step():
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()

    return step


def test_bucketed_step_counts_one_allreduce_a_bucket(world_of_one):
    model = _model()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    assert len(opt.buckets) >= 2
    counts = introspect.assert_bucketed_gradient_sync(_stepper(model, opt))
    assert counts == {"allreduce_": len(opt.buckets)}
    assert introspect.assert_in_graph_gradient_sync(
        _stepper(model, opt)) == counts


def test_one_monolithic_allreduce_trips_the_bucket_check(world_of_one):
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x = torch.randn(8, 16)

    def monolithic():
        opt.zero_grad()
        model(x).square().mean().backward()
        grads = [p.grad for p in model.parameters()]
        flat = collective_ops.allreduce(torch.cat([g.reshape(-1)
                                                   for g in grads]))
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        opt.step()

    assert introspect.collective_counts(monolithic) == {"allreduce_": 1}
    with pytest.raises(AssertionError, match="monolithic"):
        introspect.assert_bucketed_gradient_sync(monolithic)
    with pytest.raises(AssertionError, match="NOT going through"):
        introspect.assert_in_graph_gradient_sync(_stepper(model, opt))


def test_counts_name_every_collective(world_of_one):
    x = torch.ones(4)

    def collectives():
        collective_ops.allreduce(x)
        collective_ops.broadcast_(x.clone(), 0)
        collective_ops.allgather(x)
        collective_ops.reducescatter(x)
        collective_ops.alltoall(x)

    counts = introspect.collective_counts(collectives)
    assert set(counts) <= set(introspect.COLLECTIVE_PRIMITIVES)
    assert counts["allreduce_"] >= 1 and counts["broadcast_"] == 1


@pytest.mark.parametrize("make", [
    lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
    lambda ps: torch.optim.AdamW(ps, lr=1e-3, weight_decay=1e-4),
], ids=["sgd", "adamw"])
def test_optimizers_update_in_place(world_of_one, make):
    model = _model()
    opt = hvd.DistributedOptimizer(make(model.parameters()))
    before = [p.detach().clone() for p in model.parameters()]
    donated = introspect.assert_donation_survives_lowering(
        _stepper(model, opt), opt)
    n_params = len(before)
    n_state = sum(1 for p in model.parameters()
                  for v in opt.optimizer.state[p].values()
                  if isinstance(v, torch.Tensor))
    assert n_state >= n_params
    assert donated == list(range(n_params + n_state))
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))


def test_a_step_that_rebinds_p_data_fails(world_of_one):
    model = _model()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x = torch.randn(8, 16)

    def rebinding():
        opt.zero_grad()
        model(x).square().mean().backward()
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data - 0.1 * p.grad

    assert introspect.donated_input_indices(rebinding, opt) == []
    with pytest.raises(AssertionError, match="NOT update its tensors"):
        introspect.assert_donation_survives_lowering(rebinding, opt)
