"""The port's root namespace against the reference's (ROADMAP C7).

``horovod_tpu_torch`` exports the public names of ``horovod_tpu``
(``horovod_tpu/__init__.py:39-122``): the bare collective names are the
eager ops (``ops/eager.py``), the collectives over the process group are
``*_ingraph``, beside ``*_async``, ``join``, ``poll``, ``synchronize``, the
three exceptions, the capability queries and the observability calls.
The mesh names, the planner (``plan`` and its types) and ``serve`` are
the reference's too, the last two resolved lazily; the name still to
come is listed: the launcher ``run`` (ROADMAP A15).
"""

import inspect

import pytest
import torch

import horovod_tpu

import horovod_tpu_torch
from horovod_tpu_torch.ops import collective_ops, eager

# The reference's names the port does not export yet, and the item of
# ROADMAP.md each waits for.
GAPS = {"run": "A15"}
# Resolved lazily by the reference's module __getattr__ (PEP 562).
LAZY = ("serve", "plan", "Plan", "PlanError", "Topology", "Workload")
# The port's own additions: the torch binding's entry points, which the
# reference keeps in its framework modules.
EXTRAS = {"DistributedOptimizer", "SyncBatchNorm", "allreduce_gradients",
          "broadcast_optimizer_state", "broadcast_parameters",
          "get_process_set", "sync_batch_stats"}


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")
            and not inspect.ismodule(getattr(mod, n))}


def test_the_public_names_are_the_references():
    ref = _public(horovod_tpu) | {n for n in LAZY
                                  if hasattr(horovod_tpu, n)}
    got = _public(horovod_tpu_torch) | {n for n in LAZY
                                        if hasattr(horovod_tpu_torch, n)}
    assert ref - got == set(GAPS)
    assert got - ref == EXTRAS


@pytest.mark.parametrize("name", ["allreduce", "allreduce_async",
                                  "allgather", "allgather_async",
                                  "broadcast", "broadcast_async",
                                  "alltoall", "alltoall_async",
                                  "reducescatter", "reducescatter_async",
                                  "grouped_allreduce",
                                  "grouped_allreduce_async", "join", "poll",
                                  "synchronize", "barrier"])
def test_bare_names_are_the_eager_ops(name):
    assert getattr(horovod_tpu_torch, name) is getattr(eager, name)


@pytest.mark.parametrize("name", ["allreduce", "allgather", "broadcast",
                                  "alltoall", "reducescatter",
                                  "grouped_allreduce"])
def test_ingraph_names_are_the_process_group_collectives(name):
    assert getattr(horovod_tpu_torch, name + "_ingraph") is \
        getattr(collective_ops, name)


def test_allreduce_with_a_name_is_the_eager_op(monkeypatch):
    from horovod_tpu_torch.utils import flightrec, metrics

    for var in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_TIMELINE",
                "HVD_METRICS_PORT", "HVD_FLIGHTREC"):
        monkeypatch.delenv(var, raising=False)
    hvd = horovod_tpu_torch
    hvd.init(device="cpu")
    try:
        before = metrics.value("hvd_collectives_total", op="allreduce") or 0
        x = torch.arange(5.0)
        got = hvd.allreduce(x, name="g")
        assert torch.equal(got, x) and got is not x
        assert metrics.value("hvd_collectives_total",
                             op="allreduce") == before + 1
        events = flightrec.recorder().snapshot()["events"]
        assert [e["kind"] for e in events if e["name"] == "g"][-2:] == [
            "submit", "complete"]
        h = hvd.allreduce_async(x, name="g.async", op=hvd.Sum)
        assert torch.equal(hvd.synchronize(h), x)
        assert torch.equal(hvd.allreduce_ingraph(x, hvd.Sum), x)
        assert issubclass(hvd.HorovodAbortedError, hvd.HorovodInternalError)
        assert hvd.mpi_built() is False and hvd.tpu_built() is False
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("name", LAZY)
def test_lazy_names_resolve_to_the_ports_modules(name):
    import horovod_tpu_torch.parallel.planner as planner
    import horovod_tpu_torch.serve as serve

    got = getattr(horovod_tpu_torch, name)
    assert got is (serve if name == "serve" else getattr(planner, name))
    assert name not in vars(horovod_tpu_torch) or name == "serve"


@pytest.mark.parametrize("name", ["make_mesh", "global_mesh",
                                  "set_global_mesh"])
def test_mesh_names_are_the_ports_mesh(name):
    from horovod_tpu_torch.parallel import mesh

    assert getattr(horovod_tpu_torch, name) is getattr(mesh, name)
