"""Introspection: prove gradient sync runs through the framework's
collectives, and that an optimizer step updates its tensors in place.

Port of ``horovod_tpu/jax/introspect.py``. The JAX package reads the
traced jaxpr; a PyTorch step has no graph to read before it runs, so
``collective_counts`` runs the step once under ``torch.profiler`` and
counts the collectives ``torch.distributed`` dispatched: the
``c10d::<op>`` events of the dispatcher, which every backend (gloo, NCCL)
records on the thread that issues the collective, the autograd engine's
threads included. A bucketed optimizer that regressed to one monolithic
allreduce, or a step that bypassed the process group, fails the asserts
below loudly instead of silently.

Buffer donation, what it buys in XLA (the step's update written into the
input buffers, no fresh copy of the weights and optimizer state per
step), is in PyTorch an optimizer that updates every parameter and every
state tensor in place. ``donated_input_indices`` runs one step and
compares each tensor's ``data_ptr()`` before and after: a step that
rebinds ``p.data`` to a new tensor, or an optimizer that swaps its state
tensors, allocates per step and fails ``assert_donation_survives_lowering``.

Reference parity: the collectives asserted are the repo's equivalents of
the reference's data-plane ops (reference: horovod/common/ops/
nccl_operations.cc:156-214 flat allreduce, :233-440 hierarchical
reduce-scatter/cross-allreduce/all-gather).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# The counted collectives, by the name of their c10d dispatcher event:
# each key is one op, whichever call form (list or tensor) reached it.
COLLECTIVE_EVENTS = {
    "c10d::allreduce_": "allreduce_",
    "c10d::_reduce_scatter_base_": "reduce_scatter_tensor_",
    "c10d::reduce_scatter_": "reduce_scatter_tensor_",
    "c10d::_allgather_base_": "allgather_into_tensor_",
    "c10d::allgather_": "allgather_into_tensor_",
    "c10d::alltoall_base_": "alltoall_base_",
    "c10d::broadcast_": "broadcast_",
    "c10d::send": "send",
    "c10d::recv_": "recv",
}
COLLECTIVE_PRIMITIVES = tuple(dict.fromkeys(COLLECTIVE_EVENTS.values()))


def collective_counts(fn, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` (host
    activity only) and count its collectives by op (the keys of
    ``COLLECTIVE_PRIMITIVES``). Work that ``fn`` issues asynchronously is
    waited for before the profiler stops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    counts: Dict[str, int] = {}
    for event in prof.events():
        key = COLLECTIVE_EVENTS.get(event.name)
        if key is not None:
            counts[key] = counts.get(key, 0) + 1
    return counts


def assert_in_graph_gradient_sync(
    fn, *args,
    required: Sequence[str] = ("allreduce_",),
    **kwargs,
) -> Dict[str, int]:
    """Assert that running ``fn`` dispatches every collective in
    ``required``. Returns the full count dict so callers can log it.
    Raises ``AssertionError`` naming what is missing — the tripwire for a
    step whose gradients never reach the process group."""
    counts = collective_counts(fn, *args, **kwargs)
    missing = [p for p in required if counts.get(p, 0) == 0]
    if missing:
        raise AssertionError(
            "gradient sync is NOT going through the framework's "
            "collectives: the step dispatched no %r (found: %r). "
            "This usually means the optimizer is not the framework's "
            "DistributedOptimizer, or its hooks never fired."
            % (missing, counts))
    return counts


def assert_bucketed_gradient_sync(
    fn, *args,
    min_buckets: int = 2,
    **kwargs,
) -> Dict[str, int]:
    """Assert that running ``fn`` issues at least ``min_buckets``
    *independent* reduction collectives.

    This is the overlap tripwire for the bucketed gradient path: a
    bucket's allreduce can only overlap the remaining backward pass if
    the buckets are separate collectives. One monolithic whole-model
    allreduce (``HVD_GRAD_BUCKET_BYTES=0`` with one dtype) counts as a
    single reduction however many gradients it carries, so a silent
    regression to it fails here. The bucket count is the MAX of the
    allreduce and reduce-scatter totals, not their sum: one hierarchical
    ladder runs as reduce-scatter + allreduce + allgather, and summing
    would let a single monolithic ladder masquerade as two buckets.
    """
    counts = collective_counts(fn, *args, **kwargs)
    reductions = max(counts.get("allreduce_", 0),
                     counts.get("reduce_scatter_tensor_", 0))
    if reductions < min_buckets:
        raise AssertionError(
            "expected >= %d independent bucket collectives in the "
            "step, found %d (%r). Gradient sync has collapsed back to a "
            "monolithic collective — check HVD_GRAD_BUCKET_BYTES and the "
            "optimizer's bucket path." % (min_buckets, reductions, counts))
    return counts


def _step_tensors(optimizer) -> List:
    """The optimizer's tensors in a fixed order: every parameter in
    ``param_groups`` order, then each parameter's state tensors in the
    order of their keys."""
    import torch

    params = [p for g in optimizer.param_groups for p in g["params"]]
    out = list(params)
    for p in params:
        state = optimizer.state.get(p, {})
        out.extend(v for _, v in sorted(state.items())
                   if isinstance(v, torch.Tensor))
    return out


def donated_input_indices(step, optimizer, *args, **kwargs) -> List[int]:
    """Indices of the optimizer's tensors whose storage one call of
    ``step(*args, **kwargs)`` kept: each tensor's ``data_ptr()`` before
    and after the call, over every parameter (in ``param_groups`` order)
    and then each parameter's state tensors (by key). An optimizer whose
    state is created lazily (Adam's moments) is stepped once first, so
    that its state tensors exist to be compared; ``optimizer`` may be the
    framework's ``DistributedOptimizer``, which wraps one."""
    inner = getattr(optimizer, "optimizer", optimizer)
    if not inner.state:
        step(*args, **kwargs)
    before = [(t, t.data_ptr()) for t in _step_tensors(inner)]
    step(*args, **kwargs)
    return [i for i, (t, ptr) in enumerate(before) if t.data_ptr() == ptr]


def assert_donation_survives_lowering(
    step, optimizer, *args,
    min_donated=None,
    **kwargs,
) -> List[int]:
    """Assert that one step updates at least ``min_donated`` of the
    optimizer's tensors in place (default: all of them). Returns the
    in-place indices for logging."""
    inner = getattr(optimizer, "optimizer", optimizer)
    donated = donated_input_indices(step, optimizer, *args, **kwargs)
    total = len(_step_tensors(inner))
    want = total if min_donated is None else min_donated
    if len(donated) < want:
        kept = set(donated)
        raise AssertionError(
            "the optimizer step did NOT update its tensors in place: %d "
            "of %d kept their storage (expected >= %d); tensors %s were "
            "given new storage, a fresh copy of the weights or optimizer "
            "state every step."
            % (len(donated), total, want,
               [i for i in range(total) if i not in kept]))
    return donated
