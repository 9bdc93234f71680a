"""Elastic state objects: commit / restore / sync across resets.

Port of ``horovod_tpu/elastic/state.py`` (reference:
horovod/common/elastic.py:26-160, horovod/torch/elastic/state.py). User
training state registers with a ``State``; ``commit()`` snapshots it,
persists every ``checkpoint_interval``-th snapshot through an attached
checkpointer and checks for host-set changes; ``restore()`` rolls back to
the last commit after a failure; ``sync()`` broadcasts rank 0's state
after a (re)rendezvous.

Where the port differs from the reference:

* ``commit()`` first raises ``HorovodInternalError`` if the world has
  failed (``common/failure.py``): under NCCL an aborted collective can
  return garbage instead of raising, and it must not be committed;
* above size 1 the host-update check is rank 0's, broadcast, as in the
  reference (the JAX package polls on every rank);
* a checkpoint carries the samplers' progress (epoch and processed
  indices), so that a cold resume continues the epoch rather than
  restarting it;
* ``TorchState`` checkpoints its state dicts natively (the port's
  ``Checkpointer`` writes torch files), drops the bucketed
  ``DistributedOptimizer``'s in-flight buckets and the gradients of the
  failed step on restore, and loads a copy of its snapshot into the
  optimizer (``load_state_dict`` keeps tensors it can reuse, and the next
  step would update the snapshot in place);
* ``CudaState`` stands where ``TpuState`` does: nested dicts, lists and
  tuples of tensors, snapshotted to the host.

The reference's ``hvd_elastic_*`` counters of this module
(``horovod_tpu/elastic/state.py:25-44``) count commits, graceful host
updates, checkpoint saves, auto-resumes and checkpoint errors; a commit
leaves an ``elastic_commit`` flight record.
"""

from __future__ import annotations

import copy
import json
import os
import sys
from typing import Any, Callable, Dict, List, Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import failure
from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt
from horovod_tpu_torch.utils import flightrec
from horovod_tpu_torch.utils import metrics as _metrics

_M_COMMITS = _metrics.counter(
    "hvd_elastic_commits_total",
    "Elastic state commits (State.commit snapshots).")
_M_HOST_UPDATES = _metrics.counter(
    "hvd_elastic_host_updates_total",
    "Graceful HostsUpdatedInterrupt resets triggered at commit "
    "boundaries by a new driver-published rendezvous version.")
_M_CKPT_SAVES = _metrics.counter(
    "hvd_elastic_ckpt_saves_total",
    "Committed snapshots persisted through the attached checkpointer "
    "(every checkpoint_interval-th State.commit).")
_M_CKPT_RESTORES = _metrics.counter(
    "hvd_elastic_ckpt_restores_total",
    "Checkpoint auto-resumes applied on a cold start (first wrapper "
    "entry of a fresh process restored a committed step).")
_M_CKPT_ERRORS = _metrics.counter(
    "hvd_elastic_ckpt_errors_total",
    "Checkpoint persistence/restore attempts that failed (save errors "
    "are logged and skipped; restore errors fall back one step).")


def commit_count() -> int:
    """Total ``State.commit()`` calls in this process (the heartbeat
    payload's ``commits``)."""
    return int(_M_COMMITS.get())


def _rendezvous_endpoint():
    addr = os.environ.get("HOROVOD_RENDEZVOUS_ADDR")
    port = os.environ.get("HOROVOD_RENDEZVOUS_PORT")
    if not addr or not port:
        return None
    return addr, int(port)


def current_rendezvous_version() -> Optional[int]:
    """The driver-published rendezvous version (None when not running
    under the elastic driver)."""
    ep = _rendezvous_endpoint()
    if ep is None:
        return None
    from horovod_tpu_torch.runner.http_server import read_kv

    try:
        raw = read_kv(ep[0], ep[1], "control", "meta", timeout=5)
    except OSError:
        return None
    if raw is None:
        return None
    return json.loads(raw.decode()).get("version", 0)


class State:
    """Base elastic state (reference: common/elastic.py:26-113).

    Subclasses that accept ``checkpointer=`` (``utils/checkpoint.py``'s
    ``Checkpointer``, or anything with its ``save``/``restore``/
    ``all_steps``/``latest_step``) persist every
    ``checkpoint_interval``-th committed snapshot, and
    ``_maybe_auto_resume`` (called once per process by ``elastic.run``)
    restores the newest committed step on a cold start, falling back one
    step when the newest fails.
    """

    def __init__(self, **kwargs):
        self._reset_callbacks: List[Callable] = []
        self._known_version = int(os.environ.get(
            "HOROVOD_RENDEZVOUS_VERSION", "0"))
        self._checkpointer = None
        self._checkpoint_interval = 1
        self._commits_since_ckpt = 0
        self._ckpt_seq: Optional[int] = None
        self._resume_attempted = False

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_updated = False
        for cb in self._reset_callbacks:
            cb()

    def commit(self):
        failure.check()
        _M_COMMITS.inc()
        flightrec.record("elastic_commit", step=getattr(self, "step", None))
        self.save()
        # Persist BEFORE the host-update check: a commit that triggers a
        # graceful reset must still reach durable storage.
        self._maybe_checkpoint()
        self.check_host_updates()

    # --- durable checkpoints ---

    def _checkpoint_step(self) -> int:
        """The committed ``step`` attribute when it is integer-like, else
        an internal counter seeded past any step already on disk."""
        step = getattr(self, "step", None)
        if step is not None:
            try:
                return int(step)
            except (TypeError, ValueError):
                pass
        if self._ckpt_seq is None:
            try:
                latest = self._checkpointer.latest_step()
            except Exception:  # noqa: BLE001 — a storage probe only; a
                # fresh sequence is always a safe seed.
                latest = None
            self._ckpt_seq = latest if latest is not None else -1
        self._ckpt_seq += 1
        return self._ckpt_seq

    def _checkpoint_payload(self) -> dict:
        """What the checkpointer writes; subclasses override."""
        raise NotImplementedError

    def _apply_checkpoint(self, payload: dict) -> None:
        """Inverse of ``_checkpoint_payload``; subclasses override."""
        raise NotImplementedError

    def _checkpoint_due(self) -> bool:
        """Whether this commit is a checkpoint commit. It must agree
        across ranks, since ``Checkpointer.save`` barriers: with an
        integer-like ``step`` it is ``step % interval == 0`` (equal
        everywhere after ``sync()``); only the no-step fallback counts
        commits, and ``sync()`` aligns that count from rank 0."""
        if self._checkpoint_interval <= 1:
            return True
        step = getattr(self, "step", None)
        if step is not None:
            try:
                return int(step) % self._checkpoint_interval == 0
            except (TypeError, ValueError):
                pass
        self._commits_since_ckpt += 1
        if self._commits_since_ckpt < self._checkpoint_interval:
            return False
        self._commits_since_ckpt = 0
        return True

    def _maybe_checkpoint(self):
        """Persist every Nth committed snapshot. A failed save is logged,
        never raised: the commit in memory already succeeded, and one bad
        write must not take training down."""
        if self._checkpointer is None or not self._checkpoint_due():
            return
        step = self._checkpoint_step()
        try:
            saved = self._checkpointer.save(step, self._checkpoint_payload())
        except Exception as e:  # noqa: BLE001 — best effort by contract
            _M_CKPT_ERRORS.inc()
            sys.stderr.write("elastic: checkpoint save at step %s failed: "
                             "%s\n" % (step, e))
            return
        # ``Checkpointer.save`` is False on the ranks that do not write:
        # persisted snapshots count, not attempts (None, from a
        # checkpointer that returns nothing, counts as saved).
        if saved is not False:
            _M_CKPT_SAVES.inc()

    def _maybe_auto_resume(self) -> Optional[int]:
        """On the FIRST wrapper entry of a fresh process, restore the
        newest committed checkpoint, or its predecessor when that fails
        to read or to apply. Survivors of an elastic reset never come
        back here (the latch is per process): their state in memory
        wins, and ``sync()`` aligns a respawned rank with rank 0. Returns
        the restored step, or None."""
        if self._checkpointer is None or self._resume_attempted:
            return None
        self._resume_attempted = True
        try:
            steps = sorted(int(s) for s in self._checkpointer.all_steps())
        except Exception as e:  # noqa: BLE001 — an unreadable directory
            # means a cold start from scratch.
            _M_CKPT_ERRORS.inc()
            sys.stderr.write("elastic: cannot list checkpoints, starting "
                             "from scratch: %s\n" % e)
            return None
        # Newest first, then its predecessor: a torn or corrupt latest
        # step (the crash landed mid-save) must not strand the job.
        for step in reversed(steps[-2:]):
            try:
                payload = self._checkpointer.restore(step=step)
                # Apply inside the same guard: a checkpoint that reads
                # back but fails to apply must fall back too, or every
                # respawned process dies on it.
                self._apply_checkpoint(payload)
            except Exception as e:  # noqa: BLE001 — fall back by design
                _M_CKPT_ERRORS.inc()
                sys.stderr.write("elastic: restore of checkpoint step %d "
                                 "failed (%s); falling back\n" % (step, e))
                continue
            self._ckpt_seq = None  # re-seed past the restored step
            _M_CKPT_RESTORES.inc()
            sys.stderr.write("elastic: auto-resumed from checkpoint step "
                             "%d\n" % step)
            return step
        return None

    def check_host_updates(self):
        """Raise ``HostsUpdatedInterrupt`` when the driver has published a
        newer rendezvous version than this state has seen (versions only
        move forward: an older one is a stale driver's and is ignored).

        Above size 1 rank 0 reads the version and broadcasts it, so that
        every rank raises at the same commit, as the reference's
        ``check_host_updates`` does (horovod/common/elastic.py). The JAX
        package reads it on every rank, and a version published between
        two ranks' reads splits the world: one rank waits in the
        shutdown's barrier while another runs the next step. The value
        goes through the core, a host tensor on its TCP ring: a failed
        world raises there at once, where on the card an NCCL broadcast
        whose root had left spun until the watch's abort, which then hung
        (ROADMAP C11)."""
        shared = basics.is_initialized() and basics.size() > 1
        version = (current_rendezvous_version()
                   if not shared or basics.rank() == 0 else None)
        if shared:
            from horovod_tpu_torch.ops import eager

            wire = torch.tensor([-1 if version is None else version],
                                dtype=torch.int64)
            got = int(eager.broadcast(wire, 0,
                                      name="__elastic.host_update__")[0])
            version = None if got < 0 else got
        if version is not None and version > self._known_version:
            self._known_version = version
            _M_HOST_UPDATES.inc()
            raise HostsUpdatedInterrupt(skip_sync=False)

    # --- to be implemented by subclasses ---
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError


def _is_sampler(v) -> bool:
    return (hasattr(v, "state_dict") and hasattr(v, "load_state_dict")
            and hasattr(v, "processed_indices"))


def _sampler_record(sd: dict) -> dict:
    """A sampler's state as a checkpoint holds it: plain lists."""
    return {"epoch": int(sd["epoch"]),
            "processed_indices": sorted(int(i)
                                        for i in sd["processed_indices"])}


class ObjectState(State):
    """State of picklable attributes (reference: common/elastic.py:116-148).

    Attributes that look like elastic samplers (``state_dict`` and
    ``processed_indices``) get the reference's sampler handler semantics:
    a commit snapshots their ``state_dict``, ``sync`` takes the union of
    every rank's processed indices and broadcasts rank 0's view, and
    ``load_state_dict`` re-shards. ``checkpointer=`` persists every
    ``checkpoint_interval``-th commit (see ``State``)."""

    def __init__(self, checkpointer=None, checkpoint_interval: int = 1,
                 **kwargs):
        super().__init__()
        self._samplers: Dict[str, Any] = {
            k: v for k, v in kwargs.items() if _is_sampler(v)}
        self._saved_state: Dict[str, Any] = {
            k: v for k, v in kwargs.items() if k not in self._samplers}
        self._saved_sampler_state: Dict[str, Any] = {}
        self.__dict__.update(kwargs)
        self._checkpointer = checkpointer
        self._checkpoint_interval = max(1, int(checkpoint_interval))

    def _save_samplers(self):
        for k, s in self._samplers.items():
            self._saved_sampler_state[k] = copy.deepcopy(s.state_dict())

    def _restore_samplers(self):
        for k, s in self._samplers.items():
            if k in self._saved_sampler_state:
                s.load_state_dict(self._saved_sampler_state[k])

    def save(self):
        for k in self._saved_state:
            self._saved_state[k] = copy.deepcopy(getattr(self, k))
        self._save_samplers()

    def restore(self):
        self.__dict__.update(copy.deepcopy(self._saved_state))
        self._restore_samplers()

    def _checkpoint_payload(self) -> dict:
        return {"state": dict(self._saved_state),
                "samplers": {k: _sampler_record(sd) for k, sd in
                             self._saved_sampler_state.items()}}

    def _apply_checkpoint(self, payload: dict) -> None:
        # Only keys this state already owns: schema drift in an old
        # checkpoint must not graft unknown attributes onto the state.
        for k, v in payload.get("state", {}).items():
            if k in self._saved_state:
                self._saved_state[k] = v
        for k, sd in payload.get("samplers", {}).items():
            if k in self._samplers:
                self._saved_sampler_state[k] = sd
        self.restore()

    def sync(self):
        if basics.size() > 1:
            from horovod_tpu_torch.common.objects import (
                allgather_object, broadcast_object,
            )

            synced = broadcast_object(self._saved_state, root_rank=0)
            self._saved_state = synced
            self.__dict__.update(copy.deepcopy(synced))
            if self._checkpointer is not None:
                # Align the no-step cadence counter (and the fallback step
                # sequence) with rank 0: a respawned rank's fresh counter
                # must not skip a checkpoint commit that the others enter
                # (Checkpointer.save barriers).
                self._commits_since_ckpt, self._ckpt_seq = \
                    broadcast_object(
                        (self._commits_since_ckpt, self._ckpt_seq),
                        root_rank=0)
            for k, s in self._samplers.items():
                # Union the processed indices of every rank (each shard
                # advanced on its own), then broadcast rank 0's view so
                # that the re-shard is the same everywhere.
                world = set().union(*allgather_object(
                    set(s.processed_indices)))
                sd = s.state_dict()
                sd["processed_indices"] = world
                synced_sd = broadcast_object(sd, root_rank=0)
                s.load_state_dict(synced_sd)
                # The union is the committed snapshot too: a restore()
                # before the next commit must not roll back to this rank's
                # own progress and re-process the others' samples.
                self._saved_sampler_state[k] = copy.deepcopy(synced_sd)

    def on_reset(self):
        super().on_reset()
        for s in self._samplers.values():
            s.reset()


def _tree_map(fn, *trees):
    """``fn`` over the tensors of nested dicts, lists and tuples (the
    first tree's structure); other leaves are kept."""
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, _tree_map(fn, *(t[k] for t in trees)))
                           for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves)
                           for leaves in zip(*trees))
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return first


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class CudaState(ObjectState):
    """Elastic state for tensors on the card: nested dicts, lists and
    tuples of tensors, plus picklable attributes (the counterpart of the
    JAX package's ``TpuState``, :377).

    The snapshot lives on the host, as ``TpuState``'s numpy snapshot
    does, so that it survives a fault on the device; ``restore`` puts each
    tensor back on the device it was committed from, in its dtype.
    ``sync`` broadcasts rank 0's tensors. The state snapshots itself at
    construction, so that a failure before the first commit rolls back to
    the initial values and not to half-updated ones."""

    def __init__(self, **kwargs):
        self._tree_keys = [
            k for k, v in kwargs.items()
            if isinstance(v, (dict, list, tuple, torch.Tensor))]
        self._devices: Dict[str, Any] = {}
        super().__init__(**kwargs)
        self.save()

    def save(self):
        for k in self._saved_state:
            v = getattr(self, k)
            if k in self._tree_keys:
                self._devices[k] = _tree_map(lambda t: t.device, v)
                self._saved_state[k] = _tree_map(_host_copy, v)
            else:
                self._saved_state[k] = copy.deepcopy(v)
        self._save_samplers()

    def restore(self):
        for k, v in self._saved_state.items():
            if k in self._tree_keys:
                setattr(self, k, _tree_map(
                    lambda t, dev: t.to(dev, copy=True), v,
                    self._devices[k]))
            else:
                setattr(self, k, copy.deepcopy(v))
        self._restore_samplers()

    def sync(self):
        if basics.size() > 1:
            self.save()  # host tensors travel in the pickled broadcast
            super().sync()
            self.restore()


class TorchState(ObjectState):
    """Elastic state of a torch model and optimizer, plus picklable
    attributes and samplers (reference: horovod/torch/elastic/
    state.py:27-160; JAX package :429).

    Its snapshot is a deepcopy of the state dicts on their own device.
    ``optimizer`` may be a ``torch.optim.Optimizer`` or the port's
    bucketed ``DistributedOptimizer``, which wraps one."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        self._model = model
        self._optimizer = optimizer
        super().__init__(**kwargs)

    def save(self):
        super().save()
        if self._model is not None:
            self._saved_model = copy.deepcopy(self._model.state_dict())
        if self._optimizer is not None:
            self._saved_optimizer = copy.deepcopy(
                self._optimizer.state_dict())

    def restore(self):
        super().restore()
        if self._model is not None and hasattr(self, "_saved_model"):
            self._model.load_state_dict(self._saved_model)
        if self._optimizer is not None:
            # The bucketed optimizer's flights and the named one's handles
            # belong to the old world, and the failed step's gradients are
            # partial.
            reset = getattr(self._optimizer, "_reset", None)
            if reset is not None:
                reset()
            self._optimizer.zero_grad(set_to_none=True)
            if hasattr(self, "_saved_optimizer"):
                self._optimizer.load_state_dict(
                    copy.deepcopy(self._saved_optimizer))

    def sync(self):
        if basics.size() > 1:
            from horovod_tpu_torch.torch.functions import (
                broadcast_optimizer_state, broadcast_parameters,
            )

            if self._model is not None:
                broadcast_parameters(self._model.state_dict(), root_rank=0)
            if self._optimizer is not None:
                broadcast_optimizer_state(self._optimizer, root_rank=0)
        super().sync()
        self.save()

    def _checkpoint_payload(self) -> dict:
        """The committed state dicts ride along natively: without them an
        auto-resume would restore ``step`` against fresh weights."""
        payload = super()._checkpoint_payload()
        if self._model is not None:
            payload["model"] = (self._saved_model
                                if hasattr(self, "_saved_model")
                                else self._model.state_dict())
        if self._optimizer is not None:
            payload["optimizer"] = (self._saved_optimizer
                                    if hasattr(self, "_saved_optimizer")
                                    else self._optimizer.state_dict())
        return payload

    def _apply_checkpoint(self, payload: dict) -> None:
        if self._model is not None and "model" in payload:
            self._saved_model = payload["model"]
        if self._optimizer is not None and "optimizer" in payload:
            self._saved_optimizer = payload["optimizer"]
        # The parent keeps the known attribute keys and calls restore(),
        # which loads the state dicts set above.
        super()._apply_checkpoint(payload)
