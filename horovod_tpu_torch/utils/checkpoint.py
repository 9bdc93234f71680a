"""Rank-coordinated checkpoints of training state, as torch files.

Port of ``horovod_tpu/utils/checkpoint.py`` (``Checkpointer`` :38), whose
orbax ``CheckpointManager`` becomes a directory of torch files with the
same step semantics:

* ``save(step, state, force=False) -> bool``: True when the step was
  written. Without ``force`` a step is skipped (False) when it is not
  after the newest step on disk, or when steps exist already and it is
  off ``save_interval_steps`` (the first save is always taken). A step
  already on disk saved with ``force`` raises
  ``StepAlreadyExistsError``, as orbax does. After a save only the
  ``max_to_keep`` newest steps stay (None keeps all).
* ``restore(step=None, template=None)``: the newest step by default,
  ``FileNotFoundError`` when there is none; a ``template`` of the same
  structure gives each tensor its dtype and device.
* ``latest_step``, ``all_steps`` (ascending) and ``close``.

The reference's distributed discipline stays: rank 0 writes, and every
rank then barriers through the native core, so that no rank runs ahead
of a half-written step; rank 0 reaches the barrier even when its write
failed, and raises after it. Without ``init`` the process is rank 0 of a
world of one (a serving replica restores so).

A step commits atomically: it is written into a temporary directory
with its completion marker, each file and the directory are fsynced,
and the directory is renamed to the step's number. A step directory
without the marker is not a step; a temporary directory left by a
crash is removed when a ``Checkpointer`` opens the directory.

Steps only move forward in training, and there the two packages agree
on every return value and listing (tests/test_torch_port_checkpoint.py).
Saving a step below a newer one with ``force`` differs: orbax then
reports that step as its latest and deletes by save order; this
``Checkpointer`` keeps the ``max_to_keep`` highest steps.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

from horovod_tpu_torch.common import basics

STATE_FILE = "state.pt"
MARKER = "COMMITTED"
_TMP_PREFIX = ".tmp-"


class StepAlreadyExistsError(ValueError):
    """``save(step, force=True)`` of a step already on disk (orbax's
    ``StepAlreadyExistsError`` is a ``ValueError`` too)."""


def _rank() -> int:
    return basics.rank() if basics.is_initialized() else 0


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _apply_template(value, template):
    """``value`` with the template's dtypes and devices, leaf by leaf."""
    if isinstance(template, dict):
        return type(template)((k, _apply_template(value[k], t))
                              for k, t in template.items())
    if isinstance(template, (list, tuple)):
        return type(template)(_apply_template(v, t)
                              for v, t in zip(value, template))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value).to(device=template.device,
                                         dtype=template.dtype)
    return value


class Checkpointer:
    """Rank-coordinated checkpointing::

        ckpt = Checkpointer(directory, max_to_keep=3)
        ckpt.save(step, {"model": model.state_dict(), "step": step})
        ...
        restored = ckpt.restore()          # newest committed step
        restored = ckpt.restore(step=500)  # a given step
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        self._interval = max(1, int(save_interval_steps))
        if _rank() == 0:
            os.makedirs(self._dir, exist_ok=True)
            for name in os.listdir(self._dir):
                if name.startswith(_TMP_PREFIX):
                    shutil.rmtree(os.path.join(self._dir, name),
                                  ignore_errors=True)
        self._barrier()

    @property
    def directory(self) -> str:
        return self._dir

    def _barrier(self):
        if basics.is_initialized() and basics.size() > 1:
            from horovod_tpu_torch.ops import eager

            eager.barrier()

    def step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def all_steps(self) -> List[int]:
        """The committed steps on disk, ascending."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self._dir, name, MARKER)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Write ``state`` (tensors, numbers, strings and nested dicts,
        lists and tuples of them) at ``step`` from rank 0; every rank
        barriers on its completion. Returns whether the step was
        written (False on the other ranks)."""
        saved = False
        err: Optional[BaseException] = None
        if _rank() == 0:
            try:
                saved = self._save(int(step), state, force)
            except Exception as e:  # noqa: BLE001 — re-raised below; held
                # only so that the completion barrier still runs.
                err = e
        # The other ranks are already blocked in this barrier: rank 0 must
        # reach it even when its write failed, or the world's collective
        # sequence desynchronizes.
        self._barrier()
        if err is not None:
            raise err
        return saved

    def _save(self, step: int, state: Any, force: bool) -> bool:
        steps = self.all_steps()
        if not force:
            if steps and steps[-1] >= step:
                return False
            if steps and step % self._interval:
                return False
        if step in steps:
            raise StepAlreadyExistsError(
                "Checkpoint for step %d already exists." % step)
        tmp = os.path.join(self._dir, "%s%d-%d" % (_TMP_PREFIX, step,
                                                  os.getpid()))
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            path = os.path.join(tmp, STATE_FILE)
            with open(path, "wb") as f:
                torch.save(state, f)
                f.flush()
                os.fsync(f.fileno())
            with open(os.path.join(tmp, MARKER), "w") as f:
                f.write("%d\n" % step)
                f.flush()
                os.fsync(f.fileno())
            _fsync(tmp)
            final = self.step_dir(step)
            if os.path.exists(final):  # a torn step: no marker
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync(self._dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._collect()
        return True

    def _collect(self) -> None:
        if self._max_to_keep is None:
            return
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(self.step_dir(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Any:
        """The state saved at ``step`` (default: the newest). Tensors
        load on the CPU, or with ``template``'s dtypes and devices."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint under %s" % self._dir)
        if not os.path.exists(os.path.join(self.step_dir(step), MARKER)):
            raise FileNotFoundError("no committed step %d under %s"
                                    % (step, self._dir))
        state = torch.load(os.path.join(self.step_dir(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        if template is not None:
            state = _apply_template(state, template)
        return state

    def close(self):
        """Nothing stays open between calls; kept for the reference's
        interface."""
