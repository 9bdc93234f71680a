"""Process sets: only the global set (id 0) so far.

Port of ``horovod_tpu/common/process_sets.py``. The global set spans every
rank of the default ``torch.distributed`` group. Sets over a subset of
ranks (``torch.distributed.new_group``) are not ported yet (ROADMAP,
Queue A item 1): the collectives raise on any other set.
"""

from __future__ import annotations

from typing import List

from horovod_tpu_torch.common import basics


class _GlobalProcessSet:
    process_set_id = 0

    @property
    def ranks(self) -> List[int]:
        if basics.is_initialized():
            return list(range(basics.size()))
        return [0]

    def included(self) -> bool:
        return True

    def rank(self) -> int:
        return basics.rank()

    def size(self) -> int:
        return basics.size()

    def __repr__(self):
        return "ProcessSet(id=0, ranks=%r)" % (self.ranks,)


global_process_set = _GlobalProcessSet()


def is_global(process_set) -> bool:
    return (process_set is None
            or getattr(process_set, "process_set_id", None) == 0)

