"""Per-dtype, byte-capped gradient bucketing for fused collectives.

Port of ``horovod_tpu/parallel/bucketing.py``. ``assign_buckets`` is a
verbatim copy of the reference (pure Python over ``(nbytes, dtype_key)``
descriptors), so both packages cut the same leaf list into the same
buckets. Buckets are always per-dtype: concatenating a bf16 leaf into an
fp32 buffer would upcast it and double its bytes on the wire.
``pack_bucket``/``unpack_bucket`` are ``torch.cat`` and views.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import torch


class Bucket(NamedTuple):
    """One fused collective's worth of leaves.

    ``indices`` are positions into the caller's leaf list, in issue
    order (reverse-gradient order when ``reverse=True``); ``nbytes`` is
    the summed payload of the bucket.
    """

    dtype_key: Any
    indices: Tuple[int, ...]
    nbytes: int


def assign_buckets(
    nbytes_per_leaf: Sequence[int],
    dtype_keys: Sequence[Any],
    bucket_bytes: int,
    *,
    reverse: bool = True,
) -> List[Bucket]:
    """Assign leaves to per-dtype buckets capped at ``bucket_bytes``.

    Walks the leaves in reverse order by default — backprop finishes the
    *last* layers' gradients first, so reverse-flatten order issues the
    collectives whose inputs are ready earliest. A bucket closes once its
    payload reaches ``bucket_bytes``; a single leaf larger than the cap
    still gets its own bucket (the cap bounds *batching*, it never splits
    a tensor).

    ``bucket_bytes <= 0`` means "no cap": exactly one bucket per dtype,
    in first-seen (reverse) order.
    """
    if len(nbytes_per_leaf) != len(dtype_keys):
        raise ValueError("leaf size/dtype lists disagree: %d vs %d"
                         % (len(nbytes_per_leaf), len(dtype_keys)))
    order = range(len(dtype_keys))
    if reverse:
        order = reversed(order)

    buckets: List[Bucket] = []
    open_by_dtype = {}  # dtype_key -> index into buckets
    for i in order:
        key = dtype_keys[i]
        nbytes = int(nbytes_per_leaf[i])
        slot = open_by_dtype.get(key)
        if slot is None:
            buckets.append(Bucket(key, (i,), nbytes))
            open_by_dtype[key] = len(buckets) - 1
        else:
            b = buckets[slot]
            buckets[slot] = Bucket(key, b.indices + (i,),
                                   b.nbytes + nbytes)
        if bucket_bytes > 0 and buckets[open_by_dtype[key]].nbytes >= \
                bucket_bytes:
            del open_by_dtype[key]
    return buckets


def pack_bucket(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Flatten and concatenate a bucket's leaves into one new 1-D buffer."""
    return torch.cat([t.reshape(-1) for t in leaves])


def unpack_bucket(flat: torch.Tensor, leaves: Sequence[torch.Tensor]
                  ) -> List[torch.Tensor]:
    """Views of ``flat`` in the shapes of ``leaves``."""
    outs = []
    offset = 0
    for t in leaves:
        n = t.numel()
        outs.append(flat[offset:offset + n].view(t.shape))
        offset += n
    return outs
