"""One rank of the API-gap parity runs (init's process sets, the named
object collectives).

Run as ``python torch_port_api_worker.py MODE OUT`` by every rank of a
world that shares the launcher environment (HOROVOD_RANK, SIZE,
CONTROLLER_ADDR, CONTROLLER_PORT):

* ``jax``: the JAX package's root (``horovod_tpu``);
* ``port``: ``horovod_tpu_torch`` on the CPU (gloo).

Both call ``init(process_sets=...)`` with one set of one rank for each
rank, in reverse rank order, then record each set's id and ranks, an eager
allreduce inside this rank's set and one over the world, and the object
collectives called with the reference's positional ``name``. The two
packages run in processes of their own: their native cores export the
same symbols.
"""

import json
import os
import sys

import numpy as np
import torch


def _import(mode):
    if mode == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import horovod_tpu as hvd
        from horovod_tpu.common.process_sets import ProcessSet

        return hvd, ProcessSet, {}
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.process_sets import ProcessSet

    return hvd, ProcessSet, {"device": "cpu"}


def main():
    mode, out_path = sys.argv[1], sys.argv[-1]
    hvd, ProcessSet, kw = _import(mode)
    size = int(os.environ["HOROVOD_SIZE"])
    sets = [ProcessSet([r]) for r in reversed(range(size))]
    hvd.init(process_sets=sets, **kw)
    r = hvd.rank()
    mine = next(ps for ps in sets if r in ps.ranks)
    x = torch.arange(6, dtype=torch.float32) + 10 * r
    out = {
        "sets": [(ps.process_set_id, list(ps.ranks)) for ps in sets],
        "ids": hvd.get_process_set_ids(),
        "in_set": np.asarray(hvd.allreduce(
            x, name="api.set", op=hvd.Sum, process_set=mine)).tolist(),
        "world": np.asarray(hvd.allreduce(
            x, name="api.world", op=hvd.Sum)).tolist(),
        "broadcast_object": repr(hvd.broadcast_object(
            {"rank": r, "payload": list(range(3 * r))}, 1,
            "api.named_broadcast")),
        "allgather_object": repr(hvd.allgather_object(
            ("rank", r, "x" * (5 + 7 * r)), "api.named_allgather")),
    }
    hvd.shutdown()
    np.savez(out_path, result=np.array(json.dumps(out)))


if __name__ == "__main__":
    main()
