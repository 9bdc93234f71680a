"""One rank of the port's flash-tile sync runs: the twin of
tests/flash_sync_worker.py for ``horovod_tpu_torch.ops.block_tuner``.

Run as ``python torch_port_flash_sync_worker.py MODE OUT`` by two ranks
that share the launcher environment, with HVD_FLASH_SYNC_CACHE_DIR set.
Each rank seeds its own cache file with a different winner for one shape
(per-host caches that drifted) before ``init(device="cpu")``, whose sync
broadcasts rank 0's folded cache. MODE:

* ``sync``: every rank must answer rank 0's winner, with the broadcast
  path poisoned around the lookups (no collective at lookup time); a
  shape no rank has is None everywhere; cold tuning (``=1``) is refused
  everywhere; and with its own ``HVD_FLASH_TUNE`` unset a rank still
  reads the synced view;
* ``optout0``: rank 0 alone sets ``HVD_FLASH_TUNE_SYNC=0``: the opt-out
  rides the broadcast, so every rank reads its own cache (and cold tuning
  is not tried: it would tune locally);
* ``optout1``: rank 1 alone sets it: ignored, every rank reads rank 0's.

Each rank saves every rank's answers (``allgather_object``).
"""

import json
import os
import sys

import numpy as np

from horovod_tpu_torch.ops import block_tuner

RANK = int(os.environ["HOROVOD_RANK"])
CACHE = os.path.join(os.environ["HVD_FLASH_SYNC_CACHE_DIR"],
                     "rank%d.jsonl" % RANK)
MINE = (256, 512) if RANK == 0 else (128, 128)


def main():
    mode, out_path = sys.argv[1], sys.argv[-1]
    os.environ["HVD_FLASH_TUNE_CACHE"] = CACHE
    os.environ["HVD_FLASH_TUNE"] = "cache"
    if (mode, RANK) in (("optout0", 0), ("optout1", 1)):
        os.environ["HVD_FLASH_TUNE_SYNC"] = "0"
    key = block_tuner.shape_key(256, 256, 64, "float32", True,
                                block_tuner._device_kind("cpu"))
    block_tuner.append_record({
        "version": block_tuner.CACHE_VERSION, "key": key,
        "block_q": MINE[0], "block_k": MINE[1]}, CACHE)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import objects

    hvd.init(device="cpu")
    assert hvd.rank() == RANK

    def no_broadcast(*a, **kw):
        raise AssertionError("best_blocks issued a collective")

    real = objects.broadcast_object
    objects.broadcast_object = no_broadcast
    got = block_tuner.best_blocks(256, 256, 64, "float32", True)
    miss = block_tuner.best_blocks(64, 64, 32, "float32", False)
    cold = None
    if mode != "optout0":  # an opted-out world would tune locally
        os.environ["HVD_FLASH_TUNE"] = "1"
        cold = block_tuner.best_blocks(96, 96, 16, "float32", False)
    del os.environ["HVD_FLASH_TUNE"]
    gate_off = block_tuner.best_blocks(256, 256, 64, "float32", True)
    active = block_tuner.world_synced_view_active()
    objects.broadcast_object = real
    everyone = hvd.allgather_object((got, miss, cold, gate_off, active),
                                    name="flash_sync.verdict")
    hvd.shutdown()
    np.savez(out_path, verdict=np.array(json.dumps(everyone)))


if __name__ == "__main__":
    main()
