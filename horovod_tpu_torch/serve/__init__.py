"""``horovod_tpu_torch.serve`` — crash-safe, micro-batching inference serving.

Port of ``horovod_tpu/serve``: a trained checkpoint becomes a
load-balanced, observable HTTP inference service, on the card unless the
caller asks for the CPU:

- ``serve.replica``: a worker that loads the newest committed checkpoint
  (``utils/checkpoint.Checkpointer``, torch files), runs the model in
  eval mode under ``torch.inference_mode()`` on its device, at a small
  set of bucketed batch shapes, and answers ``POST /v1/predict``;
- ``serve.batching``: the dynamic micro-batching queue — requests
  accumulate until ``HVD_SERVE_MAX_BATCH`` rows or
  ``HVD_SERVE_BATCH_DEADLINE_MS`` (whichever fires first) and are padded
  to a bucketed batch shape;
- ``serve.router``: the front door — round-robin over live replicas
  with one retry, membership journaled through ``runner/journal.py`` so
  a SIGKILLed router restarts into the same routing table;
- ``serve.autoscale``: heartbeat-driven liveness — silent replicas are
  culled after ``HOROVOD_WORKER_LIVENESS_SEC`` and re-admitted on
  rediscovery; ``serve.standby`` and ``serve.rollout``: router failover
  and rolling checkpoint upgrades.

The router, standby, rollout, autoscale and batching modules are the
reference's jax-free modules with the port's imports. Entry points::

    python -m horovod_tpu_torch.serve --ckpt-dir CKPT --model mnist_mlp --np 2

(``--device cpu`` serves on the CPU) or the library API::

    import horovod_tpu_torch as hvd
    server = hvd.serve.Server(ckpt_dir=..., model="mnist_mlp",
                              num_replicas=2)
    server.start()

Import-light: nothing here imports torch until a replica loads a model,
so the router stays quick to spawn.
"""

from __future__ import annotations

_LAZY = {
    "MicroBatcher": "horovod_tpu_torch.serve.batching",
    "bucket_sizes": "horovod_tpu_torch.serve.batching",
    "assert_bucket_equality": "horovod_tpu_torch.serve.batching",
    "Replica": "horovod_tpu_torch.serve.replica",
    "Router": "horovod_tpu_torch.serve.router",
    "ReplicaMonitor": "horovod_tpu_torch.serve.autoscale",
    "Server": "horovod_tpu_torch.serve.server",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name))
    import importlib

    return getattr(importlib.import_module(mod), name)
