"""One rank of the observability parity runs.

Run as a script, ``python torch_port_obs_worker.py MODE [native] OUT``, by
two processes that share the launcher environment (HOROVOD_RANK, SIZE,
CONTROLLER_ADDR, CONTROLLER_PORT), with HOROVOD_TIMELINE set by the
caller:

* ``jax``: ``horovod_tpu.torch``, the JAX package's binding;
* ``port``: ``horovod_tpu_torch.torch`` on the CPU, where host tensors take
  the native core's TCP ring.

Each runs the same eager ops on host tensors, then saves the metrics
snapshots before and after them and, after ``shutdown``, its Python
timeline. With ``native``
(under HOROVOD_AUTOTUNE=native) it then allreduces until the core's tuner
has closed two samples and saves the tuner's state. The two packages run
in processes of their own: their native cores export the same symbols.
"""

import json
import os
import sys

import numpy as np
import torch

NATIVE_ROUNDS = 600


def _import(mode):
    if mode == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import horovod_tpu as root
        import horovod_tpu.torch as hvd
        from horovod_tpu.common.basics import core_session

        hvd.init()
        return hvd, root, core_session
    import horovod_tpu_torch as root
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common.basics import core_session

    hvd.init(device="cpu")
    return hvd, root, core_session


def workload(hvd, r):
    """The same ops in both packages; every result is checked."""
    for dt in (torch.float32, torch.float64, torch.bfloat16, torch.int32):
        x = (torch.arange(7) + r).to(dt)
        got = hvd.allreduce(x, name="obs.%s" % dt, op=hvd.Sum)
        assert torch.equal(got, (2 * torch.arange(7) + 1).to(dt)), dt
    got = hvd.grouped_allreduce([torch.ones(3) * r, torch.ones(5, 2)],
                                name="obs.g", op=hvd.Sum)
    assert torch.equal(got[1], torch.full((5, 2), 2.0))
    handles = [hvd.allreduce_async(torch.full((4,), float(k + r)),
                                   name="obs.a%d" % k) for k in range(5)]
    for k, h in enumerate(handles):
        assert torch.equal(hvd.synchronize(h), torch.full((4,), k + 0.5))
    got = hvd.allgather(torch.full((r + 1, 2), float(r)), name="obs.ag")
    assert got.shape == (3, 2)
    got = hvd.broadcast(torch.arange(6.0) * (r + 1), 1, name="obs.b")
    assert torch.equal(got, torch.arange(6.0) * 2)
    out = hvd.alltoall(torch.arange(6.0).reshape(3, 2) + 10 * r,
                       splits=[1, 2] if r == 0 else [2, 1], name="obs.a2a")
    assert (out[0] if isinstance(out, tuple) else out).shape[1] == 2
    got = hvd.reducescatter(torch.ones(4, 3), name="obs.rs", op=hvd.Sum)
    assert got.shape == (2, 3)
    hvd.barrier()
    assert hvd.join() in (0, 1)


def main():
    mode, out_path = sys.argv[1], sys.argv[-1]
    native = "native" in sys.argv[2:-1]
    hvd, root, core_session = _import(mode)
    r = hvd.rank()
    # From here: each init has run its tile tuner's cache sync at size 2
    # (the reference's an eager broadcast, the port's a broadcast on the
    # process group), so the snapshots compare the workload alone.
    out = {"before": np.array(json.dumps(root.metrics_snapshot()))}
    workload(hvd, r)
    out["snapshot"] = np.array(json.dumps(root.metrics_snapshot()))
    if native:
        core = core_session()
        x = torch.ones(256)
        for i in range(NATIVE_ROUNDS):
            hvd.allreduce(x, name="obs.native", op=hvd.Sum)
            state = core.autotune_state()
            # Only the coordinator (rank 0) scores: both stop together
            # once it has closed two samples.
            done = hvd.allreduce(torch.tensor(
                [float(state["samples"] >= 2)]), name="obs.native.done",
                op=hvd.Max)
            if float(done[0]) == 1.0:
                break
        out["autotune"] = np.array(json.dumps(core.autotune_state()))
    hvd.shutdown()
    path = os.environ["HOROVOD_TIMELINE"].replace("{rank}", str(r))
    with open(path) as f:
        out["timeline"] = np.array(f.read())
    np.savez(out_path, **out)
    print("OBS_WORKER_OK mode=%s rank=%d" % (mode, r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
