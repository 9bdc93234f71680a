"""Fit a ``TorchEstimator`` of one package in this process, for the parity
runs of tests/test_torch_port_spark_estimator.py::

    python tests/torch_port_spark_worker.py <package> <case> <np> MODEL OUT

``package`` is ``port`` (``horovod_tpu_torch.spark``, its ``LocalBackend``
with ``platform="cpu"``) or ``jax`` (``horovod_tpu.spark``, its
``LocalBackend`` with JAX on the CPU); the two packages never share a
process, since their cores export the same symbols. ``np`` 1 fits inline,
above it through the package's launcher. The model is the pickled module at
MODEL; the data comes from the seed. ``case``:

- ``plain``: 64 rows, batch 16, 3 epochs, shuffled with ``random_seed`` 0;
- ``weights``: 64 rows, half of them poisoned with weight 0, a contiguous
  zero-weight block of 32 rows first, ``shuffle=False``: at size 1 those
  batches are skipped, above it each runs the zero-weight lockstep step;
  the loss is MSE with ``reduction="none"``.

OUT (.npz) holds the history, the state dict (``sd.<name>``) and the
fitted model's predictions on a probe.
"""

import os
import sys

import numpy as np


def frame(case):
    import pandas as pd

    rng = np.random.RandomState(3)
    x1, x2 = rng.rand(64), rng.rand(64)
    y = 2.0 * x1 - x2 + 0.5
    if case == "plain":
        return pd.DataFrame({"x1": x1, "x2": x2, "y": y})
    y = y.copy()
    y[::2] = 100.0
    w = np.ones(64)
    w[::2] = 0.0
    w[:32] = 0.0
    return pd.DataFrame({"x1": x1, "x2": x2, "y": y, "w": w})


def main(package, case, np_, model_path, out):
    import torch

    if package == "port":
        from horovod_tpu_torch.spark.common import (
            FilesystemStore, LocalBackend,
        )
        from horovod_tpu_torch.spark.torch import TorchEstimator

        backend = LocalBackend(num_proc=np_, platform="cpu")
    else:
        from horovod_tpu.spark.common import FilesystemStore, LocalBackend
        from horovod_tpu.spark.torch import TorchEstimator

        backend = LocalBackend(num_proc=np_, env={"JAX_PLATFORMS": "cpu"})
    model = torch.load(model_path, weights_only=False)
    kw = dict(feature_cols=["x1", "x2"], label_cols=["y"], batch_size=16,
              verbose=0, store=FilesystemStore(out + ".store"),
              backend=backend, run_id="parity")
    if case == "plain":
        kw.update(loss=torch.nn.MSELoss(), epochs=3, random_seed=0)
    else:
        kw.update(loss=torch.nn.MSELoss(reduction="none"), epochs=2,
                  sample_weight_col="w", shuffle=False)
    fitted = TorchEstimator(model=model, **kw).fit(frame(case))
    probe = [[0.25, 0.75], [0.5, 0.5]]
    pred = (fitted.predict(probe, device="cpu") if package == "port"
            else fitted.predict(probe))
    sd = {"sd." + k: v.detach().numpy()
          for k, v in fitted.model.state_dict().items()}
    np.savez(out, history=np.asarray(fitted.history, np.float64),
             pred=pred, **sd)
    return 0


if __name__ == "__main__":
    package, case, np_, model_path, out = sys.argv[1:6]
    sys.exit(main(package, case, int(np_), model_path, out))
