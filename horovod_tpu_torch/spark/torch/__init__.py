"""TorchEstimator: Spark-ML-style distributed PyTorch training.

Port of ``horovod_tpu/spark/torch/__init__.py`` on
``horovod_tpu_torch.torch``, with the reference's training loop as it is
written (seed + rank, the agreed minimum batch count, sample weights, the
zero-weight lockstep step, ``terminate_on_nan``, resume and rank 0's
checkpoint through the store). Above size 1 it runs the named
``DistributedOptimizer``, ``broadcast_parameters`` and
``broadcast_optimizer_state``: on the card, the native core, the device
plane's fusion kernels and NCCL. The model and every batch live on the
device ``init()`` took (the card unless the backend's platform is
``cpu``); the checkpoint is written from CPU tensors, so that a driver
with no card loads it. ``TorchModel.predict`` runs on the card unless it
is given ``device="cpu"``, and returns numpy.

Parity with the reference's Torch estimator
(reference: horovod/spark/torch/estimator.py + remote.py: pickle the
model + optimizer spec, per-rank shard training with
hvd.DistributedOptimizer and parameter broadcast, rank-0 checkpoint,
TorchModel for prediction/transform).
"""

from __future__ import annotations

import io
import os
from typing import List

import numpy as np

from horovod_tpu_torch.spark.common.estimator import (
    HorovodEstimator, HorovodModel, read_shard,
)


class TorchEstimator(HorovodEstimator):
    """(reference: spark/torch/estimator.py TorchEstimator)"""

    def _train_fn(self, remote_store):
        import torch

        buf = io.BytesIO()
        torch.save(self.model, buf)
        model_bytes = buf.getvalue()
        loss_fn = self.loss
        opt_factory = self.optimizer  # fn(params) -> optimizer, or None
        feature_cols = list(self.feature_cols or [])
        label_cols = list(self.label_cols or [])
        batch_size, epochs = self.batch_size, self.epochs
        verbose = self.verbose
        transformation_fn = self.transformation_fn
        steps_per_epoch = self.train_steps_per_epoch
        shuffle = self.shuffle
        random_seed = self.random_seed
        sample_weight_col = self.sample_weight_col
        resume = self.resume_from_checkpoint
        terminate_on_nan = self.terminate_on_nan
        checkpoint_callback = self.checkpoint_callback
        # The compressor class rides the cloudpickled closure — names
        # are not stable across bindings (torch's fp16 class is
        # FP16Compressor, not "fp16").
        gradient_compression = self.gradient_compression

        def train():
            import torch

            import horovod_tpu_torch.torch as hvd
            from horovod_tpu_torch.common import basics

            hvd.init()
            rank, size = hvd.rank(), hvd.size()
            device = torch.device(basics.init_device())
            if random_seed is not None:
                # Reproducible init/shuffle, rank-offset so per-rank
                # randomness (dropout, shuffles) differs.
                torch.manual_seed(random_seed + rank)
            train_pdf, _val = read_shard(
                remote_store.train_data_path, rank, size,
                validation_col="__validation__")
            if transformation_fn is not None:
                train_pdf = transformation_fn(train_pdf)
            # Mixed scalar/array/sparse feature columns flatten into
            # one design matrix (reference: util.py shape flattening).
            from horovod_tpu_torch.spark.common.convert import (
                build_feature_matrix,
            )

            x = torch.tensor(build_feature_matrix(train_pdf,
                                                  feature_cols),
                             dtype=torch.float32, device=device)
            y = torch.tensor(build_feature_matrix(train_pdf, label_cols),
                             dtype=torch.float32, device=device)
            model = torch.load(io.BytesIO(model_bytes), weights_only=False,
                               map_location="cpu").to(device)
            if resume and remote_store.exists(
                    remote_store.checkpoint_path):
                # Resume fit from the run's previous checkpoint,
                # reading through the store backend (hdfs-safe).
                model.load_state_dict(torch.load(
                    io.BytesIO(remote_store.read(
                        remote_store.checkpoint_path)),
                    weights_only=False, map_location=device))
            criterion = loss_fn or torch.nn.MSELoss()
            opt = (opt_factory(model.parameters()) if opt_factory
                   else torch.optim.SGD(model.parameters(), lr=0.01))
            if size > 1:
                hvd.broadcast_parameters(model.state_dict(), root_rank=0)
                hvd.broadcast_optimizer_state(opt, root_rank=0)
                opt = hvd.DistributedOptimizer(
                    opt, named_parameters=model.named_parameters(),
                    compression=(gradient_compression
                                 or hvd.Compression.none))
            weights_col = (torch.tensor(
                train_pdf[sample_weight_col].to_numpy(),
                dtype=torch.float32, device=device)
                if sample_weight_col is not None else None)
            losses = []
            # Lockstep invariant: every rank must run the SAME number
            # of optimizer steps per epoch — row shards can differ by
            # one row (read_shard deals rows round-robin), and under
            # the hook-based DistributedOptimizer a rank running an
            # extra batch fires allreduces no peer joins (a hang). All
            # ranks agree on min(batches) and drop the remainder,
            # like the reference's steps_per_epoch contract
            # (reference: spark/torch/remote.py steps_per_epoch from
            # global row counts).
            n_batches = (len(x) + batch_size - 1) // batch_size
            if steps_per_epoch is not None:
                n_batches = min(n_batches, steps_per_epoch)
            if size > 1:
                local_batches = n_batches
                n_batches = int(hvd.allreduce(
                    torch.tensor(local_batches, dtype=torch.int64),
                    op=hvd.Min, name="spark.torch.n_batches"))
                max_batches = int(hvd.allreduce(
                    torch.tensor(local_batches, dtype=torch.int64),
                    op=hvd.Max, name="spark.torch.max_batches"))
                if max_batches > n_batches and not shuffle and rank == 0:
                    # Without shuffling the SAME tail rows fall past
                    # the agreed step count every epoch. Detected via
                    # the Max reduction so surplus on ANY rank warns.
                    print("warning: uneven shards (max %d vs global "
                          "min %d batches) and shuffle=False: tail "
                          "rows beyond the global minimum are never "
                          "trained" % (max_batches, n_batches))
            if n_batches == 0:
                raise ValueError(
                    "no trainable batches: at least one rank's shard "
                    "is empty (global min over %d rank(s)); provide "
                    "more rows than workers or check "
                    "transformation_fn" % size)
            # An all-skipped epoch (every batch zero-weighted) reports
            # 0.0 rather than leaving `loss` unbound.
            loss = torch.zeros((), device=device)
            for _epoch in range(epochs):
                perm = (torch.randperm(len(x)) if shuffle
                        else torch.arange(len(x)))
                for bi in range(n_batches):
                    start = bi * batch_size
                    idx = perm[start:start + batch_size]
                    opt.zero_grad()
                    out = model(x[idx])
                    if weights_col is not None:
                        # Per-sample weights need an UNREDUCED loss
                        # (reference: sample_weight_col contract).
                        per_sample = criterion(out, y[idx])
                        if per_sample.dim() == 0:
                            raise ValueError(
                                "sample_weight_col requires a loss "
                                "with reduction='none' (got a scalar "
                                "from %r)" % type(criterion).__name__)
                        per_sample = per_sample.reshape(
                            len(idx), -1).mean(dim=1)
                        w = weights_col[idx]
                        wsum = w.sum()
                        # A zero-weight-sum batch must still run
                        # backward()+step() when distributed: under
                        # DistributedOptimizer every rank's collective
                        # sequence has to stay identical, so skipping
                        # the step on one rank while peers run it would
                        # hang training. A zero-gradient loss keeps the
                        # step (and its allreduces); note stateful
                        # optimizers (momentum, Adam) still apply their
                        # buffers on such a step — the price of staying
                        # in lockstep. Single-worker runs have no such
                        # constraint and keep the skip (and its exact
                        # parameter trajectory). Nonzero sums (incl.
                        # negative) divide normally.
                        if float(wsum) == 0.0:
                            if size == 1:
                                continue
                            # Zero-gradient loss from a SECOND forward
                            # on zeroed inputs: every saved activation
                            # is then finite, so backward of the 0.0-
                            # scaled loss yields exactly-zero grads.
                            # Using the real batch (whose samples are
                            # user-marked invalid and may saturate to
                            # inf) anywhere in the graph risks
                            # 0*inf = NaN in matmul backward, which the
                            # hooks would allreduce into every rank's
                            # weights. Same module graph => same
                            # collective pattern; BN running stats see
                            # one extra zero batch on these steps.
                            loss = model(
                                torch.zeros_like(x[idx])).sum() * 0.0
                        else:
                            loss = (per_sample * w).sum() / wsum
                    else:
                        loss = criterion(out, y[idx])
                    loss.backward()
                    opt.step()
                losses.append(float(loss.detach()))
                if terminate_on_nan:
                    # The verdict must be GLOBAL: a per-rank raise
                    # would exit one rank while peers continue into
                    # collectives with no partner (a hang, not a
                    # clean failure).
                    bad = not np.isfinite(losses[-1])
                    if size > 1:
                        bad = bool(float(hvd.allreduce(
                            torch.tensor(float(bad)), op=hvd.Max,
                            name="spark.torch.nan_check")))
                    if bad:
                        raise RuntimeError(
                            "loss is NaN/inf at epoch %d on at least "
                            "one rank (terminate_on_nan)" % _epoch)
                if checkpoint_callback is not None and rank == 0:
                    checkpoint_callback(model, _epoch)
                if verbose and rank == 0:
                    print("epoch %d loss %.5f" % (_epoch, losses[-1]))
            state = None
            if rank == 0:
                # Serialize once, from CPU tensors (a driver with no
                # card loads them); the same bytes go to the store's
                # checkpoint (through its backend — hdfs-safe) and
                # back to the driver.
                cpu_state = model.state_dict()
                for k, v in cpu_state.items():
                    cpu_state[k] = v.detach().cpu()
                buf2 = io.BytesIO()
                torch.save(cpu_state, buf2)
                state = buf2.getvalue()
                remote_store.write_bytes(remote_store.checkpoint_path,
                                         state)
            return {"loss": losses, "state": state}

        return train

    def _create_model(self, results: List, run_id, store):
        import torch

        rank0 = next(r for r in results if r["state"] is not None)
        model = torch.load(io.BytesIO(self._model_bytes()),
                           weights_only=False, map_location="cpu")
        model.load_state_dict(torch.load(io.BytesIO(rank0["state"]),
                                         weights_only=False))
        return TorchModel(model, rank0["loss"], run_id, store,
                          feature_cols=self.feature_cols)

    def _model_bytes(self) -> bytes:
        import torch

        buf = io.BytesIO()
        torch.save(self.model, buf)
        return buf.getvalue()


class TorchModel(HorovodModel):
    """(reference: spark/torch/estimator.py TorchModel). ``save`` writes
    the model from CPU tensors and ``load`` reads it onto the CPU;
    ``predict`` moves it to its device."""

    def __init__(self, model, history, run_id, store, feature_cols=None):
        super().__init__(history, run_id, store, feature_cols=feature_cols)
        self.model = model

    def predict(self, features, device: str = "cuda"):
        """The model's output on ``features`` as numpy, computed on
        ``device``: the card (``cuda``, or ``cuda:N``) unless it is
        ``cpu``. Without a card the default raises."""
        import torch

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchModel.predict(device=%r) but no CUDA device is "
                "visible; pass device='cpu' to run on the CPU"
                % str(device))
        model = self.model.to(device)
        model.eval()
        with torch.no_grad():
            return model(
                torch.tensor(np.asarray(features), dtype=torch.float32,
                             device=device)).cpu().numpy()

    def _payload_bytes(self) -> bytes:
        import copy

        import torch

        buf = io.BytesIO()
        torch.save(copy.deepcopy(self.model).cpu(), buf)
        return buf.getvalue()

    @classmethod
    def _from_payload(cls, blob, meta, store):
        import torch

        model = torch.load(io.BytesIO(blob), weights_only=False,
                           map_location="cpu")
        return cls(model, meta["history"], meta["run_id"], store,
                   feature_cols=meta["feature_cols"])
