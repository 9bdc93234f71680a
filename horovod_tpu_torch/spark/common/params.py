"""Estimator hyper-parameter plumbing.

Port of ``horovod_tpu/spark/common/params.py``, unchanged in behaviour.

Parity with the reference's params layer
(reference: horovod/spark/common/params.py — a pyspark.ml.param.Params
mixin defining model/loss/optimizer/cols/epochs/... with getters and
setters). Here the params are plain attributes with validation so the
estimator API works with or without pyspark; when pyspark is installed
the estimator additionally registers itself with the Spark ML pipeline
machinery.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class EstimatorParams:
    """(reference: spark/common/params.py EstimatorParams)"""

    _param_names = [
        "num_proc", "model", "backend", "store", "loss", "loss_weights",
        "metrics", "optimizer", "feature_cols", "label_cols",
        "sample_weight_col", "batch_size", "val_batch_size", "epochs",
        "verbose", "shuffle", "callbacks", "checkpoint_callback",
        "random_seed", "train_steps_per_epoch",
        "validation_steps_per_epoch", "validation", "custom_objects",
        "run_id", "resume_from_checkpoint", "terminate_on_nan",
        "gradient_compression", "transformation_fn",
    ]

    def __init__(self, **kwargs):
        self.num_proc: Optional[int] = None
        self.model: Any = None
        self.backend: Any = None
        self.store: Any = None
        self.loss: Any = None
        self.loss_weights: Optional[List[float]] = None
        self.metrics: List[Any] = []
        self.optimizer: Any = None
        self.feature_cols: Optional[List[str]] = None
        self.label_cols: Optional[List[str]] = None
        self.sample_weight_col: Optional[str] = None
        self.batch_size: int = 32
        # Validation batch size; None = same as batch_size (reference:
        # params.py val_batch_size).
        self.val_batch_size: Optional[int] = None
        self.epochs: int = 1
        self.verbose: int = 1
        self.shuffle: bool = True
        self.callbacks: List[Any] = []
        # Rank-0-only checkpoint hook: a keras callback (Keras
        # estimator) or fn(model, epoch) (Torch estimator) — reference:
        # params.py checkpoint_callback.
        self.checkpoint_callback: Any = None
        self.random_seed: Optional[int] = None
        # Load the run's existing checkpoint before training — the
        # reference's resume-from-checkpoint fit behavior.
        self.resume_from_checkpoint: bool = False
        # Abort on NaN loss (reference: TerminateOnNaN plumbing).
        self.terminate_on_nan: bool = False
        # hvd Compression class reducing gradients on a narrower wire
        # dtype (reference: params.py gradient_compression).
        self.gradient_compression: Any = None
        self.train_steps_per_epoch: Optional[int] = None
        self.validation_steps_per_epoch: Optional[int] = None
        # float in (0,1): split fraction; str: name of a 0/1 column.
        self.validation: Any = None
        self.custom_objects: Dict[str, Any] = {}
        self.run_id: Optional[str] = None
        # fn(pandas row-batch) -> transformed batch, applied at read time.
        self.transformation_fn: Optional[Callable] = None
        self.set_params(**kwargs)

    def set_params(self, **kwargs) -> "EstimatorParams":
        for k, v in kwargs.items():
            if k not in self._param_names:
                raise ValueError(
                    "unknown estimator param %r (valid: %s)"
                    % (k, ", ".join(self._param_names)))
            setattr(self, k, v)
        return self

    def _validate_fit(self) -> None:
        if self.model is None:
            raise ValueError("model is required")
        if self.epochs <= 0:
            raise ValueError("epochs must be > 0")
        if self.batch_size <= 0:
            raise ValueError("batch_size must be > 0")
        # validation spec validity is owned by
        # spark.common.util.check_validation (fit runs it first).

    # Reference-style getters (reference exposes getModel()-style
    # accessors via pyspark Params; keep the snake_case surface).
    def get_params(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in self._param_names}
