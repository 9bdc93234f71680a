"""HorovodEstimator core: materialize data, train distributed, return a
fitted model transformer.

Port of ``horovod_tpu/spark/common/estimator.py``, unchanged in
behaviour; the default backend is the port's ``LocalBackend``, on the
card.

Parity with the reference's estimator flow
(reference: horovod/spark/common/estimator.py + util.py:
``fit`` materializes the DataFrame to Parquet under the Store, ships a
picklable remote-store view + serialized model spec to every rank via
the backend, each rank trains on its shard with a DistributedOptimizer,
rank 0 checkpoints into the run directory, and fit returns a Model
object usable for prediction / Spark ``transform``).

DataFrames: with pyspark installed, a Spark DataFrame is written with
``df.write.parquet``; pandas DataFrames are written with pyarrow. The
training side always reads Parquet with pandas, sharding rows by rank —
the petastorm role in the reference.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, List, Optional

from horovod_tpu_torch.spark.common.backend import Backend, LocalBackend
from horovod_tpu_torch.spark.common.params import EstimatorParams
from horovod_tpu_torch.spark.common.store import FilesystemStore, Store


def _is_spark_df(df) -> bool:
    mod = type(df).__module__
    return mod.startswith("pyspark.")


VALIDATION_COL = "__validation__"


def materialize_dataframe(df, path: str, validation=None) -> None:
    """Write ``df`` (pandas or Spark) as a Parquet dataset at ``path``.

    ``validation`` tags rows with a ``__validation__`` 0/1 column
    (reference: spark/common/util.py prepare_data/check_validation):
    a float fraction samples rows, a string names an existing 0/1
    column whose values become the tag."""
    if _is_spark_df(df):  # pragma: no cover - needs pyspark
        from pyspark.sql import functions as F

        if isinstance(validation, float):
            df = df.withColumn(
                VALIDATION_COL,
                (F.rand(seed=0) < validation).cast("int"))
        elif isinstance(validation, str):
            df = df.withColumn(
                VALIDATION_COL, df[validation].cast("int"))
        df.write.mode("overwrite").parquet("file://" + path)
        return
    import numpy as np
    import pandas as pd

    pdf = pd.DataFrame(df).copy()
    if isinstance(validation, float):
        rng = np.random.RandomState(0)
        pdf[VALIDATION_COL] = (
            rng.rand(len(pdf)) < validation).astype("int64")
    elif isinstance(validation, str):
        if validation not in pdf.columns:
            raise ValueError(
                "validation column %r not in DataFrame (have %s)"
                % (validation, sorted(pdf.columns)))
        pdf[VALIDATION_COL] = pdf[validation].astype("int64")
    os.makedirs(path, exist_ok=True)
    from horovod_tpu_torch.spark.common import convert

    if any(pdf[c].dtype == object for c in pdf.columns):
        # Vector/array/sparse columns take the columnar conversion
        # path: Arrow list/struct columns + schema sidecar (reference:
        # spark/common/util.py to_petastorm_fn + _get_col_info).
        convert.write_columnar(pdf, path)
    else:
        # A prior columnar fit may have left its schema sidecar at
        # this (fixed per-store) path; a stale sidecar would make
        # readers "restore" plain scalar data as vectors.
        sidecar = os.path.join(path, convert.SCHEMA_SIDECAR)
        if os.path.exists(sidecar):
            os.unlink(sidecar)
        pdf.to_parquet(os.path.join(path, "part-00000.parquet"))


def _restore_columnar(path: str, pdf):
    """Rebuild ndarray / SparseVector cells when the dataset was
    materialized through the columnar conversion path (schema sidecar
    present); plain scalar datasets pass through untouched."""
    from horovod_tpu_torch.spark.common import convert

    meta = convert.load_schema_sidecar(path)
    if meta:
        pdf = convert.restore_dataframe(pdf, meta)
        # Ride the schema along for consumers that can't re-infer it
        # from values (build_feature_matrix on an EMPTY shard still
        # needs each column's flattened width).
        pdf.attrs["hvd_schema"] = meta
    return pdf


def read_shard(path: str, rank: int, size: int,
               validation_col: Optional[str] = None):
    """Read this rank's row shard of a Parquet dataset as
    (train_pdf, val_pdf)."""
    import pandas as pd

    files = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
    pdf = pd.concat(
        [pd.read_parquet(os.path.join(path, f)) for f in files],
        ignore_index=True)
    pdf = _restore_columnar(path, pdf)
    if validation_col and validation_col in pdf.columns:
        val = pdf[pdf[validation_col] == 1].drop(columns=[validation_col])
        train = pdf[pdf[validation_col] == 0].drop(
            columns=[validation_col])
    else:
        val, train = None, pdf
    train = train.iloc[rank::size].reset_index(drop=True)
    return train, val


def read_shard_rowgroups(path: str, rank: int, size: int):
    """Petastorm-semantics shard: each rank reads only its own Parquet
    *row groups* — IO proportional to the shard, not the dataset
    (reference: petastorm's make_batch_reader(cur_shard, shard_count)
    row-group sharding used by spark/data_loaders/pytorch_data_loaders.py).
    Row groups are enumerated across files in sorted order and dealt
    round-robin by rank."""
    import pandas as pd
    import pyarrow.parquet as pq

    files = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
    if not files:
        raise FileNotFoundError("no .parquet files under %r" % path)
    pieces = []
    index = 0
    for fn in files:
        pf = pq.ParquetFile(os.path.join(path, fn))
        for g in range(pf.num_row_groups):
            if index % size == rank:
                pieces.append(pf.read_row_group(g).to_pandas())
            index += 1
    if not pieces:
        # Empty shard: column-correct zero-row frame without data IO.
        # Still runs the columnar restore so the schema sidecar rides
        # pdf.attrs — build_feature_matrix needs it to give the empty
        # frame its peers' flattened feature width.
        schema = pq.ParquetFile(
            os.path.join(path, files[0])).schema_arrow
        return _restore_columnar(path, schema.empty_table().to_pandas())
    return _restore_columnar(path, pd.concat(pieces, ignore_index=True))


class HorovodEstimator(EstimatorParams):
    """Common fit orchestration
    (reference: spark/common/estimator.py HorovodEstimator)."""

    def _backend(self) -> Backend:
        if self.backend is not None:
            return self.backend
        return LocalBackend(num_proc=self.num_proc or 1)

    def _store(self) -> Store:
        if self.store is not None:
            return self.store
        import tempfile

        return FilesystemStore(tempfile.mkdtemp(prefix="hvd_estimator_"))

    def fit(self, df) -> "HorovodModel":
        """Materialize ``df``, train across the backend's ranks, return
        the fitted model."""
        from horovod_tpu_torch.spark.common import util

        util.check_validation(self.validation)
        self._validate_fit()
        store = self._store()
        run_id = self.run_id or ("run_" + uuid.uuid4().hex[:12])
        data_path = store.get_train_data_path()
        materialize_dataframe(df, data_path, validation=self.validation)
        if hasattr(store, "make_run_dirs"):
            store.make_run_dirs(run_id)
        # Dataset metadata rides with the run (reference:
        # spark/common/util.py get_simple_meta_from_parquet +
        # estimator metadata compatibility checks): stats are exposed
        # on the estimator, and refitting into an existing run with a
        # drifted schema fails loudly instead of silently mixing data.
        rows, metadata, avg_row_size = util.get_metadata_from_parquet(
            data_path, label_columns=self.label_cols,
            feature_columns=self.feature_cols)
        metadata.pop(VALIDATION_COL, None)  # internal tag, not schema
        self._dataset_rows = rows
        self._dataset_avg_row_size = avg_row_size
        if hasattr(store, "get_run_path"):
            run_path = store.get_run_path(run_id)
            prior = util.load_metadata(run_path)
            if prior is not None:
                util.check_metadata_compatibility(prior, metadata)
            util.save_metadata(run_path, metadata)
        remote_store = store.to_remote(run_id)
        train_fn = self._train_fn(remote_store)
        backend = self._backend()
        results = backend.run(train_fn, args=())
        return self._create_model(results, run_id, store)

    # --- framework-specific hooks ---
    def _train_fn(self, remote_store):
        """Return a picklable fn() run on every rank; must train and (on
        rank 0) write the checkpoint to remote_store.checkpoint_path, and
        return per-rank history/metadata."""
        raise NotImplementedError()

    def _create_model(self, results: List[Any], run_id: str,
                      store: Store) -> "HorovodModel":
        raise NotImplementedError()


class HorovodModel:
    """Fitted model wrapper (reference: spark/common/estimator.py
    HorovodModel): predicts locally; with pyspark, ``transform`` adds an
    output column per label. ``save``/``load`` give the Spark-ML
    MLWritable/MLReadable round trip (reference:
    spark/common/serialization.py HorovodParamsWriter/Reader): model
    payload + metadata + run linkage persisted under the store's run
    directory."""

    _MODEL_META = "model_meta.json"
    _MODEL_BLOB = "model.bin"

    def save(self, store: Optional[Store] = None,
             run_id: Optional[str] = None) -> str:
        """Persist this fitted model under ``store``'s run directory;
        returns the run path. Defaults to the model's own store/run."""
        import json

        store = store or self.store
        run_id = run_id or self.run_id
        run_path = store.get_run_path(run_id)
        meta = {
            "class": "%s.%s" % (type(self).__module__,
                                type(self).__qualname__),
            "run_id": run_id,
            "feature_cols": self.feature_cols,
            "history": self.history,
        }
        store.write_text(store._join(run_path, self._MODEL_META),
                         json.dumps(meta, default=float))
        store.write_bytes(store._join(run_path, self._MODEL_BLOB),
                          self._payload_bytes())
        return run_path

    @classmethod
    def load(cls, store: Store, run_id: str) -> "HorovodModel":
        """Reconstruct a fitted model saved with :meth:`save`. Can be
        called on ``HorovodModel`` (the metadata names the concrete
        class) or directly on the subclass."""
        import importlib
        import json

        run_path = store.get_run_path(run_id)
        meta = json.loads(store.read(
            store._join(run_path, cls._MODEL_META)).decode())
        mod, _, qual = meta["class"].rpartition(".")
        klass = getattr(importlib.import_module(mod), qual)
        if cls is not HorovodModel and not issubclass(klass, cls):
            raise TypeError("run %r holds a %s, not a %s"
                            % (run_id, klass.__name__, cls.__name__))
        blob = store.read(store._join(run_path, cls._MODEL_BLOB))
        return klass._from_payload(blob, meta, store)

    # --- subclass hooks ---
    def _payload_bytes(self) -> bytes:
        raise NotImplementedError()

    @classmethod
    def _from_payload(cls, blob: bytes, meta: dict,
                      store: Store) -> "HorovodModel":
        raise NotImplementedError()

    def __init__(self, history, run_id: str, store: Store,
                 feature_cols: Optional[List[str]] = None):
        self.history = history
        self.run_id = run_id
        self.store = store
        # The columns the model was trained on — transform must feed
        # exactly these (in order), never every DataFrame column (which
        # would include the label and give the feature matrix the wrong
        # width).
        self.feature_cols = list(feature_cols) if feature_cols else None

    def predict(self, features):
        raise NotImplementedError()

    def transform(self, df):  # pragma: no cover - needs pyspark
        import pandas as pd
        from pyspark.sql.functions import pandas_udf

        model = self

        @pandas_udf("double")
        def _predict(*cols: pd.Series) -> pd.Series:
            import numpy as np

            x = np.stack([c.to_numpy() for c in cols], axis=1)
            return pd.Series(
                np.asarray(model.predict(x)).reshape(len(cols[0]), -1)[:, 0])

        out_col = "prediction"
        feature_cols = self.feature_cols or [c for c in df.columns]
        return df.withColumn(out_col, _predict(*[df[c]
                                                 for c in feature_cols]))
