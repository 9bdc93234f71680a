"""The port's Spark data path against the reference's, in one process.

``horovod_tpu_torch.spark``'s util, params, store, convert, estimator data
functions and data loaders load no native core, so each is held to its
``horovod_tpu.spark`` counterpart on the same seeded DataFrames here: the
metadata dicts, the written Parquet tables and schema sidecars,
``build_feature_matrix``'s arrays, the shard splits and the loaders'
batches must be equal; paths are compared relative to each store's root.
``HDFSStore`` runs over an injected ``pyarrow.fs.LocalFileSystem``, as
tests/test_spark_estimators.py runs the reference's.
"""

import json
import os

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest

import horovod_tpu.spark.common.convert as ref_convert
import horovod_tpu.spark.common.estimator as ref_estimator
import horovod_tpu.spark.common.params as ref_params
import horovod_tpu.spark.common.store as ref_store
import horovod_tpu.spark.common.util as ref_util
import horovod_tpu.spark.data_loaders as ref_loaders
import horovod_tpu_torch.spark.common.convert as convert
import horovod_tpu_torch.spark.common.estimator as estimator
import horovod_tpu_torch.spark.common.params as params
import horovod_tpu_torch.spark.common.store as store
import horovod_tpu_torch.spark.common.util as util
import horovod_tpu_torch.spark.data_loaders as loaders

PACKAGES = {"ref": (ref_convert, ref_estimator, ref_params, ref_store,
                    ref_util, ref_loaders),
            "port": (convert, estimator, params, store, util, loaders)}


def _frames():
    """Seeded frames: scalars, dense arrays, mixed int/float arrays,
    sparse vectors and all of them together."""
    rng = np.random.RandomState(5)
    n = 23
    scalar = pd.DataFrame({"a": rng.rand(n), "b": rng.randint(0, 9, n),
                           "y": rng.rand(n)})
    arrays = pd.DataFrame({
        "v": [rng.rand(3).astype(np.float32) for _ in range(n)],
        "m": [rng.rand(2, 2) for _ in range(n)],
        "y": rng.rand(n)})
    mixed = pd.DataFrame({
        "v": [np.arange(3) if i % 2 else rng.rand(3) for i in range(n)],
        "y": rng.rand(n)})

    def sparse(mod):
        out = []
        for i in range(n):
            idx = sorted(rng.choice(7, size=i % 4, replace=False))
            out.append(mod.SparseVector(7, idx, rng.rand(len(idx))))
        return out

    seed = rng.get_state()
    frames = {"scalar": lambda mod: scalar.copy(),
              "arrays": lambda mod: arrays.copy(),
              "mixed": lambda mod: mixed.copy()}

    def sparse_frame(mod):
        rng.set_state(seed)
        return pd.DataFrame({"s": sparse(mod), "a": scalar["a"],
                             "y": scalar["y"]})

    def everything(mod):
        rng.set_state(seed)
        return pd.DataFrame({"s": sparse(mod), "v": arrays["v"],
                             "a": scalar["a"], "y": scalar["y"]})

    frames["sparse"] = sparse_frame
    frames["everything"] = everything
    return frames


FRAMES = _frames()
FEATURES = {"scalar": ["a", "b"], "arrays": ["v", "m"], "mixed": ["v"],
            "sparse": ["s", "a"], "everything": ["s", "v", "a"]}


def _same(a, b):
    """Deep equality over dicts, lists, numpy arrays, sparse vectors and
    DataFrames, across the two packages' classes."""
    if isinstance(a, pd.DataFrame):
        assert list(a.columns) == list(b.columns)
        assert len(a) == len(b)
        for c in a.columns:
            for x, y in zip(a[c], b[c]):
                _same(x, y)
        return
    if hasattr(a, "indices") and hasattr(a, "size") and \
            not isinstance(a, np.ndarray):
        assert type(a).__name__ == type(b).__name__
        assert a.size == b.size
        _same(a.indices, b.indices)
        _same(a.values, b.values)
        return
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
        return
    assert a == b or (a != a and b != b), (a, b)


# ---------------------------------------------------------------- convert ---

@pytest.mark.parametrize("name", sorted(FRAMES))
def test_infer_metadata_matches(name):
    got = convert.infer_metadata(FRAMES[name](convert))
    want = ref_convert.infer_metadata(FRAMES[name](ref_convert))
    assert got == want


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_columnar_write_matches(name, tmp_path):
    out = {}
    for key, (conv, *_rest) in PACKAGES.items():
        path = str(tmp_path / key)
        meta = conv.write_columnar(FRAMES[name](conv), path,
                                   row_group_rows=5, num_files=2)
        files = sorted(f for f in os.listdir(path) if f.endswith(".parquet"))
        tables = [pq.read_table(os.path.join(path, f)) for f in files]
        with open(os.path.join(path, conv.SCHEMA_SIDECAR), "rb") as f:
            sidecar = f.read()
        groups = [pq.ParquetFile(os.path.join(path, f)).num_row_groups
                  for f in files]
        out[key] = (meta, files, tables, sidecar, groups, path)
    (m1, f1, t1, s1, g1, p1), (m2, f2, t2, s2, g2, p2) = \
        out["port"], out["ref"]
    assert m1 == m2 and f1 == f2 and s1 == s2 and g1 == g2
    assert all(a.equals(b) for a, b in zip(t1, t2))
    # Read back and restored: ndarray and SparseVector cells again.
    got = convert.restore_dataframe(pd.concat(
        [t.to_pandas() for t in t1], ignore_index=True),
        convert.load_schema_sidecar(p1))
    want = ref_convert.restore_dataframe(pd.concat(
        [t.to_pandas() for t in t2], ignore_index=True),
        ref_convert.load_schema_sidecar(p2))
    _same(got, want)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_build_feature_matrix_matches(name):
    got = convert.build_feature_matrix(FRAMES[name](convert),
                                       FEATURES[name])
    want = ref_convert.build_feature_matrix(FRAMES[name](ref_convert),
                                            FEATURES[name])
    _same(got, want)
    assert got.dtype == np.float32


def test_sparse_vector_contract_matches():
    for mod in (convert, ref_convert):
        with pytest.raises(ValueError):
            mod.SparseVector(3, [0, 5], [1.0, 2.0])
        with pytest.raises(ValueError):
            mod.SparseVector(3, [0], [1.0, 2.0])
    a = convert.SparseVector(5, [1, 3], [2.0, -1.0])
    b = ref_convert.SparseVector(5, [1, 3], [2.0, -1.0])
    _same(a.toArray(), b.toArray())
    assert a.nnz == b.nnz and repr(a) == repr(b)


def test_infer_metadata_rejects_like_the_reference():
    ragged = {"v": [np.zeros(2), np.zeros(3)]}
    mixed = {"v": [np.zeros(2), 1.0]}
    for cols in (ragged, mixed):
        errs = []
        for mod in (convert, ref_convert):
            with pytest.raises(ValueError) as e:
                mod.infer_metadata(pd.DataFrame(cols))
            errs.append(str(e.value))
        assert errs[0] == errs[1]


# ------------------------------------------------- materialize and shards ---

@pytest.mark.parametrize("validation", [None, 0.3, "flag"])
@pytest.mark.parametrize("name", ["scalar", "everything"])
def test_materialize_and_shards_match(name, validation, tmp_path):
    shards = {}
    for key, (conv, est, *_rest) in PACKAGES.items():
        pdf = FRAMES[name](conv)
        pdf["flag"] = np.arange(len(pdf)) % 3 == 0
        path = str(tmp_path / key)
        est.materialize_dataframe(pdf, path, validation=validation)
        shards[key] = [est.read_shard(path, r, 3,
                                      validation_col=est.VALIDATION_COL)
                       for r in range(3)]
        shards[key + "_rowgroups"] = [est.read_shard_rowgroups(path, r, 2)
                                      for r in range(2)]
    for key in ("", "_rowgroups"):
        got, want = shards["port" + key], shards["ref" + key]
        for g, w in zip(got, want):
            if key:
                _same(g, w)
            else:
                _same(g[0], w[0])
                assert (g[1] is None) == (w[1] is None)
                if g[1] is not None:
                    _same(g[1].reset_index(drop=True),
                          w[1].reset_index(drop=True))


def test_empty_rowgroup_shard_keeps_feature_width(tmp_path):
    widths = []
    for conv, est, *_rest in PACKAGES.values():
        path = str(tmp_path / conv.__name__)
        conv.write_columnar(FRAMES["everything"](conv).iloc[:3], path,
                            row_group_rows=64)
        empty = est.read_shard_rowgroups(path, 1, 2)
        widths.append(conv.build_feature_matrix(
            empty, FEATURES["everything"]).shape)
    assert widths[0] == widths[1] == (0, 7 + 3 + 1)


# ------------------------------------------------------------------- util ---

@pytest.mark.parametrize("value", [None, 0.2, "col", 1.5, 0.0, "", 3, []])
def test_check_validation_matches(value):
    outcomes = []
    for mod in (util, ref_util):
        try:
            mod.check_validation(value)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_metadata_utils_match(tmp_path):
    got = {}
    for key, (conv, est, _p, _s, mod, _l) in PACKAGES.items():
        path = str(tmp_path / key / "data")
        est.materialize_dataframe(FRAMES["arrays"](conv), path)
        rows, meta, avg = mod.get_metadata_from_parquet(
            path, label_columns=["y"], feature_columns=["v"])
        with pytest.raises(ValueError):
            mod.get_metadata_from_parquet(path, label_columns=["nope"])
        run = str(tmp_path / key / "run")
        mod.save_metadata(run, meta)
        with open(os.path.join(run, "metadata.json"), "rb") as f:
            saved = f.read()
        assert mod.load_metadata(run) == json.loads(saved)
        assert mod.load_metadata(str(tmp_path / key / "none")) is None
        drifted = dict(meta, extra={"dtype": "int64", "nullable": True})
        with pytest.raises(ValueError) as e:
            mod.check_metadata_compatibility(meta, drifted)
        got[key] = (rows, meta, avg, saved, str(e.value))
    assert got["port"] == got["ref"]


# ----------------------------------------------------------------- params ---

def test_estimator_params_match():
    a, b = params.EstimatorParams(), ref_params.EstimatorParams()
    assert a.get_params() == b.get_params()
    assert params.EstimatorParams._param_names == \
        ref_params.EstimatorParams._param_names
    for mod in (params, ref_params):
        p = mod.EstimatorParams(batch_size=16, epochs=2)
        assert (p.batch_size, p.epochs) == (16, 2)
        with pytest.raises(ValueError):
            mod.EstimatorParams(no_such_param=1)
        for bad in ({"model": None}, {"model": 1, "epochs": 0},
                    {"model": 1, "batch_size": 0}):
            with pytest.raises(ValueError):
                mod.EstimatorParams(**bad)._validate_fit()


# ------------------------------------------------------------------ store ---

def _rel(value, root):
    if isinstance(value, str):
        return value.replace(root, "<root>")
    if isinstance(value, dict):
        return {k: _rel(v, root) for k, v in value.items()}
    return value


def test_filesystem_store_matches(tmp_path):
    seen = {}
    for key, mod in (("port", store), ("ref", ref_store)):
        root = str(tmp_path / key)
        s = mod.Store.create("file://" + root)
        assert type(s).__name__ == "FilesystemStore"
        s.make_run_dirs("r1")
        s.write_text(os.path.join(s.get_run_path("r1"), "a.txt"), "hello")
        s.write_bytes(os.path.join(s.get_run_path("r1"), "m.ckpt"), b"\x00")
        remote = s.to_remote("r1", dataset_idx=2)
        remote.write_bytes(remote.checkpoint_path, b"ck")
        seen[key] = _rel(dict(
            train=s.get_train_data_path(), val=s.get_val_data_path(1),
            test=s.get_test_data_path(), runs=s.get_runs_path(),
            ckpt=s.get_checkpoint_path("r1"), logs=s.get_logs_path("r1"),
            ckpts=[os.path.basename(p) for p in s.get_checkpoints("r1")],
            read=s.read(os.path.join(s.get_run_path("r1"), "a.txt")),
            exists=s.exists(s.get_logs_path("r1")),
            parquet=s.is_parquet_dataset(s.get_train_data_path()),
            remote={k: v for k, v in vars(remote).items()
                    if not k.startswith("_")},
            remote_read=remote.read(remote.checkpoint_path),
            remote_exists=remote.exists(remote.run_path)), root)
    assert seen["port"] == seen["ref"]


def test_store_create_and_dbfs_match(monkeypatch):
    import warnings

    for path in ("/dbfs/x", "dbfs:/x/y", "file:///dbfs/z"):
        got = store.Store.create(path)
        want = ref_store.Store.create(path)
        assert type(got).__name__ == type(want).__name__ == "DBFSLocalStore"
        assert got.get_train_data_path() == want.get_train_data_path()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        store.DBFSLocalStore("/tmp/ephemeral")
    assert any("ephemeral" in str(w.message) for w in caught)
    assert store.HDFSStore._parse_url("hdfs://nn:9000/a/b") == \
        ref_store.HDFSStore._parse_url("hdfs://nn:9000/a/b")
    monkeypatch.setenv("DATABRICKS_RUNTIME_VERSION", "13")
    assert store.is_databricks() and ref_store.is_databricks()


def test_hdfs_store_over_an_injected_filesystem_matches(tmp_path):
    from pyarrow import fs as pafs

    seen = {}
    for key, mod in (("port", store), ("ref", ref_store)):
        root = str(tmp_path / key)
        os.makedirs(root)
        s = mod.HDFSStore(root, filesystem=pafs.LocalFileSystem())
        s.make_run_dirs("r1")
        p = s.get_run_path("r1") + "/blob.bin"
        s.write_bytes(p, b"\x00\x01hvd")
        s.write_text(s.get_run_path("r1") + "/note.txt", "hi")
        s.write_bytes(s.get_run_path("r1") + "/model.ckpt", b"x")
        remote = s.to_remote("r1")
        seen[key] = _rel(dict(
            train=s.get_train_data_path(), run=s.get_run_path("r1"),
            exists=s.exists(s.get_logs_path("r1")), read=s.read(p),
            note=s.read(s.get_run_path("r1") + "/note.txt"),
            ckpts=[os.path.basename(c) for c in s.get_checkpoints("r1")],
            parquet=s.is_parquet_dataset(s.get_train_data_path()),
            remote_read=remote.read(p)), root)
        sub = mod.HDFSStore(root, filesystem=pafs.SubTreeFileSystem(
            root, pafs.LocalFileSystem()))
        with pytest.raises(ValueError, match="cannot be shipped"):
            sub.to_remote("r1")
    assert seen["port"] == seen["ref"]


# ---------------------------------------------------------------- loaders ---

@pytest.mark.parametrize("shuffle", [False, True])
def test_shard_loaders_match(shuffle):
    pdfs = {k: FRAMES["everything"](PACKAGES[k][0]) for k in PACKAGES}
    batches = {}
    for key, (*_rest, mod) in PACKAGES.items():
        loader = mod.PandasShardDataLoader(
            pdfs[key], FEATURES["everything"], ["y"], batch_size=4,
            shuffle=shuffle, seed=11)
        aloader = mod.AsyncPandasShardDataLoader(
            pdfs[key], FEATURES["everything"], ["y"], batch_size=4,
            shuffle=shuffle, seed=11, async_loader_queue_size=2)
        buffered = mod.ShufflingBufferDataLoader(
            mod.PandasShardDataLoader(pdfs[key], ["a"], ["y"], batch_size=3,
                                      shuffle=False), capacity=3, seed=4)
        batches[key] = (len(loader), list(loader), list(aloader),
                        len(buffered), list(buffered))
        aloader.close_async_loader()
    _same(batches["port"], batches["ref"])
    assert batches["port"][0] == 6
