"""Dataset metadata utilities for the estimator data path.

Port of ``horovod_tpu/spark/common/util.py``, unchanged in behaviour: it
loads no native core and touches no device, and imports pyarrow only
where it reads Parquet.

Parity with the reference's spark util layer
(reference: horovod/spark/common/util.py — _get_metadata infers
per-column type/shape metadata from the DataFrame, check_validation
validates the validation spec, get_simple_meta_from_parquet reads
row counts / schema / avg_row_size back from the materialized Parquet;
estimators persist the metadata with the run and check compatibility
before reusing prepared data).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple


def check_validation(validation) -> None:
    """Validate the estimator's ``validation`` param
    (reference: util.py check_validation): None, a float fraction in
    (0,1), or the name of an existing 0/1 column."""
    if validation is None:
        return
    if isinstance(validation, float):
        if not 0.0 < validation < 1.0:
            raise ValueError(
                "validation fraction must be in (0, 1), got %r"
                % validation)
        return
    if isinstance(validation, str):
        if not validation:
            raise ValueError("validation column name must be non-empty")
        return
    raise ValueError(
        "validation must be None, a float fraction, or a column name; "
        "got %r" % (validation,))


def get_metadata_from_parquet(
        path: str,
        label_columns=None,
        feature_columns=None) -> Tuple[int, Dict[str, Any], float]:
    """Read (row_count, per-column metadata, avg_row_size_bytes) from a
    materialized Parquet dataset (reference: util.py
    get_simple_meta_from_parquet:440-510 — same three outputs, used to
    size shards and validate schema compatibility)."""
    import pyarrow.parquet as pq

    files = sorted(f for f in os.listdir(path)
                   if f.endswith(".parquet"))
    if not files:
        raise FileNotFoundError("no .parquet files under %r" % path)
    rows = 0
    total_bytes = 0
    schema = None
    for fn in files:
        pf = pq.ParquetFile(os.path.join(path, fn))
        rows += pf.metadata.num_rows
        for g in range(pf.num_row_groups):
            total_bytes += pf.metadata.row_group(g).total_byte_size
        if schema is None:
            schema = pf.schema_arrow
    metadata = {}
    for field in schema:
        metadata[field.name] = {
            "dtype": str(field.type),
            "nullable": field.nullable,
        }
    for name in (label_columns or []):
        if name not in metadata:
            raise ValueError("label column %r not in dataset (have %s)"
                             % (name, sorted(metadata)))
    for name in (feature_columns or []):
        if name not in metadata:
            raise ValueError("feature column %r not in dataset (have %s)"
                             % (name, sorted(metadata)))
    avg_row_size = (total_bytes / rows) if rows else 0.0
    return rows, metadata, avg_row_size


def save_metadata(run_path: str, metadata: Dict[str, Any]) -> None:
    """Persist dataset metadata with the run (reference: estimators
    write metadata alongside checkpoints for later compat checks)."""
    os.makedirs(run_path, exist_ok=True)
    with open(os.path.join(run_path, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=1, sort_keys=True)


def load_metadata(run_path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(run_path, "metadata.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def check_metadata_compatibility(saved: Dict[str, Any],
                                 current: Dict[str, Any]) -> None:
    """A model trained against one schema must not silently transform
    data with another (reference: estimator
    _check_metadata_compatibility — compares column sets and types)."""
    missing = set(saved) - set(current)
    added = set(current) - set(saved)
    if missing or added:
        raise ValueError(
            "dataset schema changed: missing columns %s, new columns %s"
            % (sorted(missing), sorted(added)))
    for name, meta in saved.items():
        if current[name]["dtype"] != meta["dtype"]:
            raise ValueError(
                "column %r changed dtype %s -> %s"
                % (name, meta["dtype"], current[name]["dtype"]))
