"""Storage layer for materialized datasets and training artifacts.

Port of ``horovod_tpu/spark/common/store.py``, unchanged in behaviour;
``HDFSStore`` imports ``pyarrow.fs`` only where it uses it.

Parity with the reference's Store abstraction
(reference: horovod/spark/common/store.py:36-550): a Store owns an
intermediate-data prefix (materialized DataFrames as Parquet) plus
per-run directories for checkpoints and logs. ``Store.create(prefix)``
picks the backend from the path scheme (hdfs:// -> HDFSStore, otherwise
filesystem). ``to_remote`` produces a picklable view shipped to training
processes.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional


def _atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename so a killed writer never leaves a truncated
    artifact under the final name; the orphaned temp is unlinked on a
    failed write (full disk etc.)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.%d" % os.getpid()
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class Store:
    """(reference: spark/common/store.py:36-160)

    Path layout is shared by every backend (see ``_init_prefix_paths`` /
    ``_join``); subclasses provide the IO primitives and directory
    listing.
    """

    def __init__(self):
        self._train_data_to_key = {}
        self._val_data_to_key = {}

    # --- layout (shared) ---
    def _init_prefix_paths(self, prefix_path: str,
                           train_path: Optional[str],
                           val_path: Optional[str],
                           test_path: Optional[str],
                           runs_path: Optional[str],
                           save_runs: bool) -> None:
        self.prefix_path = prefix_path
        self._train_path = train_path or self._join(
            prefix_path, "intermediate_train_data")
        self._val_path = val_path or self._join(
            prefix_path, "intermediate_val_data")
        self._test_path = test_path or self._join(
            prefix_path, "intermediate_test_data")
        self._runs_path = runs_path or self._join(prefix_path, "runs")
        self._save_runs = save_runs

    def _join(self, base: str, name: str) -> str:
        """Join path components in this backend's convention."""
        raise NotImplementedError()

    @staticmethod
    def _with_idx(path: str, idx) -> str:
        return path if idx is None else "%s.%s" % (path, idx)

    def get_train_data_path(self, idx=None) -> str:
        return self._with_idx(self._train_path, idx)

    def get_val_data_path(self, idx=None) -> str:
        return self._with_idx(self._val_path, idx)

    def get_test_data_path(self, idx=None) -> str:
        return self._with_idx(self._test_path, idx)

    def saving_runs(self) -> bool:
        return self._save_runs

    def get_runs_path(self) -> str:
        return self._runs_path

    def get_run_path(self, run_id: str) -> str:
        return self._join(self._runs_path, run_id)

    def get_checkpoint_path(self, run_id: str) -> str:
        return self._join(self.get_run_path(run_id),
                          self.get_checkpoint_filename())

    def get_checkpoints(self, run_id: str,
                        suffix: str = ".ckpt") -> List[str]:
        return sorted(p for p in self._list_dir(self.get_run_path(run_id))
                      if p.endswith(suffix))

    def get_logs_path(self, run_id: str) -> str:
        return self._join(self.get_run_path(run_id),
                          self.get_logs_subdir())

    def get_checkpoint_filename(self) -> str:
        return "checkpoint.ckpt"

    def get_logs_subdir(self) -> str:
        return "logs"

    # --- io (backend-specific) ---
    def is_parquet_dataset(self, path: str) -> bool:
        raise NotImplementedError()

    def _list_dir(self, path: str) -> List[str]:
        """Full paths of directory entries; [] for a missing dir."""
        raise NotImplementedError()

    def exists(self, path: str) -> bool:
        raise NotImplementedError()

    def read(self, path: str) -> bytes:
        raise NotImplementedError()

    def write_text(self, path: str, text: str) -> None:
        raise NotImplementedError()

    def write_bytes(self, path: str, data: bytes) -> None:
        raise NotImplementedError()

    def _remote_spec(self):
        """Picklable recipe to rebuild an equivalent store inside a
        training process, or None when local file IO suffices (plain
        filesystem stores). Non-local backends override."""
        return None

    def to_remote(self, run_id: str, dataset_idx=None):
        """Picklable view for training processes
        (reference: store.py:130-160). Besides the path attributes, the
        view exposes ``exists/read/write_bytes`` so train fns do
        checkpoint IO through the STORE's backend — plain open()/
        os.path would silently write local junk for hdfs:// paths."""
        attrs = {
            "train_data_path": self.get_train_data_path(dataset_idx),
            "val_data_path": self.get_val_data_path(dataset_idx),
            "test_data_path": self.get_test_data_path(dataset_idx),
            "saving_runs": self.saving_runs(),
            "runs_path": self.get_runs_path(),
            "run_path": self.get_run_path(run_id),
            "checkpoint_path": self.get_checkpoint_path(run_id),
            "logs_path": self.get_logs_path(run_id),
            "checkpoint_filename": self.get_checkpoint_filename(),
            "logs_subdir": self.get_logs_subdir(),
        }
        return RemoteStore(attrs, self._remote_spec())

    @staticmethod
    def create(prefix_path: str, *args, **kwargs) -> "Store":
        if HDFSStore.matches(prefix_path):
            return HDFSStore(prefix_path, *args, **kwargs)
        if DBFSLocalStore.matches_dbfs(prefix_path):
            return DBFSLocalStore(prefix_path, *args, **kwargs)
        return FilesystemStore(prefix_path, *args, **kwargs)


class RemoteStore:
    """Picklable worker-side store view (reference: the remote-store
    objects shipped by spark/common/store.py Store.to_remote)."""

    def __init__(self, attrs, spec):
        self.__dict__.update(attrs)
        self._spec = spec
        self._store = None

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_store"] = None  # backend clients don't pickle
        return state

    def _backend(self):
        if self._store is None and self._spec is not None:
            cls_name, kwargs = self._spec
            self._store = {
                "FilesystemStore": FilesystemStore,
                "LocalStore": LocalStore,
                "HDFSStore": HDFSStore,
            }[cls_name](**kwargs)
        return self._store

    def exists(self, path: str) -> bool:
        store = self._backend()
        if store is not None:
            return store.exists(path)
        return os.path.exists(path)

    def read(self, path: str) -> bytes:
        store = self._backend()
        if store is not None:
            return store.read(path)
        with open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        store = self._backend()
        if store is not None:
            store.write_bytes(path, data)
            return
        _atomic_write(path, data)


class FilesystemStore(Store):
    """Store on a mounted filesystem
    (reference: store.py:165-350 AbstractFilesystemStore/FilesystemStore)."""

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None,
                 save_runs: bool = True):
        super().__init__()
        self._init_prefix_paths(
            self._normalize(prefix_path), self._normalize(train_path),
            self._normalize(val_path), self._normalize(test_path),
            self._normalize(runs_path), save_runs)

    @staticmethod
    def _normalize(path: Optional[str]) -> Optional[str]:
        if path is None:
            return None
        if path.startswith("file://"):
            path = path[len("file://"):]
        return path

    def _join(self, base: str, name: str) -> str:
        return os.path.join(base, name)

    def is_parquet_dataset(self, path: str) -> bool:
        path = self._normalize(path)
        if not os.path.isdir(path):
            return False
        return any(f.endswith(".parquet") for f in os.listdir(path))

    def _list_dir(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return [os.path.join(path, f) for f in os.listdir(path)]

    def exists(self, path: str) -> bool:
        return os.path.exists(self._normalize(path))

    def read(self, path: str) -> bytes:
        with open(self._normalize(path), "rb") as f:
            return f.read()

    def write_text(self, path: str, text: str) -> None:
        path = self._normalize(path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)

    def write_bytes(self, path: str, data: bytes) -> None:
        _atomic_write(self._normalize(path), data)

    def copy_dir(self, src: str, dst: str) -> None:
        shutil.copytree(self._normalize(src), self._normalize(dst),
                        dirs_exist_ok=True)

    def make_run_dirs(self, run_id: str) -> None:
        os.makedirs(self.get_run_path(run_id), exist_ok=True)
        os.makedirs(self.get_logs_path(run_id), exist_ok=True)


class LocalStore(FilesystemStore):
    """(reference: store.py:341-350)"""


class HDFSStore(Store):
    """HDFS-backed store over ``pyarrow.fs``
    (reference: store.py:351-486 HDFSStore).

    Constructed from ``hdfs://[host[:port]]/prefix``, every path this
    store hands out KEEPS the full ``hdfs://authority/...`` URI, so
    pandas/pyarrow dataset readers and writers route it to the Hadoop
    filesystem layer rather than local disk; the store's own IO strips
    the scheme and talks to its ``pyarrow.fs.HadoopFileSystem``
    (libhdfs + the usual ``HADOOP_HOME``/CLASSPATH environment).

    For tests — or any other ``pyarrow.fs.FileSystem`` — pass
    ``filesystem=`` with a plain path prefix; paths then stay plain.
    """

    PREFIX = "hdfs://"

    @classmethod
    def matches(cls, path: str) -> bool:
        return bool(path) and path.startswith(cls.PREFIX)

    def __init__(self, prefix_path: str,
                 train_path: Optional[str] = None,
                 val_path: Optional[str] = None,
                 test_path: Optional[str] = None,
                 runs_path: Optional[str] = None,
                 save_runs: bool = True,
                 filesystem=None):
        super().__init__()
        self._uri = ""
        self._fs = filesystem
        # Rebuildable inside workers only when the client comes from a
        # URL (an injected filesystem object is not picklable/derivable).
        self._ctor_url = None if filesystem is not None else prefix_path
        if self._fs is None:  # pragma: no cover - needs a live cluster
            from pyarrow import fs as pafs

            host, port, path = self._parse_url(prefix_path)
            authority = host + (":%d" % port if port else "")
            self._uri = self.PREFIX + authority
            self._fs = pafs.HadoopFileSystem(host=host, port=port)
            prefix_path = self._uri + path
        self._init_prefix_paths(prefix_path.rstrip("/"), train_path,
                                val_path, test_path, runs_path,
                                save_runs)

    def _remote_spec(self):
        if self._ctor_url is None:
            from pyarrow import fs as pafs

            if type(self._fs) is pafs.LocalFileSystem:
                # A bare LocalFileSystem maps paths 1:1, so the
                # workers' local-IO fallback is correct. Anything that
                # remaps paths (SubTreeFileSystem) or talks to a
                # remote backend must be rejected — the fallback
                # would write to the wrong place.
                return None
            raise ValueError(
                "a %s injected via filesystem= cannot be shipped to "
                "training processes (the client is not picklable and "
                "worker-local IO would write to the wrong place); "
                "construct the store from an hdfs:// URL instead"
                % type(self._fs).__name__)
        return ("HDFSStore", {"prefix_path": self._ctor_url,
                              "save_runs": self._save_runs})

    @classmethod
    def _parse_url(cls, url: str):
        rest = url[len(cls.PREFIX):] if url.startswith(cls.PREFIX) else url
        if "/" in rest:
            authority, path = rest.split("/", 1)
        else:
            authority, path = rest, ""
        host, _, port = authority.partition(":")
        return (host or "default", int(port) if port else 0, "/" + path)

    def _join(self, base: str, name: str) -> str:
        return base.rstrip("/") + "/" + name

    def _strip(self, path: str) -> str:
        """URI -> filesystem path for pyarrow.fs calls."""
        if self._uri and path.startswith(self._uri):
            return path[len(self._uri):]
        return path

    def is_parquet_dataset(self, path: str) -> bool:
        from pyarrow import fs as pafs

        path = self._strip(path)
        info = self._fs.get_file_info(path)
        if info.type != pafs.FileType.Directory:
            return False
        sel = pafs.FileSelector(path, recursive=False)
        return any(i.path.endswith(".parquet")
                   for i in self._fs.get_file_info(sel))

    def _list_dir(self, path: str) -> List[str]:
        from pyarrow import fs as pafs

        fs_path = self._strip(path)
        if self._fs.get_file_info(fs_path).type != pafs.FileType.Directory:
            return []
        sel = pafs.FileSelector(fs_path, recursive=False)
        return [self._uri + i.path if self._uri else i.path
                for i in self._fs.get_file_info(sel)]

    def exists(self, path: str) -> bool:
        from pyarrow import fs as pafs

        return (self._fs.get_file_info(self._strip(path)).type
                != pafs.FileType.NotFound)

    def read(self, path: str) -> bytes:
        with self._fs.open_input_stream(self._strip(path)) as f:
            return f.read()

    def write_text(self, path: str, text: str) -> None:
        self.write_bytes(path, text.encode())

    def write_bytes(self, path: str, data: bytes) -> None:
        path = self._strip(path)
        parent = path.rsplit("/", 1)[0]
        self._fs.create_dir(parent, recursive=True)
        with self._fs.open_output_stream(path) as f:
            f.write(data)

    def make_run_dirs(self, run_id: str) -> None:
        self._fs.create_dir(self._strip(self.get_run_path(run_id)),
                            recursive=True)
        self._fs.create_dir(self._strip(self.get_logs_path(run_id)),
                            recursive=True)


# The reference's class split names the filesystem base
# AbstractFilesystemStore (store.py:165); here the base and the
# concrete store are one class, so the reference name is an alias.
AbstractFilesystemStore = FilesystemStore


def is_databricks() -> bool:
    """(reference: spark/common/util.py:710-711)"""
    return "DATABRICKS_RUNTIME_VERSION" in os.environ


class DBFSLocalStore(FilesystemStore):
    """Store over Databricks DBFS local-file APIs (reference:
    store.py:487-520): normalizes `dbfs:/...` and `file:///dbfs/...`
    forms to `/dbfs/...` and warns when the path is outside /dbfs
    (such paths are ephemeral on Databricks clusters)."""

    def __init__(self, prefix_path: str, *args, **kwargs):
        if not self.normalize_path(prefix_path).startswith("/dbfs/"):
            import warnings

            warnings.warn(
                "The provided prefix_path might be ephemeral: %s — "
                "prefer a prefix_path under /dbfs/" % prefix_path)
        # Every path argument (train/val/test/runs too, not just the
        # prefix) routes through _normalize below.
        super().__init__(prefix_path, *args, **kwargs)

    @staticmethod
    def _normalize(path: Optional[str]) -> Optional[str]:
        path = FilesystemStore._normalize(path)
        if path is None:
            return None
        return DBFSLocalStore.normalize_path(path)

    @classmethod
    def matches_dbfs(cls, path: str) -> bool:
        return (path.startswith("dbfs:/") or path.startswith("/dbfs/")
                or path.startswith("file:///dbfs/"))

    @staticmethod
    def normalize_path(path: str) -> str:
        if path.startswith("dbfs:/"):
            return "/dbfs" + path[len("dbfs:"):]
        if path.startswith("file:///dbfs/"):
            return path[len("file://"):]
        return path
