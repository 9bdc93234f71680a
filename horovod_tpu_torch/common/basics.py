"""Process topology and lifecycle for horovod_tpu_torch.

Port of ``horovod_tpu/common/basics.py``. The launcher environment contract
is the same (``HOROVOD_RANK``/``SIZE``/``LOCAL_*``/``CROSS_*``, with the
OpenMPI/PMI/Slurm fallbacks), read by a verbatim copy of the reference's
``_topology_from_env``, so one environment gives one topology in both
packages. The data plane is a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU. ``init`` builds it at every world size, size 1
included, so the gradient allreduce always runs through the collective
backend it would use at scale.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist


@dataclass
class Topology:
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1


@dataclass
class _Context:
    initialized: bool = False
    topology: Topology = field(default_factory=Topology)
    lock: threading.RLock = field(default_factory=threading.RLock)


_ctx = _Context()


# ---- verbatim from horovod_tpu/common/basics.py:87-155 ----

def _int_env(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)


def _first_int_env(names, default: int) -> int:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            # Slurm counts can carry a repeat suffix ("4(x2)"): take the
            # leading integer.
            digits = ""
            for ch in v:
                if ch.isdigit():
                    digits += ch
                else:
                    break
            if digits:
                return int(digits)
    return default


def _topology_from_env() -> Topology:
    """Read the launcher environment. HOROVOD_* takes priority; under a
    bare ``mpirun`` (hvdrun --use-mpi) the standard MPI launcher vars
    (OpenMPI/PMI/Slurm) supply rank/size instead (the reference gets these
    from MPI_Comm_rank after MPI_Init; we read the launcher's env)."""
    # Launcher fallbacks are accepted only as rank+size *pairs* from the
    # same launcher: a plain `python train.py` inside an sbatch/salloc
    # allocation has SLURM_NTASKS but no per-task step vars, and must
    # stay a size-1 run rather than hang waiting for phantom peers —
    # and conversely a rank var must never be honored without its size
    # counterpart (rank 3 of size 1 silently trains standalone).
    size_vars, rank_vars = ["HOROVOD_SIZE"], ["HOROVOD_RANK"]
    lsize_vars, lrank_vars = ["HOROVOD_LOCAL_SIZE"], ["HOROVOD_LOCAL_RANK"]
    if ("OMPI_COMM_WORLD_RANK" in os.environ
            and "OMPI_COMM_WORLD_SIZE" in os.environ):
        size_vars.append("OMPI_COMM_WORLD_SIZE")
        rank_vars.append("OMPI_COMM_WORLD_RANK")
        lsize_vars.append("OMPI_COMM_WORLD_LOCAL_SIZE")
        lrank_vars.append("OMPI_COMM_WORLD_LOCAL_RANK")
    if "PMI_RANK" in os.environ and "PMI_SIZE" in os.environ:
        size_vars.append("PMI_SIZE")
        rank_vars.append("PMI_RANK")
        lsize_vars.append("MPI_LOCALNRANKS")
        lrank_vars.append("MPI_LOCALRANKID")
    if ("SLURM_PROCID" in os.environ
            and "SLURM_STEP_NUM_TASKS" in os.environ):
        size_vars.append("SLURM_STEP_NUM_TASKS")
        rank_vars.append("SLURM_PROCID")
        lsize_vars.append("SLURM_STEP_TASKS_PER_NODE")
        lrank_vars.append("SLURM_LOCALID")
    size = _first_int_env(size_vars, 1)
    rank = _first_int_env(rank_vars, 0)
    local_rank = _first_int_env(lrank_vars, 0)
    local_size = _first_int_env(lsize_vars, 1 if size == 1 else size)
    # Derive the cross (inter-node) coordinates when the launcher didn't
    # provide them: with homogeneous nodes rank = cross_rank*local_size +
    # local_rank.
    if ("HOROVOD_CROSS_RANK" in os.environ
            or "HOROVOD_CROSS_SIZE" in os.environ):
        cross_rank = _int_env("HOROVOD_CROSS_RANK", 0)
        cross_size = _int_env("HOROVOD_CROSS_SIZE", 1)
    elif local_size > 0 and size % local_size == 0:
        cross_rank = rank // local_size
        cross_size = size // local_size
    else:
        cross_rank, cross_size = 0, 1
    return Topology(
        rank=rank, size=size, local_rank=local_rank,
        local_size=local_size, cross_rank=cross_rank,
        cross_size=cross_size,
    )

# ---- end of the verbatim copy ----


def _default_init_method(topo: Topology) -> str:
    addr = os.environ.get("HOROVOD_CONTROLLER_ADDR")
    port = os.environ.get("HOROVOD_CONTROLLER_PORT")
    if not addr or not port:
        raise RuntimeError(
            "world size %d needs a rendezvous: pass init(init_method=...) "
            "or set HOROVOD_CONTROLLER_ADDR/HOROVOD_CONTROLLER_PORT "
            "(hvdrun sets both)" % topo.size)
    return "tcp://%s:%s" % (addr, port)


def init(device: str = "cuda", init_method: Optional[str] = None) -> None:
    """Initialize horovod_tpu_torch.

    Reads the launcher environment and builds the default
    ``torch.distributed`` process group: NCCL when ``device`` is
    ``"cuda"`` (this process takes card ``local_rank``), gloo when it is
    ``"cpu"``. At size 1 the group rendezvous in-process; above it,
    through ``init_method`` or ``tcp://HOROVOD_CONTROLLER_ADDR:PORT``.
    The CPU is used only when asked for: ``device="cuda"`` without a card
    raises.
    """
    with _ctx.lock:
        if _ctx.initialized:
            return
        topo = _topology_from_env()
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init(device='cuda') but no CUDA device is visible; "
                    "pass device='cpu' to run on the CPU")
            dev = torch.device("cuda", topo.local_rank)
            torch.cuda.set_device(dev)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError("device must be 'cuda' or 'cpu', got %r"
                             % (device,))
        if topo.size == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            dist.init_process_group(
                backend, init_method=init_method or
                _default_init_method(topo),
                rank=topo.rank, world_size=topo.size)
        _ctx.topology = topo
        _ctx.initialized = True


def shutdown() -> None:
    with _ctx.lock:
        if not _ctx.initialized:
            return
        dist.destroy_process_group()
        _ctx.initialized = False


def is_initialized() -> bool:
    return _ctx.initialized


def _require():
    if not _ctx.initialized:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; call "
            "horovod_tpu_torch.init().")
    return _ctx.topology


def rank() -> int:
    return _require().rank


def size() -> int:
    return _require().size


def local_rank() -> int:
    return _require().local_rank


def local_size() -> int:
    return _require().local_size


def cross_rank() -> int:
    return _require().cross_rank


def cross_size() -> int:
    return _require().cross_size
