"""Process topology and lifecycle for horovod_tpu_torch.

Port of ``horovod_tpu/common/basics.py``. The launcher environment contract
is the same (``HOROVOD_RANK``/``SIZE``/``LOCAL_*``/``CROSS_*``, with the
OpenMPI/PMI/Slurm fallbacks), read by a verbatim copy of the reference's
``_topology_from_env``, so one environment gives one topology in both
packages. The data plane is a ``torch.distributed`` process group: NCCL on
the card, gloo on the CPU. ``init`` builds it at every world size, size 1
included, so the gradient allreduce always runs through the collective
backend it would use at scale.

``init`` also starts the native coordination core (``core/session.py``),
at every world size too: the JAX package starts it only above size 1, but
at size 1 on one card nothing would otherwise reach the device plane, and
the results are the same either way. On the card the core gets a device
plane (``core/device_plane.py``).

As in the JAX package (``horovod_tpu/common/basics.py:213-259``), ``init``
also starts the observability plane: ``HOROVOD_TIMELINE`` (``{rank}``
becomes the rank) opens the Python timeline and the core's beside it
(``HOROVOD_TIMELINE_MARK_CYCLES`` marks the core's cycles); the health
reporter keeps the stall gauges fresh; the flight recorder dumps both
rings on SIGTERM (main thread only); and ``HVD_METRICS_PORT`` serves
``/metrics`` on base + ``local_rank`` (0: any free port). A server started
before an elastic reset is bound again on the same port after it.
"""

from __future__ import annotations

import logging
import os
import socket
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
    # The native core's session (horovod_tpu_torch.core.session).
    core: Optional[object] = None
    # The world's failure watch (common/failure.py).
    watch: Optional[object] = None
    # The device the last init resolved ("cuda:N" or "cpu").
    device: str = "cuda"
    # Bumped by every init: world-scoped memos compare it.
    generation: int = 0
    # Whether this process has been a rank of a multi-rank world.
    shared_high_water: bool = False
    # The Python timeline (utils/timeline.py) while one is open.
    timeline: Optional[object] = None
    # The /metrics server (runner/http_server.KVStoreServer).
    metrics_server: Optional[object] = None
    # The port to serve on again after an elastic shutdown/init cycle.
    metrics_restart_port: Optional[int] = None


_ctx = _Context()
logger = logging.getLogger("horovod_tpu_torch")


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


def _negotiated_port() -> bool:
    """Whether the elastic driver left the rendezvous port to rank 0: it
    publishes ``controller_port: 0`` (``horovod_tpu/runner/
    elastic_run.py:305-313``), since a port it probes free on the
    launcher's host says nothing of rank 0's."""
    return (os.environ.get("HOROVOD_CONTROLLER_PORT", "0") in ("", "0")
            and bool(os.environ.get("HOROVOD_ELASTIC"))
            and bool(os.environ.get("HOROVOD_RENDEZVOUS_ADDR")))


def _default_init_method(topo: Topology) -> str:
    addr = os.environ.get("HOROVOD_CONTROLLER_ADDR")
    port = os.environ.get("HOROVOD_CONTROLLER_PORT")
    if not addr or not port:
        raise RuntimeError(
            "world size %d needs a rendezvous: pass init(init_method=...) "
            "or set HOROVOD_CONTROLLER_ADDR/HOROVOD_CONTROLLER_PORT "
            "(hvdrun sets both)" % topo.size)
    return "tcp://%s:%s" % (addr, port)


def _reserve_port() -> socket.socket:
    """A socket bound to a free port on every interface, never listening,
    with SO_REUSEADDR: while it is open no automatic bind takes the port
    (the core's own listener binds port 0 just before its controller
    port, and a port freed by a probe can come straight back to it), and
    the core, which sets SO_REUSEADDR too, can still bind and listen
    there."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("0.0.0.0", 0))
    return s


def _core_address(topo: Topology, reservation=None):
    """Where rank 0's core listens. At size 1 nowhere: the core opens no
    socket then (``core/src/comm.cc``, ``TcpComm::Init``), so no port is
    taken and concurrent size-1 processes cannot race for one. Above it
    HOROVOD_CONTROLLER_PORT is the process group's rendezvous, so rank 0
    hands the others the port of its ``reservation`` (``_reserve_port``)
    through the group's store."""
    addr = os.environ.get("HOROVOD_CONTROLLER_ADDR", "127.0.0.1")
    if topo.size == 1:
        return addr, 0
    store = dist.distributed_c10d._get_default_store()
    if topo.rank == 0:
        store.set("horovod_tpu_torch.core_port",
                  str(reservation.getsockname()[1]))
    return addr, int(store.get("horovod_tpu_torch.core_port"))


def _coordinates(topo: Topology, dev: torch.device):
    """Every rank's ``(local_rank, cross_rank)``, by global rank: one
    all_gather on the default group above size 1."""
    mine = torch.tensor([topo.local_rank, topo.cross_rank],
                        dtype=torch.int64, device=dev)
    if topo.size == 1:
        return [tuple(mine.tolist())]
    every = [torch.empty_like(mine) for _ in range(topo.size)]
    dist.all_gather(every, mine)
    return [tuple(t.tolist()) for t in every]


def default_device() -> str:
    """The device of ``init()`` called without one: ``"cpu"`` when the
    launcher set ``HOROVOD_WORKER_PLATFORM=cpu`` (``--platform cpu``; the
    reference reads the same variable, ``horovod_tpu/__init__.py:25``),
    else ``"cuda"``."""
    return ("cpu" if os.environ.get("HOROVOD_WORKER_PLATFORM") == "cpu"
            else "cuda")


def init(process_sets=None, device: Optional[str] = None,
         init_method: Optional[str] = None) -> None:
    """Initialize horovod_tpu_torch.

    Reads the launcher environment and builds the default
    ``torch.distributed`` process group: NCCL when ``device`` is
    ``"cuda"`` (this process takes card ``local_rank``, or the card that
    ``"cuda:N"`` names), gloo when it is ``"cpu"``. With no ``device``
    it is ``default_device()``: the card, unless the launcher's
    ``--platform cpu`` asked for the CPU; an explicit ``device`` always
    wins. At size 1 the group
    rendezvous in-process; above it, through ``init_method`` or
    ``tcp://HOROVOD_CONTROLLER_ADDR:PORT``. The CPU is used only when
    asked for: ``device="cuda"`` without a card raises. It builds the
    groups of the hierarchical collectives where the ranks' layout has
    two levels (``parallel/hierarchical.py``), then starts the native
    core, with a device plane on the card. ``process_sets`` (the
    reference's argument: ``ProcessSet``s or rank lists) are registered
    once the world is up, in order, as ``add_process_set`` would. Above
    size 1 every rank then takes rank 0's flash tile cache
    (``ops/block_tuner.sync_cache_across_world``), at every world
    formation, elastic reinits included.
    """
    with _ctx.lock:
        if _ctx.initialized:
            return
        topo = _topology_from_env()
        dev = torch.device(device or default_device())
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init(device='cuda') but no CUDA device is visible; "
                    "pass device='cpu' to run on the CPU")
            dev = torch.device("cuda", topo.local_rank if dev.index is None
                               else dev.index)
            if dev.index >= torch.cuda.device_count():
                raise RuntimeError(
                    "init() takes %s (local rank %d), but this host shows "
                    "%d CUDA card(s): one card a rank, or pass "
                    "device='cpu'" % (dev, topo.local_rank,
                                      torch.cuda.device_count()))
            torch.cuda.set_device(dev)
            backend = "nccl"
        elif dev.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError("device must be 'cuda' or 'cpu', got %r"
                             % (device,))
        if backend == "nccl":
            # The failure watch aborts the groups itself; NCCL's watchdog
            # must not tear the process down as well (common/failure.py).
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        if topo.size == 1 and init_method is None:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            if init_method is None and _negotiated_port():
                # Rank 0 binds the port on its own host and reports it
                # through the rendezvous KV (as the JAX init does,
                # horovod_tpu/common/basics.py:189-207); the process
                # group's TCP store listens there.
                from horovod_tpu_torch.elastic.worker import (
                    negotiate_controller_port,
                )

                negotiate_controller_port(topo.rank)
            dist.init_process_group(
                backend, init_method=init_method or
                _default_init_method(topo),
                rank=topo.rank, world_size=topo.size)
        _ctx.topology = topo
        _ctx.device = str(dev)
        from horovod_tpu_torch.core.session import CoreSession
        from horovod_tpu_torch.ops import eager
        from horovod_tpu_torch.parallel import hierarchical

        hierarchical.build(_coordinates(topo, dev), topo.rank)

        eager._reset_name_counters()
        reservation = (_reserve_port() if topo.size > 1 and topo.rank == 0
                       else None)
        try:
            _ctx.core = CoreSession.start(
                topo, *_core_address(topo, reservation))
        finally:
            if reservation is not None:
                reservation.close()
        if dev.type == "cuda":
            from horovod_tpu_torch.core import device_plane

            device_plane.attach(_ctx.core, dev, topo.size)
        from horovod_tpu_torch.common.failure import Watch

        _ctx.watch = Watch(_ctx.core)
        _ctx.generation += 1
        if topo.size > 1:
            _ctx.shared_high_water = True
        _ctx.initialized = True
        if process_sets:
            from horovod_tpu_torch.common import process_sets as ps_mod

            for ps in process_sets:
                ps_mod.add_process_set(ps)
        _start_observability()
    # Outside the lock, as in the reference (basics.py:266-288): the sync
    # is a broadcast on the live world, which every rank reaches here. A
    # peer lost mid-broadcast leaves this world without a synced view (the
    # defaults, on every rank) instead of failing the init of survivors.
    if _ctx.topology.size > 1:
        from horovod_tpu_torch.ops import block_tuner

        try:
            block_tuner.sync_cache_across_world()
        except Exception as e:  # noqa: BLE001 — see above
            logger.warning("flash tuner cache sync failed (%s); continuing "
                           "without a synced view for this world", e)


def _start_observability() -> None:
    """The rest of ``init`` (``horovod_tpu/common/basics.py:213-259``):
    the timelines of HOROVOD_TIMELINE, the health reporter, the flight
    recorder's SIGTERM dump and the metrics server. The caller holds the
    context's lock."""
    from horovod_tpu_torch.utils import flightrec
    from horovod_tpu_torch.utils import metrics

    path = os.environ.get("HOROVOD_TIMELINE")
    if path:
        mark = os.environ.get("HOROVOD_TIMELINE_MARK_CYCLES",
                              "") not in ("", "0")
        start_timeline(path.replace("{rank}", str(_ctx.topology.rank)),
                       mark_cycles=mark)
    metrics.start_health_reporter()
    flightrec.install_signal_handler()
    port = os.environ.get("HVD_METRICS_PORT")
    if port not in (None, ""):
        _try_start_metrics_server(port, "HVD_METRICS_PORT=%s" % port,
                                  offset_local_rank=True)
        _ctx.metrics_restart_port = None
    elif _ctx.metrics_restart_port is not None:
        # A server started before an elastic reset: the same port again.
        # A failed bind keeps it remembered for the next reset.
        if _try_start_metrics_server(
                _ctx.metrics_restart_port,
                "metrics server restart after reset") is not None:
            _ctx.metrics_restart_port = None


def shutdown() -> None:
    """Tear the world down; ``init`` may build another in this process
    (the elastic survivor's path). After a peer died it returns without
    waiting on the dead: the core fails its barrier at once, and the
    process groups are aborted, not destroyed."""
    with _ctx.lock:
        if not _ctx.initialized:
            return
        from horovod_tpu_torch.common import process_sets
        from horovod_tpu_torch.ops import eager
        from horovod_tpu_torch.parallel import hierarchical

        # First, so that a peer's clean shutdown is not read as a failure.
        _ctx.watch.stop()
        failed = _ctx.watch.failed is not None or not _ctx.core.running()
        if not failed:
            try:
                # So that no rank tears the core's mesh down while a peer
                # is still mid-cycle; peers may already be gone.
                eager._backend().barrier(process_sets.global_process_set,
                                         "__shutdown_barrier__")
            except Exception:  # noqa: BLE001 — close anyway
                failed = True
        if _ctx.timeline is not None:
            try:
                _ctx.timeline.close()
            finally:
                _ctx.timeline = None
        _ctx.core.shutdown()
        _ctx.core = None
        _ctx.watch = None
        # Keep the bound port, so that the next init serves on it again
        # (an explicit stop_metrics_server means stay stopped).
        restart = (_ctx.metrics_server.port
                   if _ctx.metrics_server is not None else None)
        stop_metrics_server()
        _ctx.metrics_restart_port = restart
        from horovod_tpu_torch.utils import metrics

        metrics.stop_health_reporter()
        from horovod_tpu_torch.parallel import mesh

        # A reinit must not keep a dead world's mesh, nor its groups.
        mesh.reset_global_mesh()
        process_sets._reset()
        hierarchical.reset()
        if failed:
            # A destroy would wait on collectives a dead peer never ends.
            dist.distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
        _ctx.initialized = False


def is_initialized() -> bool:
    return _ctx.initialized


def init_device() -> str:
    """The device the last ``init`` resolved ("cuda:N" or "cpu"): an
    elastic reinit keeps this process on it."""
    return _ctx.device


def watch():
    """The world's failure watch (``common/failure.py``), None before
    ``init``."""
    return _ctx.watch


def init_generation() -> int:
    """Monotone per-process init epoch, bumped by every init (reference:
    ``horovod_tpu/common/basics.py:339``). World-scoped caches compare it
    to tell a memo of this world from one of an earlier world."""
    return _ctx.generation


def is_shared_world() -> bool:
    """True when this process is one rank of an initialized multi-rank
    world (reference: ``horovod_tpu/common/basics.py:347``). Between an
    elastic reset's shutdown and its reinit it answers True if the
    process has ever been part of a multi-rank world, so that no thread
    slips a per-rank decision through mid-teardown; an initialized size-1
    world after a shrink answers False."""
    if _ctx.initialized:
        return _ctx.topology.size > 1
    return _ctx.shared_high_water


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


def is_homogeneous() -> bool:
    """True when every host runs the same number of processes."""
    t = _require()
    return t.size == t.local_size * t.cross_size


def core_session():
    """The native core's ``CoreSession`` (None before ``init``)."""
    return _ctx.core


def timeline():
    """The open Python timeline (``utils/timeline.py``), or None."""
    return _ctx.timeline


def start_timeline(file_path: str, mark_cycles: bool = False) -> None:
    """Write Chrome-tracing timelines (reference: horovod/common/
    operations.cc:1011-1041): the eager ops' spans to ``file_path``, and
    the native core's background loop (negotiation and each response's
    execution) to ``file_path + ".core.json"``. A timeline already open
    is closed first. Raises when either file cannot be opened."""
    _require()
    from horovod_tpu_torch.utils.timeline import Timeline

    with _ctx.lock:
        if _ctx.timeline is not None:
            _ctx.core.attach_timeline(None)
            _ctx.timeline.close()
            _ctx.timeline = None
        _ctx.core.stop_core_timeline()
        core_path = file_path + ".core.json"
        if not _ctx.core.start_core_timeline(core_path, mark_cycles):
            raise RuntimeError("could not start the core timeline at %s"
                               % core_path)
        _ctx.timeline = Timeline(file_path, mark_cycles=mark_cycles)
        _ctx.core.attach_timeline(_ctx.timeline)


def stop_timeline() -> None:
    """Close both timelines (``start_timeline``); the Python one first
    writes the card spans still waiting for their done events."""
    _require()
    with _ctx.lock:
        _ctx.core.attach_timeline(None)
        if _ctx.timeline is not None:
            _ctx.timeline.close()
            _ctx.timeline = None
        _ctx.core.stop_core_timeline()


def metrics_snapshot():
    """JSON-able snapshot of the process-wide metrics registry
    (docs/metrics.md), collectors run first, plus ``hvd_recent_failures``:
    the last abort and wedge reasons the flight recorder kept."""
    from horovod_tpu_torch.utils import flightrec, metrics

    snap = metrics.snapshot()
    snap["hvd_recent_failures"] = {
        "type": "info",
        "help": "Last abort/wedge/cull reasons recorded by the flight "
                "recorder (newest last; docs/flightrec.md).",
        "values": flightrec.recent_failures(),
    }
    return snap


def dump_flight_record(directory: Optional[str] = None) -> dict:
    """Dump both flight-recorder rings (the Python planes' and the native
    core's) as JSONL into ``directory`` (default ``HVD_FLIGHTREC_DIR`` or
    the cwd); returns ``{"python": path, "native": path}`` for the files
    written. ``python -m tools.trace <dir>`` merges per-rank dumps."""
    from horovod_tpu_torch.utils import flightrec

    return flightrec.dump(directory, reason="hvd.dump_flight_record")


def start_metrics_server(port: int = 0) -> int:
    """Serve ``GET /metrics`` (Prometheus text 0.0.4), ``/metrics.json``
    and ``/debug/flightrec`` (an on-demand dump of both rings) from this
    process; returns the bound port (0 picks a free one). A second call
    returns the running server's port. The server refuses writes."""
    from horovod_tpu_torch.runner.http_server import KVStoreServer

    with _ctx.lock:
        if _ctx.metrics_server is not None:
            return _ctx.metrics_server.port
        server = KVStoreServer(port=port, metrics_only=True)
        server.register_get_route("/debug/flightrec", _flightrec_route)
        server.start()
        _ctx.metrics_server = server
        return server.port


def _flightrec_route():
    from horovod_tpu_torch.runner.http_server import json_route_result
    from horovod_tpu_torch.utils import flightrec

    dumped = flightrec.dump(reason="/debug/flightrec")
    status = 200 if (dumped or not flightrec.enabled()) else 500
    return json_route_result(status, {
        "enabled": flightrec.enabled(),
        "dumped": dumped,
        "recent_failures": flightrec.recent_failures(),
    })


def stop_metrics_server() -> None:
    """Stop the server of ``start_metrics_server`` (idempotent); an
    explicit stop also cancels its restart after an elastic reset."""
    with _ctx.lock:
        server, _ctx.metrics_server = _ctx.metrics_server, None
        _ctx.metrics_restart_port = None
    if server is not None:
        try:
            server.stop()
        except Exception as e:  # noqa: BLE001 — teardown goes on
            logger.debug("metrics server stop failed: %s", e)


def _try_start_metrics_server(base_port, source: str,
                              offset_local_rank: bool = False):
    """Start the server from a knob: a malformed value or an unbindable
    port logs a warning and training goes on, as in the reference. With
    ``offset_local_rank`` a nonzero base is offset by ``local_rank``.
    Returns the bound port or None."""
    try:
        port = int(base_port)
        if port != 0 and offset_local_rank and _ctx.initialized:
            port += _ctx.topology.local_rank
        return start_metrics_server(port)
    except (ValueError, OverflowError, OSError) as e:
        logger.warning("%s: could not start the metrics server (%s); "
                       "continuing without one", source, e)
        return None


# --- build and capability queries (reference: horovod/common/basics.py) ---

def check_extension(ext_base_name: str = "horovod_tpu_torch",
                    *compat_args) -> None:
    """Raise ImportError when the native core cannot be used (reference:
    horovod/common/util.py check_extension). The core is built at first
    use, so this builds it if it is missing; only a core that does not
    build raises. The reference's extra ``ext_env_var``/``pkg_path``
    arguments are accepted and ignored."""
    del compat_args
    try:
        from horovod_tpu_torch.core.build import library_path

        library_path()
    except Exception as e:  # noqa: BLE001 — the build's error, as ImportError
        raise ImportError(
            "%s native core unavailable (build failed: %s); "
            "multi-process collectives cannot run" % (ext_base_name, e)
        ) from e


def mpi_threads_supported() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_built() -> bool:
    return False


def gloo_enabled() -> bool:
    return _ctx.core is not None


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> int:
    return int(dist.is_nccl_available())


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def ddl_built() -> bool:
    return False


def ccl_built() -> bool:
    return False


def rocm_built() -> bool:
    return False


def tpu_built() -> bool:
    return False
