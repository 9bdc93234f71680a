"""The port's fault-injection runs: their launcher and one rank's worker.

``run_job(mode, size, env, device)`` starts ``size`` ranks of this file as
``python torch_port_fault_worker.py MODE DEVICE``, which share the
launcher environment (HOROVOD_RANK, SIZE, CONTROLLER_ADDR,
CONTROLLER_PORT) and, where a fault is armed, the injector's HVD_FAULT_*
variables (``common/fault_injection.fault_env``). DEVICE ``cpu`` sends
host tensors through the core's TCP ring; ``cuda`` puts each rank on the
card of its local rank, where the device plane moves the tensors over
NCCL and the core only negotiates. Modes:

* ``typed``: allreduce until a collective fails. The fault (``drop``,
  ``stall`` or ``half_close``, armed on the victim) must surface as
  ``HorovodAbortedError`` on host tensors, as ``HorovodInternalError`` (or
  its subclass) on card tensors, within ``FAULT_WINDOW_SEC`` of the
  loop's start. A ``stall`` victim never returns; ``run_job`` kills it.
* ``heal``: eight allreduces of 16 MB of seeded data. A ``reset`` or
  ``reconnect_storm`` must heal in place: every allreduce completes and
  no abort is counted; the results' digest is printed, for the caller to
  hold to the fault-free run's.
* ``c8``: a broadcast whose root is outside its set (the global set with
  root ``size``; above size 1 also the set [0] with root 1) raises on the
  members, and the same core then serves an allreduce and a broadcast.
* ``ingraph``: the synchronous collectives over the process group
  (``allreduce_ingraph``, and ``allgather_ingraph`` of a varying row count,
  whose shapes the host reads) until one fails. The fault must surface as
  ``HorovodInternalError``. The victim's watch polls every millisecond
  and the survivors' every ``SLOW_POLL_SEC``, so that the victim always
  leaves first and the survivors enter a collective it never joins. The
  victim then keeps its process open for ``HOLD_SEC`` before it shuts
  down, as a rank that left for the next world does. On the CPU no rank's watch aborts its gloo groups: gloo's
  abort does not always end a pending wait (1 drill in 15 saw it hang,
  ROADMAP C10), and where it does, it closes the survivor's sockets and
  so ends every peer's wait, which would hide the case. A survivor must
  then raise from its own watch, not when the peer closes. On the card
  every watch aborts its communicators as usual, and a survivor sits in
  the host read of a collective the victim left (C11): the read must not
  block the watch's NCCL abort. Every rank dumps its stacks into its log
  if it is still running ``RUN_TIMEOUT - 10`` seconds after its start.

Each rank's last line is ``RESULT {json}``; its exit code is 0 when it
saw what its mode expects.

``drive_elastic(device, size, log_dir)`` runs the elastic drill: ``size``
ranks train a small model through the named ``DistributedOptimizer``
under ``elastic.run`` with ``HVD_TUNE=1``, this file acting as the elastic
driver (chip_smoke.py's rendezvous KV store). ``drop`` is armed on rank 1
(``fired_at`` reads from its log when it fired); the survivors raise
``HorovodInternalError``, restore (the drill disarms the injector there,
so the next world is clean), and the driver publishes the world without
rank 1. Each rank logs JSON lines: its steps (with the bytes the device
plane counted so far), its restore, each ``on_world_change`` the wrapper
runs, and at the end the live-unsafe knobs' environment and its tuner's
state. A rank still running at ``drive_elastic``'s timeout dumps its stacks.
"""

import datetime
import hashlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
DEADLINE = 3.0
# The survivors' detection window: twice the progress deadline, plus the
# margin of a loaded machine.
WINDOW = 2 * DEADLINE + 4.0
RUN_TIMEOUT = 60.0
# How long the ``ingraph`` victim keeps its process open after it raised,
# and how often the survivors' watches look at their cores there.
HOLD_SEC = 15.0
SLOW_POLL_SEC = 0.5
BIG = 4 << 20  # 16 MB of fp32: rings are mid-transfer when a fault lands
# The drill trains at full size until the fault has reset the world (at
# most ELASTIC_MAX_STEPS steps), then ELASTIC_STEPS steps in the new one.
ELASTIC_STEPS = 20
ELASTIC_MAX_STEPS = 600
# The core's log line of the moment the injector fires (its timestamp is
# the local wall clock, HOROVOD_LOG_TIMESTAMP=1).
_FIRED = re.compile(r"^\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\.\d{6}) hvd-core "
                    r"WARN rank=\d+\] fault injector: (dropping|half-closed|"
                    r"stalling|hard-reset)", re.M)


# --- launcher ----------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_env(rank, size, port, extra):
    env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
               HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(size),
               HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
               HOROVOD_CONTROLLER_ADDR="127.0.0.1",
               HOROVOD_CONTROLLER_PORT=str(port), HOROVOD_CYCLE_TIME="1.0",
               HOROVOD_COMM_TIMEOUT_SEC=str(DEADLINE),
               FAULT_WINDOW_SEC=str(3 * WINDOW), OMP_NUM_THREADS="1",
               HOROVOD_LOG_TIMESTAMP="1",
               PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(extra or {})
    return env


def run_job(mode, size, extra_env=None, device="cpu", hangs=(),
            timeout=RUN_TIMEOUT):
    """Run ``mode`` of the worker as ``size`` ranks; returns {rank:
    (exit code, the RESULT record or None, output)}. Ranks in ``hangs``
    may be left wedged by design: they are collected after the others
    and killed."""
    from torch_port_runs import built_cores

    built_cores(jax=False)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, device], cwd=ROOT,
        env=_rank_env(rank, size, port, extra_env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(size)]
    out = {}
    end = time.monotonic() + timeout
    try:
        for rank, p in enumerate(procs):
            if rank in hangs:
                continue
            text, _ = p.communicate(timeout=max(1.0, end - time.monotonic()))
            out[rank] = (p.returncode, _record(text), text)
    finally:
        for rank, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
            if rank not in out:
                try:
                    text, _ = p.communicate(timeout=30)
                except subprocess.TimeoutExpired:
                    p.send_signal(signal.SIGKILL)
                    text = ""
                out[rank] = (p.returncode, _record(text or ""), text or "")
    return out


def _record(text):
    for line in reversed(text.splitlines()):
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    return None


def fired_at(text):
    """The wall time at which the injector fired, from the victim's log;
    None when it did not fire."""
    m = _FIRED.search(text)
    if m is None:
        return None
    return datetime.datetime.strptime(
        m.group(1), "%Y-%m-%d %H:%M:%S.%f").timestamp()


def elastic_records(log_dir):
    out = []
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("slot_") and name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def drive_elastic(device, size, log_dir, timeout=300):
    """The elastic drill (module docstring); returns (exit codes by slot,
    log records, output files by slot)."""
    sys.path.insert(0, ROOT)
    from chip_smoke import KVServer
    from horovod_tpu_torch.common.fault_injection import fault_env
    from torch_port_runs import built_cores

    built_cores(jax=False)
    kv = KVServer()
    slots = ["localhost:%d" % i for i in range(size)]
    procs, outputs = {}, {}
    try:
        kv.publish(0, slots)
        for rank, slot in enumerate(slots):
            env = _rank_env(rank, size, 0, dict(
                # The core sends a frame a cycle or more from its init on
                # (about 1800 a second at np=3 on the CPU, at the 1 ms
                # cycle): the fault lands some 10 s in, after the first
                # steps. The tuner searches the other knobs: a longer
                # cycle would put it off by as much.
                fault_env(1, "drop", after_frames=20000),
                HVD_TUNE_FREEZE="cycle_time_ms",
                HOROVOD_RENDEZVOUS_ADDR="127.0.0.1",
                HOROVOD_RENDEZVOUS_PORT=str(kv.port),
                HOROVOD_SLOT_KEY=slot, HOROVOD_RENDEZVOUS_VERSION="0",
                HOROVOD_ELASTIC="1", HVD_HEARTBEAT_SEC="1",
                HVD_WIRE_RECONNECT_SEC="2", HVD_TUNE="1",
                HVD_TUNE_WINDOW_SEC="0.4", HVD_TUNE_JOURNAL_DIR=log_dir))
            path = os.path.join(log_dir, "out_%d.txt" % rank)
            outputs[slot] = path
            with open(path, "w") as out:
                procs[slot] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "elastic",
                     device, log_dir], cwd=ROOT, env=env, stdout=out,
                    stderr=subprocess.STDOUT)
        deadline = time.monotonic() + timeout
        while not any(r.get("event") == "restore" and r["rank"] != 1
                      for r in elastic_records(log_dir)):
            if time.monotonic() > deadline or all(
                    p.poll() is not None for p in procs.values()):
                raise TimeoutError("no survivor restored")
            time.sleep(0.05)
        kv.publish(1, [s for s in slots if s != slots[1]])
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        live = [p for p in procs.values() if p.poll() is None]
        for p in live:
            p.send_signal(signal.SIGUSR1)  # its stacks, into its log
        if live:
            time.sleep(1)
        for p in live:
            p.kill()
            p.wait()
        kv.close()
    codes = {slot: p.returncode for slot, p in procs.items()}
    return codes, elastic_records(log_dir), outputs


# --- worker ------------------------------------------------------------------


def _result(hvd, code, **fields):
    from horovod_tpu_torch.common import basics

    core = basics.core_session()
    if core is not None:
        c = core.counters()
        fields.update({k: c[k] for k in ("comm_timeouts", "aborts",
                                         "reconnects",
                                         "reconnect_failures")})
    fields.update(rank=hvd.rank(), size=hvd.size(), code=code)
    print("RESULT " + json.dumps(fields), flush=True)
    return code


def typed(hvd, device):
    from horovod_tpu_torch.common.exceptions import (
        HorovodAbortedError,
        HorovodInternalError,
    )

    expected = HorovodAbortedError if device == "cpu" else \
        HorovodInternalError
    window = float(os.environ.get("FAULT_WINDOW_SEC", "30"))
    x = torch.ones(BIG, device=device)
    t0 = time.monotonic()
    i = 0
    try:
        while time.monotonic() - t0 < window:
            hvd.allreduce(x, name="doom.%d" % i, op=hvd.Sum)
            i += 1
    except Exception as e:  # noqa: BLE001 — the type is the contract
        dt = time.monotonic() - t0
        ok = isinstance(e, expected)
        return _result(hvd, 0 if ok else 2, error=type(e).__name__,
                       message=str(e)[:300], seconds=dt, completed=i,
                       raised_at=time.time())
    return _result(hvd, 3, error=None, seconds=time.monotonic() - t0,
                   completed=i)


def ingraph(hvd, device):
    import faulthandler

    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    from horovod_tpu_torch.common import failure

    faulthandler.dump_traceback_later(RUN_TIMEOUT - 10)
    failure.POLL_SEC = 0.001 if hvd.rank() == 1 else SLOW_POLL_SEC
    if device == "cpu":
        failure.abort_groups = lambda: None
    window = float(os.environ.get("FAULT_WINDOW_SEC", "30"))
    x = torch.ones(1 << 18, device=device)
    t0 = time.monotonic()
    i, op = 0, None
    try:
        while time.monotonic() - t0 < window:
            op = "allreduce"
            hvd.allreduce_ingraph(x, hvd.Sum)
            op = "allgather"
            hvd.allgather_ingraph(x[:1 + i % 7])
            i += 1
    except Exception as e:  # noqa: BLE001 — the type is the contract
        raised_at = time.time()
        if hvd.rank() == 1:
            time.sleep(HOLD_SEC)
        ok = isinstance(e, HorovodInternalError)
        return _result(hvd, 0 if ok else 2, error=type(e).__name__, op=op,
                       message=str(e)[:300], completed=i,
                       raised_at=raised_at)
    return _result(hvd, 3, error=None, completed=i)


def heal(hvd, device):
    from horovod_tpu_torch.common import basics

    digest = hashlib.sha256()
    n = hvd.size()
    for i in range(8):
        gen = torch.Generator().manual_seed(1000 * i + hvd.rank())
        x = torch.randn(BIG, generator=gen).to(device)
        out = hvd.allreduce(x, name="doom.%d" % i, op=hvd.Sum)
        digest.update(out.cpu().numpy().tobytes())
        if i == 0 and n > 1 and torch.equal(out, x):
            return _result(hvd, 4, error="the allreduce moved nothing")
    c = basics.core_session().counters()
    ok = c["aborts"] == 0 and c["reconnect_failures"] == 0
    return _result(hvd, 0 if ok else 5, digest=digest.hexdigest())


def c8(hvd, device):
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    n = hvd.size()
    x = torch.arange(4, dtype=torch.float32, device=device)
    raised = {}
    if n > 1:
        ps = hvd.add_process_set([0])
        if hvd.rank() == 0:
            try:
                hvd.broadcast(x, 1, name="c8.set", process_set=ps)
                raised["set"] = None
            except HorovodInternalError as e:
                raised["set"] = str(e)
    t0 = time.monotonic()
    try:
        hvd.broadcast(x, n, name="c8.global")
        raised["global"] = None
    except HorovodInternalError as e:
        raised["global"] = str(e)
    seconds = time.monotonic() - t0
    total = hvd.allreduce(x, name="c8.next", op=hvd.Sum)
    root = hvd.broadcast(x + hvd.rank(), 0, name="c8.ok")
    ok = (all(v is not None and "root" in v for v in raised.values())
          and torch.equal(total, x * n) and torch.equal(root, x))
    return _result(hvd, 0 if ok else 6, raised=raised, seconds=seconds)


def elastic(device, log_dir):
    import faulthandler

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import fault_injection
    from horovod_tpu_torch.common.knobs import TUNABLE
    from horovod_tpu_torch.utils import metrics
    from horovod_tpu_torch.utils import online_tuner

    # drive_elastic asks a rank still running at its timeout for its stacks.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    slot = os.environ["HOROVOD_SLOT_KEY"]
    path = os.path.join(log_dir, "slot_%s.log" % slot.replace(":", "_"))

    def log(**record):
        record.update(slot=slot, pid=os.getpid(), t=time.time())
        with open(path, "a") as f:  # analysis: allow-append — a test log
            f.write(json.dumps(record) + "\n")

    real_world_change = online_tuner.on_world_change

    def world_change():
        log(event="world_change", rank=hvd.rank(), size=hvd.size())
        real_world_change()

    online_tuner.on_world_change = world_change
    # The bytes the device plane adds to the wire families (card tensors).
    from horovod_tpu_torch.core import device_plane

    plane_tx = [0.0]
    count_wire = device_plane._count_wire

    def counted(tx, rx=None):
        plane_tx[0] += tx
        count_wire(tx, rx)

    device_plane._count_wire = counted
    hvd.init(device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(64, 256), torch.nn.ReLU(),
        torch.nn.Linear(256, 10)).to(device)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=device) * 0.05)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01),
        named_parameters=model.named_parameters())

    class State(hvd.elastic.TorchState):
        def restore(self):
            # The drill is one-shot: the next world starts disarmed.
            fault_injection.clear_fault_env()
            log(event="restore", rank=hvd.rank())
            super().restore()

    state = State(model, opt, step=0)
    full = hvd.size()
    after = [0]  # steps taken in the world after the reset

    @hvd.elastic.run
    def train(state):
        while (hvd.size() == full and state.step < ELASTIC_MAX_STEPS) or (
                hvd.size() != full and after[0] < ELASTIC_STEPS):
            g = torch.Generator(device=device).manual_seed(
                1000 * state.step + hvd.rank())
            x = torch.randn(32, 64, generator=g, device=device)
            y = torch.randint(0, 10, (32,), generator=g, device=device)
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
            state.step += 1
            after[0] += hvd.size() != full
            log(rank=hvd.rank(), size=hvd.size(), step=state.step,
                plane_tx=plane_tx[0])
            time.sleep(0.05)
            state.commit()

    train(state)
    tuner = online_tuner.online_tuner()
    unsafe = {k.env: os.environ.get(k.env) for k in TUNABLE.values()
              if not k.live_safe and k.env}
    weights = torch.cat([p.detach().reshape(-1) for p in
                         model.parameters()]).double().sum().item()
    log(final=True, rank=hvd.rank(), size=hvd.size(), steps=state.step,
        unsafe=unsafe,
        tuner=None if tuner is None else tuner.state(),
        decisions=[] if tuner is None else
        [r["type"] for r in tuner.trajectory()],
        objective=metrics.value("hvd_tune_objective"),
        windows=metrics.value("hvd_tune_windows_total"), weights=weights,
        plane_tx=plane_tx[0])
    online_tuner.stop_online_tuner()
    hvd.shutdown()
    return 0


def main(mode, device, *args):
    if device == "cuda":
        device = "cuda:%s" % os.environ.get("HOROVOD_LOCAL_RANK", "0")
    if mode == "elastic":
        return elastic(device, *args)
    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    try:
        return {"typed": typed, "heal": heal, "c8": c8,
                "ingraph": ingraph}[mode](hvd, device)
    finally:
        # After a failure too, as an elastic survivor does: on the card,
        # exiting with the watch's NCCL abort still under way can end the
        # process in the abort's thread ("driver shutting down").
        hvd.shutdown()


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
