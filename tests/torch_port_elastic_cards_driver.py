"""A small elastic driver for tests/test_torch_port_elastic_cards.py.

The JAX package's driver does not run where the cards are (that machine
has no jax), so this file plays its part for four port workers:
chip_smoke.py's rendezvous KV store, each world published as the driver
publishes it (slots first, then the meta with a negotiated port), and the
workers spawned with the driver's env. The flow:

1. version 0: four ranks train; rank 3 exits at step 5;
2. version 1, once rank 3's exit is seen: the three survivors, whose
   collectives raised ``HorovodInternalError``, reform at size 3;
3. version 2, once the world of three has committed step 8: a fresh
   rank 3 is spawned and syncs from rank 0; the survivors take a graceful
   reset at a commit;
4. all four finish at step 16 and check that their weights are equal.

Each worker logs JSON lines (steps, its restore time, its exit time, a
final checksum) that the test reads. Run as ``python
tests/torch_port_elastic_cards_driver.py cpu`` it rehearses the flow on
gloo; with ``cuda`` each rank takes the card of its first
local rank.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from chip_smoke import KVServer  # noqa: E402

STEPS = 16
FAIL_STEP = 5
GROW_AFTER = 8
SIZE = 4


def _records(log_dir):
    out = []
    for name in os.listdir(log_dir):
        if name.endswith(".log"):
            with open(os.path.join(log_dir, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def _wait(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while not predicate():
        if time.monotonic() > deadline:
            raise TimeoutError("timed out waiting for " + what)
        time.sleep(0.05)


def drive(device, log_dir, timeout=600):
    """Run the flow; returns ``(return codes by slot, log records,
    outputs)``. Raises ``TimeoutError`` if a stage does not come."""
    kv = KVServer()
    slots = ["localhost:%d" % i for i in range(SIZE)]
    procs, outputs = {}, {}

    def spawn(slot, version, n):
        rank = slots.index(slot)
        env = dict(os.environ,
                   HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(n),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(n),
                   HOROVOD_CROSS_RANK="0", HOROVOD_CROSS_SIZE="1",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT="0",
                   HOROVOD_RENDEZVOUS_ADDR="127.0.0.1",
                   HOROVOD_RENDEZVOUS_PORT=str(kv.port),
                   HOROVOD_SLOT_KEY=slot,
                   HOROVOD_RENDEZVOUS_VERSION=str(version),
                   HOROVOD_ELASTIC="1", HVD_HEARTBEAT_SEC="1",
                   # A rank that dies with unread data resets its
                   # connections; the core gives the peer up after this
                   # many seconds of reconnecting (default 30).
                   HVD_WIRE_RECONNECT_SEC="2",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        out = open(os.path.join(log_dir, "out_%s_v%d.txt"
                                % (slot.replace(":", "_"), version)), "w")
        outputs[(slot, version)] = out.name
        procs[(slot, version)] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", device,
             log_dir], env=env, stdout=out, stderr=subprocess.STDOUT)
        out.close()

    try:
        kv.publish(0, slots)
        for slot in slots:
            spawn(slot, 0, SIZE)
        dying = procs[(slots[-1], 0)]
        _wait(lambda: dying.poll() is not None, timeout, "rank 3's exit")
        kv.publish(1, slots[:-1])
        _wait(lambda: any(r.get("size") == SIZE - 1 and
                          r.get("step", 0) >= GROW_AFTER
                          for r in _records(log_dir)), timeout,
              "the world of three to commit step %d" % GROW_AFTER)
        kv.publish(2, slots)
        spawn(slots[-1], 2, SIZE)
        deadline = time.monotonic() + timeout
        for p in procs.values():
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        kv.close()
    codes = {key: p.returncode for key, p in procs.items()}
    return codes, _records(log_dir), outputs


def _worker(device, log_dir):
    import torch

    import horovod_tpu_torch as hvd_p
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import models

    slot = os.environ["HOROVOD_SLOT_KEY"]
    path = os.path.join(log_dir, "slot_%s.log" % slot.replace(":", "_"))

    def log(**record):
        record.update(slot=slot, pid=os.getpid(), t=time.time())
        with open(path, "a") as f:
            f.write(json.dumps(record) + "\n")

    if device == "cuda":
        device = "cuda:%s" % os.environ["HOROVOD_LOCAL_RANK"]
    hvd.init(device=device)
    cfg = models.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                   n_layers=2, d_ff=128, max_seq_len=64,
                                   dtype=torch.float32, attention="dense")
    model = models.Transformer(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    opt = hvd_p.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))

    class State(hvd.elastic.TorchState):
        def restore(self):
            log(event="restore", rank=hvd.rank())
            super().restore()

    state = State(model, opt, step=0)
    marker = os.path.join(log_dir, "fail_marker")

    @hvd.elastic.run
    def train(state):
        while state.step < STEPS:
            step = state.step
            if hvd.rank() == SIZE - 1 and step == FAIL_STEP and \
                    not os.path.exists(marker):
                open(marker, "w").close()
                log(event="exit", rank=hvd.rank(), step=step)
                os._exit(17)
            # An eager allreduce of a card tensor (the device plane) and a
            # bucketed step (the in-graph NCCL path).
            x = torch.full((8,), float(step), device=device)
            out = hvd.allreduce(x, name="cards.step", op=hvd.Average)
            gen = torch.Generator(device=device).manual_seed(
                1000 * step + hvd.rank())
            tokens = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len),
                                   generator=gen, device=device)
            loss = models.lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            opt.zero_grad()
            if not torch.equal(out, x):
                raise AssertionError("allreduce: %s" % out)
            state.step = step + 1
            log(rank=hvd.rank(), size=hvd.size(), step=state.step,
                loss=float(loss.detach()))
            time.sleep(0.2)
            state.commit()

    train(state)
    mine = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    every = hvd.allgather(mine[None], name="cards.final")
    equal = all(torch.equal(row, mine) for row in every)
    log(final=True, rank=hvd.rank(), size=hvd.size(), equal=equal,
        checksum=float(mine.double().sum()))
    hvd.shutdown()
    return 0 if equal else 1


if __name__ == "__main__":
    if sys.argv[1] == "worker":
        sys.exit(_worker(sys.argv[2], sys.argv[3]))
    import tempfile

    directory = tempfile.mkdtemp(prefix="hvd_cards_")
    codes, records, _ = drive(sys.argv[1], directory)
    print(json.dumps({"codes": {"%s@v%d" % k: v for k, v in codes.items()},
                      "dir": directory}))
