"""Tiny copies of the benchmark's cells for the CPU tests: the checkout's
``BENCHMARK.json`` and ``portbench/`` copied under a temporary root, the
cell's configuration cut to toy widths in float32 with dense attention
(the flash kernels have no CPU mode), its traffic to a toy batch."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

LM = "cerebras-gpt-1.3b.train.b16s2048.remat"
RN = "resnet50.train.b512"

TINY_CONFIG = {
    "transformer": dict(vocab_size=64, n_embd=32, n_head=2, n_layer=2,
                        n_inner=64, n_positions=16, dtype="float32",
                        attention="dense"),
    "resnet": dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10,
                   dtype="float32"),
}
TINY_TRAFFIC = {"transformer": dict(batch=4, seq_len=16),
                "resnet": dict(batch=8, px=64)}


def _edit(path: str, changes: dict) -> None:
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f)


def bench_root(tmp: str) -> str:
    """A copy of the checkout's benchmark under ``tmp``, with the entries
    of ``pending.json`` added where ``BENCHMARK.json`` lacks them: cells
    whose files ``portbench/`` keeps while the program fails them
    (PERF.md, Open questions), so that their code stays tested."""
    root = os.path.join(tmp, "checkout")
    if os.path.isdir(root):
        return root
    os.makedirs(root)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(os.path.dirname(__file__), "pending.json")) as f:
        pending = json.load(f)
    for key, entries in pending.items():
        have = {x["name"] for x in bench[key]}
        bench[key] += [x for x in entries if x["name"] not in have]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


_FULL = []


def load_cell(workload: str):
    """``workload`` at its own sizes, pending or not (from one copy a
    test process)."""
    import tempfile

    from portbench import spec

    if not _FULL:
        _FULL.append(bench_root(tempfile.mkdtemp(prefix="portbench-")))
    return spec.load_cell(workload, _FULL[0])


def tiny_root(tmp: str, workload: str, **traffic) -> str:
    """A checkout under ``tmp`` whose ``workload`` runs at toy sizes."""
    root = bench_root(tmp)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = {x["name"]: x for x in bench["workloads"]}[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cpath = os.path.join(root, conf["file"])
    with open(cpath) as f:
        fam = json.load(f)["family"]
    _edit(cpath, TINY_CONFIG[fam])
    _edit(os.path.join(root, "portbench", "traffic", w["traffic"] + ".json"),
          dict(TINY_TRAFFIC[fam], **traffic))
    return root


def tiny_cell(tmp: str, workload: str, **traffic):
    from portbench import spec

    return spec.load_cell(workload, tiny_root(tmp, workload, **traffic))


def run_tiny(cell, seed: int = 2**31 + 11, hooks=None, seconds=0.2):
    """One rank of ``cell`` in this process on the CPU: its record, with
    the peak of a card read as 0."""
    import time

    from portbench import worker

    return worker.run_rank(cell, seed, seconds, False, time.time(),
                           device="cpu", hooks=hooks)


# -- faults planted under the timed path ----------------------------------


def state_unchanged(job) -> None:
    """Each step reduces the gradients and updates nothing."""
    def step(closure=None):
        job.opt.synchronize()
    job.opt.step = step


def half_batch(job) -> None:
    """Each step drops the second half of the batch and takes the mean
    loss over the rest."""
    loss = job.loss

    def half(x, y):
        n = x.shape[0] // 2
        return loss(x[:n], y[:n])
    job.loss = half


def inner_wgrad(job) -> None:
    """The weight gradient of each block's 3x3 convolution doubled. Behind
    v1.5's zero-init batch norm that gradient is 0 at the first step; it
    shows in the steps after."""
    from portbench.reference.train import INNER

    for name, p in job.model.named_parameters():
        if name.startswith(INNER[0]) and name.endswith(INNER[1]):
            p.register_hook(lambda g: g * 2)


class _Done:
    def wait(self, *a, **k):
        return True

    def is_completed(self):
        return True

    def exception(self):
        return None


class _NoExchange:
    """``torch.distributed`` for the port's bucket flights, but an
    allreduce that leaves each rank's bucket its own (times the ranks, so
    that Average's division gives the rank's own gradient back)."""

    def __init__(self, dist):
        self._dist = dist

    def __getattr__(self, name):
        return getattr(self._dist, name)

    def all_reduce(self, tensor, op=None, group=None, async_op=False):
        tensor.mul_(self._dist.get_world_size(group))
        return _Done() if async_op else None


def no_exchange(job) -> None:
    """The exchange between ranks left out: each steps on its own
    gradient."""
    from horovod_tpu_torch.ops import collective_ops

    collective_ops.dist = _NoExchange(collective_ops.dist)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "inner_wgrad": inner_wgrad}
