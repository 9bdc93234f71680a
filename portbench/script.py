"""The training script: what a Horovod user writes around the program.

It builds the model through ``horovod_tpu_torch.models`` at the cell's
widths, loads the benchmark's weights into it, broadcasts them from rank
0, wraps the optimizer in ``DistributedOptimizer`` and trains on a pool
of batches from the traffic generator. The first ``check_steps`` steps
are set-up: they warm up every shape the window will run, and the
comparison reads them (the losses, the first gradient as the optimizer
holds it, each leaf's change). The same objects then run the window,
which reads nothing back to the host until it has closed."""

from __future__ import annotations

import datetime
import time
from typing import Iterable, List

import torch
import torch.distributed as dist

from portbench import feed, judge, trace, weights

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
# Steps the host may issue ahead of the card: it waits on the end of step
# i - QUEUE_DEPTH before it issues step i.
QUEUE_DEPTH = 2


def build_model(hvd_models, config: dict, traffic: dict, device):
    dtype = DTYPES[config["dtype"]]
    if config["family"] == "transformer":
        cfg = hvd_models.TransformerConfig(
            vocab_size=config["vocab_size"], d_model=config["n_embd"],
            n_heads=config["n_head"], n_layers=config["n_layer"],
            d_ff=config["n_inner"], max_seq_len=config["n_positions"],
            dtype=dtype, attention=config["attention"],
            remat=bool(traffic.get("remat", False)))
        return hvd_models.Transformer(cfg, device=device)
    return hvd_models.ResNet(config["stage_sizes"],
                             num_classes=config["num_classes"],
                             num_filters=config["num_filters"],
                             dtype=dtype, device=device)


def build_optimizer(params, opt: dict):
    if opt["name"] == "adamw":
        return torch.optim.AdamW(params, lr=opt["lr"],
                                 weight_decay=opt["weight_decay"])
    if opt["name"] == "sgd":
        return torch.optim.SGD(params, lr=opt["lr"],
                               momentum=opt["momentum"])
    raise ValueError("unknown optimizer %r" % (opt["name"],))


def first_moment(inner, p) -> torch.Tensor:
    """The optimizer's first moment of ``p``: AdamW's ``exp_avg``, SGD's
    momentum buffer (zeros where it holds none)."""
    st = inner.state.get(p, {})
    for key in ("exp_avg", "momentum_buffer"):
        if st.get(key) is not None:
            return st[key]
    return torch.zeros_like(p)


def first_gradient(inner, p) -> torch.Tensor:
    """The gradient the optimizer got at its first step, from its state:
    AdamW's first moment is (1 - beta1) g, SGD's momentum buffer is g."""
    st = inner.state.get(p, {})
    if "exp_avg" in st:
        beta1 = inner.param_groups[0]["betas"][0]
        return st["exp_avg"] / (1.0 - beta1)
    if st.get("momentum_buffer") is not None:
        return st["momentum_buffer"]
    return torch.zeros_like(p)  # the optimizer never got one


class HostMark:
    """A CUDA event's stand-in on the CPU (the tests' runs): the host
    clock at ``record``."""

    def __init__(self, enable_timing: bool = True):
        self.t = None

    def record(self) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostMark") -> float:
        return 1e3 * (end.t - self.t)


def _norms(tensors: Iterable[torch.Tensor]) -> List[float]:
    """Each tensor's norm; a generator's tensors are freed one by one."""
    return torch.stack([torch.linalg.vector_norm(t.float())
                        for t in tensors]).tolist()


class Job:
    def __init__(self, cell, seed: int, hvd, hvd_models, device):
        self.cell, self.seed, self.hvd, self.device = cell, seed, hvd, device
        self.rank, self.size = hvd.rank(), hvd.size()
        cfg, traffic = cell.config, cell.traffic
        self.lm = cfg["family"] == "transformer"
        # (what, host clock at its end): the parts of building the job.
        self.marks = []
        self.model = build_model(hvd_models, cfg, traffic, device)
        self.marks.append(("model", time.time()))
        self.model.load_state_dict(weights.make(cfg, seed, device))
        self.model.train()
        self.marks.append(("weights", time.time()))
        hvd.broadcast_parameters(self.model.state_dict(), root_rank=0)
        self.inner = build_optimizer(self.model.parameters(),
                                     traffic["optimizer"])
        self.opt = hvd.DistributedOptimizer(self.inner)
        self.marks.append(("broadcast, optimizer", time.time()))
        self.pool = [feed.batch(traffic, cfg, seed, self.rank, j, device)
                     for j in range(traffic["pool"])]
        self.marks.append(("batches", time.time()))
        self.next = 0
        self.store = _store(self.rank, self.size, device)
        self.units = traffic["batch"] * (traffic["seq_len"] if self.lm
                                         else 1)
        if self.lm:
            self.hvd_models = hvd_models

    def loss(self, x, y):
        out = self.model(x)
        if self.lm:
            return self.hvd_models.lm_loss(out, x, y)
        return torch.nn.functional.cross_entropy(out, y)

    def step(self, traced: bool = False, opt_events=None):
        """One training step on the next batch of the pool; returns the
        loss (on the card)."""
        x, y = self.pool[self.next % len(self.pool)]
        self.next += 1
        with trace.phase("forward", traced):
            loss = self.loss(x, y)
        with trace.phase("backward", traced):
            loss.backward()
        with trace.phase("opt_step", traced):
            if opt_events is not None:
                opt_events[0].record()
            self.opt.step()
            if opt_events is not None:
                opt_events[1].record()
        self.opt.zero_grad()
        return loss.detach()

    def _mark(self):
        if self.device.type == "cuda":
            return torch.cuda.Event(enable_timing=True)
        return HostMark()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def setup_steps(self, n: int) -> dict:
        """Run the first ``n`` steps; return what the comparison reads of
        them."""
        names = [name for name, _ in self.model.named_parameters()]
        params = [p for _, p in self.model.named_parameters()]
        losses = []
        for i in range(n):
            losses.append(self.step())
            if i == 0:
                grads = _norms(first_gradient(self.inner, p)
                               for p in params)
                if self.rank == 0:
                    kept = {name: judge.sample(first_gradient(self.inner, p))
                            for name, p in zip(names, params)}
        moments = _norms(first_moment(self.inner, p) for p in params)
        if self.rank == 0:
            last = {name: judge.sample(first_moment(self.inner, p))
                    for name, p in zip(names, params)}
        start = weights.make(self.cell.config, self.seed, self.device)
        state = self.model.state_dict()
        keys = list(start)
        change = _norms(state[k].detach().float() - start[k] for k in keys)
        if self.rank == 0:
            moved = {k: judge.sample(state[k].detach().float() - start[k])
                     for k in keys}
        del start
        mean_losses = torch.stack(losses).float()
        if self.size > 1:
            dist.all_reduce(mean_losses)
            mean_losses /= self.size
        out = {"losses": mean_losses.tolist(),
               "grad_norms": dict(zip(names, grads)),
               "change_norms": dict(zip(keys, change)),
               "state_norms": dict(zip(names, moments))}
        if self.rank == 0:
            out.update(grad_sample=kept, change_sample=moved,
                       state_sample=last)
        return out

    def window(self, seconds: float) -> dict:
        """Steps back to back for ``seconds`` of the host clock, the host
        at most ``QUEUE_DEPTH`` steps ahead of the card; then each step's
        card time and ``opt.step()`` time from CUDA events, read after.
        Rank 0 picks the last step: the first at which the steps ended so
        far, at their pace, and those still to run would fill ``seconds``.
        Above one rank it tells the others through a store of its own, a
        few steps ahead, since every rank must run the same steps."""
        ahead = QUEUE_DEPTH if self.size > 1 else 0
        ends, opts, losses = [], [], []
        first = self._mark()
        if self.size > 1:
            dist.barrier()
        self._sync()
        t0 = time.perf_counter()
        first.record()
        i, stop = 0, None
        while stop is None or i < stop:
            if i >= QUEUE_DEPTH:
                ends[i - QUEUE_DEPTH].synchronize()
            if stop is None and self.rank == 0 and i >= QUEUE_DEPTH:
                elapsed = time.perf_counter() - t0
                done = i - QUEUE_DEPTH + 1
                if elapsed * (i + ahead) / done >= seconds:
                    stop = i + ahead
                    if self.store is not None:
                        self.store.set("stop", str(stop))
            elif stop is None and self.store is not None and self.rank != 0 \
                    and self.store.check(["stop"]):
                stop = int(self.store.get("stop"))
            if stop is not None and i >= stop:
                break
            opts.append((self._mark(), self._mark()))
            losses.append(self.step(opt_events=opts[-1]))
            ends.append(self._mark())
            ends[-1].record()
            i += 1
        self._sync()
        seconds = time.perf_counter() - t0
        marks = [first] + ends
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        return {"steps": i, "seconds": seconds, "step_ms": step_ms,
                "opt_step_ms": [a.elapsed_time(b) for a, b in opts],
                "losses": torch.stack(losses).float().tolist(),
                "units": self.units * self.size}

    def traced(self, steps: int) -> dict:
        """``steps`` more steps as the window runs them, each phase
        labelled, under the profiler (``trace.profile_window``)."""
        def run():
            ends = []
            for i in range(steps):
                if i >= QUEUE_DEPTH:
                    ends[i - QUEUE_DEPTH].synchronize()
                self.step(traced=True)
                ends.append(self._mark())
                ends[-1].record()
        summary = trace.profile_window(run, warm=self.step)
        summary["steps"] = steps
        return summary

    def buckets(self) -> int:
        return len(self.opt.buckets)

    def free(self) -> None:
        del self.model, self.inner, self.opt, self.pool


def _store(rank: int, size: int, device):
    """A store of the benchmark's own on rank 0's host (one host: the
    cells run on one machine), None at size 1."""
    if size == 1:
        return None
    master = rank == 0
    store = dist.TCPStore("127.0.0.1", 0, size, master,
                          timeout=datetime.timedelta(seconds=120),
                          wait_for_workers=False) if master else None
    port = torch.tensor([store.port if master else 0], device=device)
    dist.broadcast(port, 0)
    if not master:
        store = dist.TCPStore("127.0.0.1", int(port.item()), size, False,
                              timeout=datetime.timedelta(seconds=120))
    return store
