"""Planned layouts trained across four cards against one card's run.

Four ranks, one card each (the card of the global rank), laid out as two
nodes of two (HOROVOD_LOCAL_SIZE=2), so that the two-level ladder exists.
The model is PERF.md's ``moe`` cell: transformer_long's widths (vocab
8192, d_model 512, 8 heads, 4 layers, d_ff 2048), 4 top-1 experts a
layer, flash attention, 43.0M parameters, global batch 4 at seq 2048, 8
steps of ``Plan.optimizer(SGD(0.01, momentum=0.9))`` (``LR``: see there
why not AdamW), in fp32 with TF32 off, so that the comparison is at
fp32's rounding:

* (a) ``plan(require_axes={"expert": 2})``: data 2 x expert 2;
* (b) ``plan(require_axes={"expert": 4})``: data 1 x expert 4;
* (c) transformer_long (no experts) under ``Topology.make(4, dcn=2)``:
  data_dcn 2 x data_ici 2, sync ``hierarchical``, its gradients on the
  ladder.

Each rank first trains the unsharded model on its own card on the same
global batch with the plain optimizer (one card's run), as the plan's data
axis splits it: one micro-batch a data shard, the gradients averaged
(data-parallel semantics; each MoE block routes the tokens of its shard
with their capacity, ROADMAP's deliberate differences). At init the
router sends most tokens of a layer to one or two experts, so a capacity
over the whole batch keeps tokens that one over a shard drops: against a
whole-batch run (a) missed by 3.5e-4 in the first loss. The planned run's
losses (each step's loss averaged over the data shards) and final
parameters (this rank's expert rows against the same rows of the
one-card run) must agree within tests/test_torch_port_moe.py's
``MODEL_RTOL`` (1e-6) of each tensor's largest magnitude. Each rank prints its peak memory
(``torch.cuda.max_memory_allocated``) against the one-card run's, and
with experts sharded it must be lower. The attention kernels launch 4
times a step (one forward, one dK/dV and one dQ a layer) on every rank.

This file, run as a script by each rank (``python
tests/test_torch_port_plan_cards.py DEVICE``), is the ranks; ``cpu``
rehearses the flow on gloo at small widths. On a machine with four
cards::

    python3 -m pytest tests/test_torch_port_plan_cards.py -m cuda -q -s
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N = 4
STEPS = 8
SEED = 0
MODEL_RTOL = 1e-6
# SGD with momentum, not AdamW: Adam's step divides by the root of the
# squared gradient (eps 1e-8), so an element whose gradient is near 0
# turns the fp32 rounding of a regrouped sum (the data shards' gradients
# averaged, against one gradient of the whole batch) into a step up to
# lr/eps = 1e5 times larger: after 8 steps a zero-initialised LayerNorm
# bias differed by 4.6e-5 of its largest value on the CPU rehearsal.
LR = 0.01
LAYOUTS = (("a", "moe", {"expert": 2}, 1), ("b", "moe", {"expert": 4}, 1),
           ("c", "transformer_long", None, 2))


def _config(models, tiny):
    if tiny:
        return models.TransformerConfig(
            vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            max_seq_len=32, dtype=torch.float32, attention="flash"), 4, 32
    return models.TransformerConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
        max_seq_len=2048, dtype=torch.float32, attention="flash"), 4, 2048


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-300))


def _train(hvd, models, fa, cfg, tokens, dev, wrap, shards):
    """``STEPS`` steps on ``tokens``: each step the batches of ``shards``
    (row slices) one after another, their gradients averaged; returns the
    losses (averaged over the shards and the optimizer's set), the final
    parameters on the CPU, the peak memory and the attention launches."""
    from horovod_tpu_torch.ops import collective_ops as C

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = models.Transformer(cfg, device=dev, generator=gen)
    inner = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    opt = wrap(inner) if wrap else inner
    batches = [tokens[rows].to(dev) for rows in shards]
    losses = []
    fa.reset_launches()
    for _ in range(STEPS):
        loss = 0.0
        for local in batches:
            part = models.lm_loss(model(local), local) / len(batches)
            part.backward()
            loss = loss + part.detach()
        opt.step()
        opt.zero_grad()
        if wrap:
            loss = C.allreduce(loss, C.Average,
                               process_set=opt.process_set)
        losses.append(float(loss))
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    params = {k: v.detach().cpu().clone()
              for k, v in model.named_parameters()}
    del model, inner, opt
    return losses, params, peak, launches


def _worker_main(device):
    import faulthandler

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.ops import collective_ops as C
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import hierarchical, mesh, planner

    tiny = device == "cpu"
    faulthandler.dump_traceback_later(TIMEOUT_SEC - 30)
    rank = int(os.environ["HOROVOD_RANK"])
    hvd.init(device="cpu" if tiny else "cuda:%d" % rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu" if tiny else "cuda:%d" % rank)
    card = _card_line() if not tiny else "cpu"
    base, batch, seq = _config(models, tiny)
    tokens = torch.randint(0, base.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(SEED))
    failures = []
    for tag, name, require, dcn in LAYOUTS:
        experts = 4 if name == "moe" else 0
        cfg = dataclasses.replace(base, num_experts=experts)
        w = planner.workload_from_params(
            models.Transformer(cfg, device="meta"), batch=batch,
            seq_len=seq, n_layers=cfg.n_layers, num_experts=experts)
        p = planner.plan(workload=w, require_axes=require,
                         topology=planner.Topology.make(N, dcn=dcn))
        d = 1
        for a in p.data_axes:
            d *= p.mesh_axes[a]
        shards = [slice(i * batch // d, (i + 1) * batch // d)
                  for i in range(d)]
        mesh.reset_global_mesh()
        ref_losses, ref_params, ref_peak, _ = _train(
            hvd, models, fa, cfg, tokens, dev, None, shards)
        m = p.apply()
        shape = mesh.mesh_shape(m)
        grads = p.grad_process_set()
        rows = shards[grads.ranks.index(rank) if grads.size() == d else 0]
        ladder = C._route_hierarchical(C.Average, grads,
                                       "HOROVOD_HIERARCHICAL_ALLREDUCE")
        losses, params, peak, launches = _train(
            hvd, models, fa, cfg, tokens, dev, p.optimizer, [rows])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                          ref_losses))
        param_rel, sharded = 0.0, 0
        first = mesh.axis_index("expert") * (experts // shape["expert"]) \
            if "expert" in shape else 0
        for k, v in params.items():
            want = ref_params[k]
            if v.shape != want.shape:
                want = want[first:first + v.shape[0]]
                sharded += 1
            param_rel = max(param_rel, _rel(v, want))
        line = dict(layout=tag, rank=rank, mesh=p.mesh_axes, sync=p.sync,
                    ladder=ladder, rows=[rows.start, rows.stop],
                    losses=losses, loss_rel=loss_rel, param_rel=param_rel,
                    sharded_tensors=sharded, peak_gb=peak / 1e9,
                    one_card_peak_gb=ref_peak / 1e9, launches=launches)
        print("PLAN_CARDS %s" % json.dumps(line), flush=True)
        if not (loss_rel < MODEL_RTOL and param_rel < MODEL_RTOL):
            failures.append("%s: losses %.3e, parameters %.3e off the one "
                            "card's" % (tag, loss_rel, param_rel))
        if experts and sharded != 2 * cfg.n_layers:
            failures.append("%s: %d sharded tensors" % (tag, sharded))
        if experts and not tiny and not peak < ref_peak:
            failures.append("%s: peak %.3f GB not below one card's %.3f"
                            % (tag, peak / 1e9, ref_peak / 1e9))
        if tag == "c" and not (p.sync == "hierarchical" and ladder
                               and hierarchical.ladder() is not None):
            failures.append("c: not on the ladder (sync %s)" % p.sync)
        if not tiny and set(launches.values()) != {cfg.n_layers * STEPS}:
            failures.append("%s: attention launches %s" % (tag, launches))
    mesh.reset_global_mesh()
    hvd.shutdown()
    print("PLAN_CARDS_DONE rank %d on %s: %s" % (
        rank, card, "ok" if not failures else "; ".join(failures)),
        flush=True)
    return 1 if failures else 0


def _card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


TIMEOUT_SEC = 900


def spawn(device, timeout=TIMEOUT_SEC):
    """Run this file as ``N`` ranks, two to a node; returns (exit codes,
    logs)."""
    port = str(_free_port())
    procs = []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank % 2), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=port, OMP_NUM_THREADS="2",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("HOROVOD_HIERARCHICAL_ALLREDUCE", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), device], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            try:
                out = p.communicate(timeout=timeout)[0]
            except subprocess.TimeoutExpired:
                # Each rank dumps its stacks before this (its worker's
                # faulthandler): kill it and keep them.
                p.kill()
                out = p.communicate()[0]
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], logs


def _check(device):
    codes, logs = spawn(device)
    for log in logs:
        for line in log.splitlines():
            if line.startswith("PLAN_CARDS"):
                print(line)
    for rank, (code, log) in enumerate(zip(codes, logs)):
        assert code == 0, "rank %d:\n%s" % (rank, log[-4000:])


@pytest.mark.cuda
def test_planned_layouts_on_four_cards_match_one_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip("needs four CUDA cards: the planned meshes across them")
    _check("cuda")


def test_planned_layouts_on_gloo_match_one_rank():
    """The same flow at small widths on the CPU (gloo, 4 ranks)."""
    _check("cpu")


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1]))
