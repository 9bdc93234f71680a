"""Sequence, MoE and pipeline parallelism across four cards, on NCCL.

Four ranks, one card each (the card of the global rank), all four in
one registered process set:

* ring and Ulysses attention at transformer_long's widths (B 4, S 2048
  across the set, 8 heads of 64), forward and backward, bf16 and fp32,
  against full-sequence attention (the port's ``_dense_attention``, the
  reference's formula) on each rank's own card, element by element under
  ``rtol |plain| + atol rms(row)``: bf16 2^-7 / 2^-5 (one bf16 rounding,
  and the bf16 scores' rounding summed over keys), fp32 1e-4; the row's
  RMS floored at 2^-8 of the tensor's, as chip_smoke.py holds kernels;
* the ring transformer (transformer_long's widths at 2 layers, fp32, TF32
  off): 2 steps of ``DistributedOptimizer(AdamW)`` on the set, each
  member's loss over its slice (``shard_sequence``), against the
  unsharded dense model on the same card: the step losses within
  ``STEP_RTOL`` and the first step's averaged gradients within
  ``STEP_RTOL`` of each tensor's largest magnitude;
* ``expert_parallel_moe`` at n=4, E=8 (d_model 512, d_ff 2048, 2048
  tokens a rank, fp32) against ``moe_ffn`` with every expert on one
  card: outputs and the gradients of x, the router and the local
  experts, within ``MOE_RTOL`` of the largest magnitude;
* a 4-stage pipeline of transformer blocks (d_model 512, dense attention,
  fp32; 4 microbatches of 1 x 2048) against the blocks run in sequence:
  outputs and each stage's parameter gradients, ``PIPE_RTOL``.

Each case prints its time once, with the card's name and power limit,
as information. This file, run as a script by each rank (``python
tests/test_torch_port_parallel_cards.py DEVICE``), is the ranks; ``cpu``
rehearses the flow on gloo at small widths. On a machine with four
cards::

    python3 -m pytest tests/test_torch_port_parallel_cards.py -m cuda -q -s
"""

import dataclasses
import math
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
N = 4
TOLS = {torch.bfloat16: (2 ** -7, 2 ** -5), torch.float32: (1e-4, 1e-4)}
ROW_FLOOR = 2 ** -8
STEP_RTOL = 1e-4
MOE_RTOL = 1e-5
PIPE_RTOL = 1e-5


def _widths(tiny):
    """(B, S global, H, D), d_model, d_ff, vocab, microbatches."""
    if tiny:
        return (2, 32, 4, 8), 32, 64, 64, 4
    return (4, 2048, 8, 64), 512, 2048, 8192, 4


def limit_ratio(got, want, rtol, atol):
    got, want = got.detach().float(), want.detach().float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(
        min=ROW_FLOOR * float(want.pow(2).mean().sqrt()))
    ratio = (got - want).abs() / (rtol * want.abs() + atol * rms)
    return float(ratio.nan_to_num(nan=0.0, posinf=math.inf).max())


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / (b.double().abs().max() + 1e-30))


def _card():
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class _Clock:
    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.ms = 1e3 * (time.perf_counter() - self.t0)


# ---------------------------------------------------------------- worker ---

def _attention_checks(hvd, S, ps, dev, tiny, report):
    b, s, h, d = _widths(tiny)[0]
    rank, n = hvd.rank(), N
    part = slice(rank * s // n, (rank + 1) * s // n)
    fails = []
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(7)
        full = [torch.randn(b, s, h, d, generator=gen, device=dev,
                            dtype=dtype) for _ in range(4)]
        q, k, v, dout = full
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        want = S._dense_attention(*leaves, True)
        (want.float() * dout.float()).sum().backward()
        want_grads = [x.grad[:, part] for x in leaves]
        for name, fn in (("ring", S.ring_attention),
                         ("ulysses", S.ulysses_attention)):
            mine = [x[:, part].clone().requires_grad_() for x in (q, k, v)]
            with _Clock(dev) as clock:
                out = fn(*mine, axis=ps, causal=True)
                (out.float() * dout[:, part].float()).sum().backward()
            rtol, atol = TOLS[dtype]
            worst = max([limit_ratio(out, want[:, part], rtol, atol)]
                        + [limit_ratio(x.grad, g, rtol, atol)
                           for x, g in zip(mine, want_grads)])
            report.append("%s attention %s B=%d S=%d H=%d D=%d: fwd+bwd "
                          "%.3f ms, worst error / limit %.3f"
                          % (name, str(dtype)[6:], b, s, h, d, clock.ms,
                             worst))
            if not worst <= 1.0:
                fails.append("%s %s: error / limit %.3f" % (name, dtype,
                                                            worst))
    return fails


def _transformer_checks(hvd, models, ps, dev, tiny, report):
    (b, s, h, d), m, f, vocab, _ = _widths(tiny)
    cfg = models.TransformerConfig(
        vocab_size=vocab, d_model=m, n_heads=h, n_layers=2, d_ff=f,
        max_seq_len=s, dtype=torch.float32, attention="dense")
    gen = torch.Generator(device=dev).manual_seed(3)
    ref = models.Transformer(cfg, device=dev, generator=gen)
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device=dev)
    ring = models.Transformer(dataclasses.replace(
        cfg, attention="ring", seq_axis=ps), device=dev)
    ring.load_state_dict(ref.state_dict())
    local, targets = models.shard_sequence(tokens, ps)
    opts = {
        "ring": hvd.DistributedOptimizer(torch.optim.AdamW(
            ring.parameters(), lr=1e-3, weight_decay=1e-4), process_set=ps),
        "ref": torch.optim.AdamW(ref.parameters(), lr=1e-3,
                                 weight_decay=1e-4)}
    losses, grads, times = {"ring": [], "ref": []}, {}, []
    for step in range(2):
        with _Clock(dev) as clock:
            loss = models.lm_loss(ring(local), local, targets)
            loss.backward()
            if step == 0:
                grads["ring"] = hvd.grouped_allreduce_ingraph(
                    [p.grad for p in ring.parameters()], process_set=ps)
            opts["ring"].step()
            opts["ring"].zero_grad()
        times.append(clock.ms)
        losses["ring"].append(float(hvd.allreduce_ingraph(loss.detach(),
                                                          process_set=ps)))
        loss = models.lm_loss(ref(tokens), tokens)
        loss.backward()
        if step == 0:
            grads["ref"] = [p.grad.clone() for p in ref.parameters()]
        opts["ref"].step()
        opts["ref"].zero_grad()
        losses["ref"].append(float(loss))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["ring"],
                                                       losses["ref"]))
    grad_rel = max(_rel(a, b) for a, b in zip(grads["ring"], grads["ref"]))
    report.append("ring transformer (d_model %d, 2 layers, S %d over %d, "
                  "fp32): step %s ms; losses %s vs unsharded %s (worst rel "
                  "%.2e); step-1 gradients worst rel %.2e (limit %.0e)"
                  % (m, s, N, " ".join("%.3f" % t for t in times),
                     losses["ring"], losses["ref"], loss_rel, grad_rel,
                     STEP_RTOL))
    if not (loss_rel < STEP_RTOL and grad_rel < STEP_RTOL):
        return ["ring transformer: losses rel %.2e, gradients rel %.2e"
                % (loss_rel, grad_rel)]
    return []


def _moe_checks(hvd, moe, ps, dev, tiny, report):
    (b, s, _, _), m, f, _, _ = _widths(tiny)
    e, t = 8, b * s // N
    capacity = max(1, 2 * t // e)
    rank = hvd.rank()
    gen = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    x, router = rnd(N, t, m), rnd(m, e, scale=0.05)
    wi, wo, dout = rnd(e, m, f, scale=0.02), rnd(e, f, m, scale=0.02), \
        rnd(N, t, m)
    per = e // N
    mine = slice(rank * per, (rank + 1) * per)
    leaves = [x[rank].clone().requires_grad_(), router.clone()
              .requires_grad_(), wi[mine].clone().requires_grad_(),
              wo[mine].clone().requires_grad_()]
    with _Clock(dev) as clock:
        y = moe.expert_parallel_moe(*leaves, capacity, axis=ps)
        (y * dout[rank]).sum().backward()
    dwi, dwo = torch.zeros_like(wi), torch.zeros_like(wo)
    for r in range(N):
        xr = x[r].clone().requires_grad_()
        ws = [w.clone().requires_grad_() for w in (router, wi, wo)]
        ref = moe.moe_ffn(xr, *ws, capacity)
        g = torch.autograd.grad((ref * dout[r]).sum(), [xr] + ws)
        dwi += g[2]
        dwo += g[3]
        if r == rank:
            want = [ref.detach(), g[0], g[1]]
    want += [dwi[mine], dwo[mine]]
    got = [y.detach()] + [leaf.grad for leaf in leaves]
    worst = max(_rel(a, b) for a, b in zip(got, want))
    report.append("expert_parallel_moe n=%d E=%d T=%d a rank M=%d F=%d "
                  "C=%d fp32: fwd+bwd %.3f ms; outputs and gradients vs "
                  "moe_ffn worst rel %.2e (limit %.0e)"
                  % (N, e, t, m, f, capacity, clock.ms, worst, MOE_RTOL))
    return [] if worst < MOE_RTOL else ["expert_parallel_moe rel %.2e"
                                        % worst]


def _pipeline_checks(hvd, models, pipeline, ps, dev, tiny, report):
    (_, s, h, _), m, f, vocab, micro = _widths(tiny)
    cfg = models.TransformerConfig(
        vocab_size=vocab, d_model=m, n_heads=h, n_layers=N, d_ff=f,
        max_seq_len=s, dtype=torch.float32, attention="dense")
    gen = torch.Generator(device=dev).manual_seed(5)
    blocks = [models.transformer.Block(cfg, gen, dev) for _ in range(N)]
    xs = torch.randn(micro, 1, s, m, generator=gen, device=dev)
    rank = hvd.rank()

    def loss_fn(outs):
        return outs.pow(2).mean()

    with _Clock(dev) as clock:
        local = pipeline.pipeline_loss(lambda blk, x: blk(x), blocks[rank],
                                       xs, loss_fn, axis=ps)
        local.backward()
    with torch.no_grad():
        outs = pipeline.pipeline_apply(lambda blk, x: blk(x), blocks[rank],
                                       xs, axis=ps)
    got = [p.grad.clone() for p in blocks[rank].parameters()]
    for blk in blocks:
        blk.zero_grad()
    seq = xs
    for blk in blocks:
        seq = torch.stack([blk(x) for x in seq])
    loss_fn(seq).backward()
    want = [p.grad for p in blocks[rank].parameters()]
    worst = max(_rel(a, b) for a, b in zip(got, want))
    if rank == N - 1:
        worst = max(worst, _rel(outs, seq.detach()),
                    abs(float(local) - float(loss_fn(seq))) / float(
                        loss_fn(seq)))
    else:
        worst = max(worst, float(outs.abs().max()), abs(float(local)))
    report.append("pipeline of %d transformer blocks (d_model %d, %d "
                  "microbatches of 1 x %d, fp32): fwd+bwd %.3f ms; outputs, "
                  "loss and stage gradients vs the blocks in sequence worst "
                  "rel %.2e (limit %.0e)"
                  % (N, m, micro, s, clock.ms, worst, PIPE_RTOL))
    return [] if worst < PIPE_RTOL else ["pipeline rel %.2e" % worst]


def _worker_main(device):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.parallel import moe, pipeline
    from horovod_tpu_torch.parallel import sequence as S

    tiny = device == "cpu"
    if not tiny:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    hvd.init(device=device)
    dev = (torch.device("cuda", torch.cuda.current_device()) if not tiny
           else torch.device("cpu"))
    ps = hvd.add_process_set(list(range(N)))
    report, fails = [], []
    fails += _attention_checks(hvd, S, ps, dev, tiny, report)
    fails += _transformer_checks(hvd, models, ps, dev, tiny, report)
    fails += _moe_checks(hvd, moe, ps, dev, tiny, report)
    fails += _pipeline_checks(hvd, models, pipeline, ps, dev, tiny, report)
    r = hvd.rank()
    hvd.shutdown()
    card = _card()
    for line in report:
        print("rank %d: %s, on %s" % (r, line, card))
    if fails:
        print("FAIL rank %d: %s" % (r, "; ".join(fails)))
        return 1
    print("CARDS_OK parallel rank %d on %s" % (r, card))
    return 0


# ----------------------------------------------------------------- tests ---

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_sequence_moe_and_pipeline_across_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < N:
        pytest.skip("needs four CUDA cards: ring, Ulysses, expert-parallel "
                    "MoE and the pipeline over NCCL")
    port = str(_free_port())
    procs = []
    for rank in range(N):
        env = dict(os.environ, HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(N),
                   HOROVOD_LOCAL_RANK=str(rank), HOROVOD_LOCAL_SIZE=str(N),
                   HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                   HOROVOD_CONTROLLER_PORT=port,
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "cuda"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    print(logs[0][-4000:])
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1]))
