#!/usr/bin/env python3
"""On-card smoke test of horovod_tpu_torch, the PyTorch / H100 port.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device probe: no CUDA device -> exit 1 (there is no CPU fallback);
   prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``horovod_tpu_torch/csrc`` with nvcc;
3. holds each kernel against its plain PyTorch version, element by
   element (``TOLS``), at the flagship's long-context attention shape
   (bf16), at ragged fp32 shapes (FMA kernels) and at ragged bf16 shapes
   for every head dim (tensor-core kernels, causal and not); the
   backward kernels also run chained on the forward kernel's lse and
   delta, as the main path runs them; runs the bf16 dK/dV and dQ kernels
   twice at the slice shape and requires bit-equal results (no atomics); times
   kernel, plain version, and the library call (SDPA forward, and SDPA
   backward against both backward kernels together) beside the bound;
4. drives the port's main path: ``transformer_long`` (the flagship at
   seq 2048 with flash attention, full width) trained for a few steps
   with ``DistributedOptimizer(AdamW)`` under ``init()`` at size 1, with
   every launch counter zeroed just before and read just after; reports
   the step time and the host's time to issue a step, the kernel time by
   family (and which kernels ran in it) and the host ops with the most
   self CPU time under torch.profiler; checks the loss falls and that
   flash and dense attention give the same logits on a small input;
5. drives the ResNet half of the main path: ``resnet50`` (ResNet-50 v1.5,
   1000 classes, batch 128 at 224px, bf16 compute, fp32 params and batch
   statistics, channels_last; nothing cut) after
   ``broadcast_parameters``/``broadcast_optimizer_state``, trained for
   ``RESNET_STEPS`` steps on one fixed batch with
   ``DistributedOptimizer(SGD(0.05, momentum=0.9))``; reports step time,
   images/s, MFU against the bf16 peak from FLOPs counted on the layer
   shapes, the host's time to issue a step, peak memory, buckets, the
   kernel time by family and the top host ops; checks that the loss
   falls, that every bucket launched every step, that a reduced ResNet
   gives the CPU's logits, gradients, running statistics and updated
   weights on the card in fp32 (``CARD_VS_CPU_TOL``), and that
   ``SyncBatchNorm`` at size 1 equals the plain batch norm
   (``SYNC_BN_TOL``);
6. the ``eager:`` phase, the negotiated eager path on the card: the fusion
   kernels against their plain versions bit for bit, every eager op at
   size 1 against ``LocalBackend`` bit for bit (Adasum among the ops), and
   the example's full-width ResNet-50 loop through
   ``horovod_tpu_torch.torch.DistributedOptimizer`` on process set [0],
   beside the bucketed optimizer's loop, with its step checked against
   plain PyTorch;
7. the ``adasum:`` phase at the same width (161 gradients): the eager loop
   with ``op=Adasum`` (losses against the Average loop's) and the device
   plane's fp64 tree over 4 members simulated on the one card, with the
   Adasum launch counters zeroed just before and read just after; then
   the Adasum kernels against their plain versions (dots to
   ``ADASUM_DOTS_RTOL``, the rest bit for bit, two runs bit-equal), the
   tree in fp32, fp16 and bf16 against ``adasum_reference`` within
   ``ADASUM_ULPS``, and the kernels' times beside their bounds;
8. the ``moe:`` phase: transformer_long with ``MOE_EXPERTS`` top-1
   experts in place of each MLP (flash attention, bf16), ``MOE_STEPS``
   steps through the bucketed optimizer with the launch counters zeroed
   just before and read just after; step time, tokens/s, host time, peak
   memory, the kernel time of the dispatch einsums, the expert FFN, the
   attention kernels and the rest; checks that the loss falls, that every
   bucket launched every step, that each attention kernel ran once a layer
   a step, and that one MoE layer in fp32 gives the CPU's dispatch exactly
   and its output and gradients within ``MOE_LAYER_RTOL``;
9. the ``sequence:`` phase: the ring and the Ulysses transformer at size 1
   (the global set) against the flash transformer from the same weights,
   step by step (``SEQ_LOSS_RTOL``); the ring's schedule over
   ``RING_MEMBERS`` slices of one (4, 2048, 8, 64) problem against
   full-sequence attention in bf16 and fp32 (``TOLS``); and
   ``pipeline_apply`` at size 1 against the sequential stack;
10. the ``elastic:`` phase: transformer_long at full width under
    ``elastic.run``, with this script as the elastic driver (a local KV
    store, the slot published before the meta, heartbeats every 0.5 s).
    Run A trains ``ELASTIC_STEPS`` steps uninterrupted, committing every
    step and checkpointing every ``ELASTIC_CKPT_INTERVAL``-th; run B fails
    at step ``ELASTIC_FAIL_STEP`` (``HorovodInternalError``), restores,
    reinitialises at size 1 on the card and goes on, then takes a
    graceful reset at version 2; run C, a fresh model, auto-resumes from
    run B's checkpoints, then falls back one step from a corrupt newest
    step. Checks: the restore is the commit bit for bit, run B's losses
    are run A's before the failure and the plain loop's on its own
    batches throughout, the sampler's processed indices, the heartbeats'
    versions, the attention launches (4 a step, counters zeroed just
    before run B), and the resumes; prints step, commit, checkpoint,
    restore, auto-resume and recovery times and peak memory.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

SEED = 0
# A kernel's output against its plain version, element by element:
#   |kernel - plain| <= rtol * |plain| + atol * (RMS of plain's row),
# the row being the last axis (a query row of O or dQ, a key row of dK or
# dV). bf16: rtol 2^-7 is one bf16 rounding step (both sides round their
# output to bf16); atol 2^-5 of the row's RMS covers the tensor cores'
# rounding of P and dS to bf16 before their products, summed over keys.
# fp32: the same math summed in another order. A row's RMS is floored at
# ROW_FLOOR of the whole tensor's: a row whose exact value is zero (dQ of
# a query that sees one key, where dS = P (dP - delta) and dP = delta)
# holds only fp32 rounding residue on either side, which a limit of 0
# would reject.
TOLS = {"bfloat16": (2 ** -7, 2 ** -5), "float32": (1e-4, 1e-4)}
ROW_FLOOR = 2 ** -8
LSE_TOL = 1e-4    # absolute (nats): lse is fp32 from fp32 max and sum
FP32_TOL = 1e-4   # flash vs dense attention in fp32
SLICE_SHAPE = (4, 8, 2048, 64)   # (B, H, S, D) of transformer_long
RESNET_STEPS = 10
# bench.py's analytic forward count of ResNet-50 at 224px: torchvision's
# published multiply-adds (4.09 G), though bench.py calls them FLOPs.
BENCH_RESNET50_FWD = 4.09e9
# The card's fp32 (cuDNN, TF32 off) against the CPU's fp32, elementwise,
# as a fraction of the tensor's largest magnitude. At the check's seed
# the CPU's fp32 results stay within 2.8e-6 of its float64 ones, and at
# the CPU tests' inputs the port's fp32 gradients within 3.1e-5 of
# flax's float64 ones (tools/port_numerics.py); cuDNN may pick Winograd
# or FFT convolutions,
# which round more. 1e-3 leaves that room; a wrong padding or batch-norm
# convention moves results by whole percent.
CARD_VS_CPU_TOL = 1e-3
# SyncBatchNorm (E[x²] - mean², fp32 sums) against the plain batch norm
# (cuDNN) at size 1, fp32, same fraction: 5.1e-6 on the CPU at this seed
# (tools/port_numerics.py).
SYNC_BN_TOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """One line per compiled kernel: name, registers, spills, smem."""
    rows, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            kern = re.search(r"(fwd_mma|dkv_mma|dq_mma|fwd|dkv|dq)_kernel",
                             name)
            if kern:  # flash attention: head dim, dtype, pipe
                dim = re.search(r"ILi(\d+)E", name)
                label = "%s D=%s %s (%s)" % (
                    kern.group(0), dim.group(1) if dim else "?",
                    "bf16" if "bfloat16" in name else "fp32",
                    "tensor cores" if "_mma_" in name else "FMA")
            else:  # the collectives' kernels: name<dtype id, flag>
                base = re.search(r"\d+([A-Z][A-Za-z]*Kernel)", name)
                args = re.search(r"Kernel(?:ILi(\d+)ELb([01])E)", name)
                label = (base.group(1) if base else name) + (
                    "<%s, %s>" % args.groups() if args else "")
            rows.append("%s: %s registers, %s bytes spilled"
                        % (label, m.group(1), spills))
            name = None
    return rows


# ------------------------------------------------------------- kernels ---


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-30))


def _abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def limit_ratio(got, want, rtol, atol) -> float:
    """Largest ``|got - want| / (rtol |want| + atol rms(want's row))`` over
    every element, the row's RMS at least ``ROW_FLOOR`` times the
    tensor's; an output passes at <= 1."""
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(
        min=ROW_FLOOR * float(want.pow(2).mean().sqrt()))
    ratio = (got - want).abs() / (rtol * want.abs() + atol * rms)
    return float(ratio.nan_to_num(nan=0.0, posinf=math.inf).max())


def make_inputs(torch, b, h, sq, skv, d, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d), \
        rnd(b, h, sq, d)


def compare_kernels(torch, fa, b, h, sq, skv, d, dtype, causal, device):
    """Each kernel against its plain version on the same inputs: for each
    output, its largest error as a fraction of its limit (``limit_ratio``;
    lse against ``LSE_TOL``), and the kernel's largest absolute error.
    The backward kernels run twice, each time held to their plain
    versions on the same lse and delta: those of the plain forward, and
    chained as the main path runs them, the kernel forward's lse and
    delta from the kernel's O. (Against the plain chain, dQ would carry
    the plain chain's own rounding: delta comes from O rounded to bf16,
    and where dQ's row is small a one-ulp change of O moves it by more
    than its limit. The forward's outputs are held by their own check.)"""
    q, k, v, do = make_inputs(torch, b, h, sq, skv, d, dtype, device, SEED)
    scale = d ** -0.5
    rtol, atol = TOLS[str(dtype)[6:]]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    alone = (q, k, v, do, lse_ref, (do.float() * o_ref.float()).sum(-1),
             causal, scale)
    chained = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal,
               scale)
    out = {"flash_fwd": (
        [("O", limit_ratio(o, o_ref, rtol, atol)),
         ("lse", _abs(lse, lse_ref) / LSE_TOL)],
        max(_abs(o, o_ref), _abs(lse, lse_ref)))}
    for name, kern, plain, labels in (
            ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain,
             ("dK", "dV")),
            ("flash_bwd_dq", lambda *a: (fa.flash_bwd_dq(*a),),
             lambda *a: (fa.flash_bwd_dq_plain(*a),), ("dQ",))):
        runs = [(suffix, plain(*args), kern(*args))
                for suffix, args in (("", alone), (" chained", chained))]
        parts = [(lab + suffix, limit_ratio(g, w, rtol, atol))
                 for suffix, want, got in runs
                 for lab, g, w in zip(labels, got, want)]
        _, want, got = runs[0]
        out[name] = (parts, max(_abs(g, w) for g, w in zip(got, want)))
    torch.cuda.synchronize()
    return out


def median_ms(torch, fn, reps=50, rounds=5):
    """Median over ``rounds`` of ``time_ms(fn, reps)``: one noisy round
    does not move it."""
    return sorted(time_ms(torch, fn, reps) for _ in range(rounds))[
        rounds // 2]


def time_ms(torch, fn, reps):
    """Mean ms of ``fn`` over ``reps`` calls, CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bounds(b, h, sq, skv, d, itemsize, causal):
    """(bound_ms, bound_by) of each kernel: the larger of the bytes it
    must move over HBM bandwidth and the products over the bf16/fp32
    peak. Products count only the (q, k) pairs the mask leaves."""
    off = skv - sq
    pairs = sum(min(max(r + off + 1, 0), skv) for r in range(sq)) \
        if causal else sq * skv
    pairs *= b * h
    panel_q = b * h * sq * d * itemsize
    panel_k = b * h * skv * d * itemsize
    rows = b * h * sq * 4
    peak = PEAK_FLOPS["bf16" if itemsize == 2 else "fp32"]
    work = {
        # fwd: S = QKᵀ, O = PV; q, k, v in, o and lse out.
        "flash_fwd": (4 * pairs * d, 2 * panel_q + 2 * panel_k + rows),
        # dK/dV: S, dP, dV, dK; q, k, v, dO, lse, delta in, dk, dv out.
        "flash_bwd_dkv": (8 * pairs * d, 2 * panel_q + 4 * panel_k
                          + 2 * rows),
        # dQ: S, dP, dQ; q, k, v, dO, lse, delta in, dq out.
        "flash_bwd_dq": (6 * pairs * d, 3 * panel_q + 2 * panel_k
                         + 2 * rows),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def kernel_phase(torch, fa, device):
    failures = []
    checks = [  # (b, h, sq, skv, d, dtype, causal)
        (*SLICE_SHAPE[:3], SLICE_SHAPE[2], SLICE_SHAPE[3], torch.bfloat16,
         True),
        (2, 2, 130, 200, 64, torch.float32, True),
        (2, 2, 130, 200, 64, torch.float32, False),
        (1, 2, 130, 130, 16, torch.float32, True),
        (1, 2, 130, 130, 32, torch.float32, True),
        (1, 2, 130, 130, 128, torch.float32, True),
        (1, 2, 100, 100, 128, torch.bfloat16, False),
    ] + [  # the tensor-core kernels at every head dim, ragged, Sq != Skv
        (2, 2, 130, 200, d, torch.bfloat16, causal)
        for d in (16, 32, 64, 128) for causal in (True, False)
    ]
    for kind, (rtol, atol) in TOLS.items():
        print("limit %s: |kernel - plain| <= %.3g |plain| + %.3g rms(row "
              "of plain), printed as error / limit; lse %.0e absolute"
              % (kind, rtol, atol, LSE_TOL))
    slice_abs = {}
    for i, (b, h, sq, skv, d, dtype, causal) in enumerate(checks):
        errs = compare_kernels(torch, fa, b, h, sq, skv, d, dtype, causal,
                               device)
        for name, (parts, ab) in errs.items():
            ok = all(r <= 1.0 for _, r in parts)
            print("check %-14s B=%d H=%d Sq=%d Skv=%d D=%d %s causal=%s: "
                  "error / limit %s %s"
                  % (name, b, h, sq, skv, d, str(dtype)[6:], causal,
                     ", ".join("%s %.3f" % p for p in parts),
                     "ok" if ok else "FAIL"))
            if not ok:
                failures.append(name)
            if i == 0:
                slice_abs[name] = ab
    if failures:
        raise SystemExit("kernel check failed: %s" % sorted(set(failures)))

    b, h, s, d = SLICE_SHAPE
    q, k, v, do = make_inputs(torch, b, h, s, s, d, torch.bfloat16, device,
                              SEED)
    scale = d ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, True, scale)
    # Each dK/dV and dQ element is summed by one block in a fixed order.
    for name, kern in (("flash_bwd_dkv", fa.flash_bwd_dkv),
                       ("flash_bwd_dq", lambda *a: (fa.flash_bwd_dq(*a),))):
        first, second = kern(*bwd), kern(*bwd)
        same = all(torch.equal(x, y) for x, y in zip(first, second))
        print("check %-14s B=%d H=%d S=%d D=%d bf16 causal, two runs: %s"
              % (name, b, h, s, d,
                 "bit-equal ok" if same else "differ FAIL"))
        if not same:
            raise SystemExit("kernel check failed: %s is not "
                             "deterministic" % name)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, True, scale),
                      lambda: fa.flash_fwd_plain(q, k, v, True, scale)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd),
                          lambda: fa.flash_bwd_dkv_plain(*bwd)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd),
                         lambda: fa.flash_bwd_dq_plain(*bwd)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = {"flash_fwd": lambda: sdpa(q, k, v, is_causal=True)}
    bnd = bounds(b, h, s, s, d, 2, True)
    timings = {}
    for name, (kern, plain) in fns.items():
        ms = time_ms(torch, kern, 20)
        plain_ms = time_ms(torch, plain, 5)
        lib_ms = time_ms(torch, library[name], 20) \
            if name in library else None
        timings[name] = (ms, plain_ms, lib_ms)
        print("time %-14s %.4f ms (plain %.4f ms, library %s, bound %.4f "
              "ms by %s) B=%d H=%d S=%d D=%d bf16 causal"
              % (name, ms, plain_ms,
                 "%.4f ms" % lib_ms if lib_ms is not None else "none",
                 bnd[name][0], bnd[name][1], b, h, s, d))
    # SDPA's flash backward computes dQ, dK and dV in one call: it is the
    # yardstick of the two backward kernels together, not of either.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = sdpa(qg, kg, vg, is_causal=True)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        og, (qg, kg, vg), do, retain_graph=True), 20)
    ours = timings["flash_bwd_dkv"][0] + timings["flash_bwd_dq"][0]
    print("time sdpa backward (dQ, dK, dV) %.4f ms against flash_bwd_dkv "
          "+ flash_bwd_dq %.4f ms, B=%d H=%d S=%d D=%d bf16 causal"
          % (sdpa_bwd_ms, ours, b, h, s, d))
    return slice_abs, timings, bnd


# ---------------------------------------------------------------- slice ---


def slice_config(torch, hvd_models, tiny=False):
    """transformer_long: the flagship (vocab 8192, d_model 512, 8 heads,
    4 layers, d_ff 2048) at seq 2048 with flash attention, bf16, batch 4
    (bench.py's long-context cell). ``tiny`` shrinks it for a CPU
    rehearsal."""
    if tiny:
        return hvd_models.TransformerConfig(
            vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_seq_len=64, dtype=torch.float32, attention="flash"), 2, 64
    return hvd_models.TransformerConfig(
        vocab_size=8192, d_model=512, n_heads=8, n_layers=4, d_ff=2048,
        max_seq_len=2048, dtype=torch.bfloat16, attention="flash"), 4, 2048


def run_slice(torch, hvd, hvd_models, fa, device, steps, tiny=False,
              num_experts=0):
    """Train ``steps`` steps on one fixed batch; returns losses, launch
    counts, bucket count, the steady-state step time (ms), the host's
    time to issue one step (ms, no synchronisation inside the step) and
    ``step``, a closure that runs one more step. ``num_experts`` > 0
    puts MoE layers in place of the MLPs."""
    import dataclasses

    cfg, batch, seq = slice_config(torch, hvd_models, tiny)
    cfg = dataclasses.replace(cfg, num_experts=num_experts)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = hvd_models.Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))

    def step():
        loss = hvd_models.lm_loss(model(tokens), tokens)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    cuda = device.startswith("cuda")
    losses, marks, issue = [], [], []
    fa.reset_launches()
    launched0 = opt.buckets_launched
    for _ in range(steps):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        t0 = time.perf_counter()
        losses.append(step())
        issue.append(time.perf_counter() - t0)
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    losses = [float(x) for x in losses]
    warm = 2  # first steps include allocator and cuBLAS warm-up
    step_ms = None
    if cuda:
        step_ms = marks[warm].elapsed_time(marks[-1]) / (steps - warm)
    host_ms = 1e3 * sum(issue[warm:]) / max(steps - warm, 1)
    return dict(cfg=cfg, batch=batch, seq=seq, losses=losses,
                launches=launches, buckets=len(opt.buckets),
                buckets_launched=opt.buckets_launched - launched0,
                step_ms=step_ms, host_ms=host_ms, model=model, step=step)


# (family, substring of the lowercased kernel name), first match wins:
# the convolution keys come before the matmul ones, since cuDNN's
# implicit-GEMM convolutions also carry "xmma", "cutlass" or "gemm".
KERNEL_FAMILIES = (("fusion", "fusionkernel"),
                   ("flash_fwd", "fwd_kernel"),
                   ("flash_fwd", "fwd_mma_kernel"),
                   ("flash_bwd_dkv", "dkv_kernel"),
                   ("flash_bwd_dkv", "dkv_mma_kernel"),
                   ("flash_bwd_dq", "dq_kernel"),
                   ("flash_bwd_dq", "dq_mma_kernel"), ("nccl", "nccl"),
                   ("conv", "fprop"), ("conv", "dgrad"), ("conv", "wgrad"),
                   ("conv", "conv"), ("conv", "winograd"),
                   ("batch_norm", "batch_norm"), ("batch_norm", "batchnorm"),
                   ("batch_norm", "bn_fw"), ("batch_norm", "bn_bw"),
                   ("optimizer", "multi_tensor"),
                   ("matmul", "gemm"), ("matmul", "nvjet"),
                   ("matmul", "cutlass"), ("matmul", "xmma"),
                   ("elementwise", "elementwise"),
                   ("elementwise", "reduce_kernel"))


# The kernels a bf16 step must run, by family.
TENSOR_CORE_KERNELS = {"flash_fwd": ["fwd_mma_kernel"],
                       "flash_bwd_dkv": ["dkv_mma_kernel"],
                       "flash_bwd_dq": ["dq_mma_kernel"]}
HOST_OPS = 8  # host-side ops listed by self CPU time
TOP_KERNELS = 12  # kernels of the ResNet step listed by device time


def device_breakdown(torch, step, n):
    """Over ``n`` steps under torch.profiler: kernel time per step by
    family, the kernels seen in each family, the device's busy time per
    step (the union of the kernels' spans), the step time of the same
    profiled steps (CUDA events), so busy / step is the busy share of one
    window, the ``HOST_OPS`` host-side ops with the most self CPU time
    as (name, calls per step, ms per step), with all host ops' self CPU ms
    per step, and the ms per step of each kernel by name. None when the
    profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            step()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end) / n
    spans, by_family, seen, by_kernel = [], {}, {}, {}
    for ev in prof.events():
        # Device-side copies of user annotations (Optimizer.step...)
        # span many kernels: they are not kernels.
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        name = ev.name.lower()
        fam, key = next(((f, key) for f, key in KERNEL_FAMILIES
                         if key in name), ("other", None))
        by_family[fam] = by_family.get(fam, 0.0) + (end - start) / 1e3 / n
        by_kernel[(fam, ev.name)] = by_kernel.get((fam, ev.name), 0.0) \
            + (end - start) / 1e3 / n
        if key and fam.startswith("flash"):
            seen.setdefault(fam, set()).add(key)
    if not spans:
        return None
    host = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CPU]
    host_ms = sum(ev.self_cpu_time_total for ev in host) / 1e3 / n
    top = [(ev.key, ev.count / n, ev.self_cpu_time_total / 1e3 / n)
           for ev in sorted(host, key=lambda ev: -ev.self_cpu_time_total)
           [:HOST_OPS]]
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return (by_family, seen, busy / 1e3 / n, window_ms, top, host_ms,
            by_kernel)


def flash_matches_dense(torch, hvd_models, model, device, tiny=False):
    """The slice's weights in fp32 on a short input, flash vs dense
    attention (the repo's own reference for the attention path): max
    relative error of the logits and of every parameter's loss gradient,
    and whether the flash logits are finite."""
    import dataclasses

    cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    seq = 16 if tiny else 256
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab_size, (2, seq), generator=gen,
                           device=device)
    logits, grads = {}, {}
    for attn in ("flash", "dense"):
        m = hvd_models.Transformer(dataclasses.replace(cfg, attention=attn),
                                   device=device)
        m.load_state_dict(model.state_dict())
        logits[attn] = m(tokens)
        hvd_models.lm_loss(logits[attn], tokens).backward()
        grads[attn] = {n: p.grad for n, p in m.named_parameters()}
    grad_rel = max(_rel(grads["flash"][n], grads["dense"][n])
                   for n in grads["dense"])
    return (_rel(logits["flash"].detach(), logits["dense"].detach()),
            grad_rel, bool(torch.isfinite(logits["flash"]).all()))


# --------------------------------------------------------------- resnet ---


def resnet_fwd_flops(torch, model, px, device):
    """Forward FLOPs of one image counted on the layer shapes: 2 k² C_in
    C_out H_out W_out for each convolution and 2 in out for the dense
    layer (a multiply-add is 2 FLOPs), read off one eval-mode forward."""
    from horovod_tpu_torch.models.resnet import Conv

    counts = []

    def conv_hook(mod, inp, out):
        counts.append(2 * mod.weight[0].numel() * out[0].numel())

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, Conv)]
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(1, 3, px, px, device=device))
    finally:
        model.train()
        for h in hooks:
            h.remove()
    return sum(counts) + 2 * model.dense.weight.numel()


def resnet_config(torch, hvd_models, device, tiny=False):
    """resnet50: bench.py's ResNet workload (ResNet-50 v1.5, 1000 classes,
    batch 128 at 224px, bf16). ``tiny`` shrinks it for a CPU rehearsal.
    Returns (model, batch, px, classes)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    if tiny:
        return hvd_models.ResNet(
            [1, 1, 1, 1], num_filters=8, num_classes=10,
            dtype=torch.float32, device=device, generator=gen), 4, 32, 10
    return hvd_models.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                               device=device, generator=gen), 128, 224, 1000


def run_resnet(torch, hvd, hvd_models, device, steps, tiny=False):
    """A user's Horovod ResNet script: broadcast rank 0's weights and
    optimizer state, wrap SGD in ``DistributedOptimizer`` and train
    ``steps`` steps on one fixed batch of random images. Returns what
    ``run_slice`` returns, plus the model's forward FLOPs per image."""
    F = torch.nn.functional
    model, batch, px, classes = resnet_config(torch, hvd_models, device,
                                              tiny)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    images = torch.randn(batch, 3, px, px, generator=gen, device=device).to(
        model.dtype).contiguous(memory_format=torch.channels_last)
    labels = torch.randint(0, classes, (batch,), generator=gen,
                           device=device)
    inner = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(inner, root_rank=0)
    opt = hvd.DistributedOptimizer(inner)
    model.train()

    def step():
        loss = F.cross_entropy(model(images), labels)
        loss.backward()
        opt.step()
        opt.zero_grad()
        return loss.detach()

    cuda = device.startswith("cuda")
    losses, marks, issue = [], [], []
    launched0 = opt.buckets_launched
    for _ in range(steps):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        t0 = time.perf_counter()
        losses.append(step())
        issue.append(time.perf_counter() - t0)
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    warm = 2  # first steps include cuDNN's algorithm search
    step_ms = None
    if cuda:
        step_ms = marks[warm].elapsed_time(marks[-1]) / (steps - warm)
    host_ms = 1e3 * sum(issue[warm:]) / max(steps - warm, 1)
    return dict(batch=batch, px=px, losses=[float(x) for x in losses],
                buckets=len(opt.buckets),
                buckets_launched=opt.buckets_launched - launched0,
                step_ms=step_ms, host_ms=host_ms, step=step,
                fwd_flops=resnet_fwd_flops(torch, model, px, device))


def _worst(got, want) -> float:
    """Largest ``|got - want|`` over a tensor, as a fraction of want's
    largest magnitude; the worst over a dict of tensors."""
    if isinstance(want, dict):
        return max(_worst(got[k], want[k]) for k in want)
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


def resnet_train_step(torch, hvd_models, state, images, labels, device,
                      sync_bn=False):
    """One train-mode forward, backward and SGD(0.05, momentum 0.9) step
    of the reduced ResNet (bottleneck, one block a stage, 16 filters, 100
    classes, fp32) from ``state`` on ``device``: its logits, gradients,
    running statistics and updated weights, on the CPU."""
    F = torch.nn.functional
    m = hvd_models.ResNet([1, 1, 1, 1], num_filters=16, num_classes=100,
                          dtype=torch.float32, sync_bn=sync_bn,
                          device=device)
    m.load_state_dict(state)
    m.train()
    opt = torch.optim.SGD(m.parameters(), lr=0.05, momentum=0.9)
    logits = m(images.to(device))
    F.cross_entropy(logits, labels.to(device)).backward()
    grads = {n: p.grad.cpu() for n, p in m.named_parameters()}
    opt.step()
    return dict(logits=logits.detach().cpu(), grads=grads,
                stats={n: b.cpu() for n, b in m.named_buffers()},
                params={n: p.detach().cpu() for n, p in m.named_parameters()})


def resnet_checks(torch, hvd_models, device):
    """The reduced ResNet on the card against the same step on the CPU,
    and with ``SyncBatchNorm`` against the plain batch norm on the card,
    batch 4 at 64px from seed ``SEED + 2``: for each output, its worst
    error as a fraction of the largest magnitude (``_worst``)."""
    gen = torch.Generator().manual_seed(SEED + 2)
    ref = hvd_models.ResNet([1, 1, 1, 1], num_filters=16, num_classes=100,
                            dtype=torch.float32, device="cpu",
                            generator=gen)
    images = torch.randn(4, 3, 64, 64, generator=gen)
    labels = torch.randint(0, 100, (4,), generator=gen)
    state = ref.state_dict()
    cpu = resnet_train_step(torch, hvd_models, state, images, labels, "cpu")
    card = resnet_train_step(torch, hvd_models, state, images, labels,
                             device)
    sync = resnet_train_step(torch, hvd_models, state, images, labels,
                             device, sync_bn=True)
    return ({k: _worst(card[k], cpu[k]) for k in cpu},
            {k: _worst(sync[k], card[k]) for k in card})


def resnet_phase(torch, hvd, hvd_models, fa, device, card, errors):
    """Train resnet50 and print its lines; append failures to
    ``errors``."""
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    # cuDNN times its algorithms on the first steps and keeps the
    # fastest, for the timed and the profiled steps alike.
    torch.backends.cudnn.benchmark = True
    try:
        res = run_resnet(torch, hvd, hvd_models, device, RESNET_STEPS)
        launches = {f.__name__: f.launches for f in fa.KERNELS}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        breakdown = device_breakdown(torch, res["step"], 2)
    finally:
        torch.backends.cudnn.benchmark = False
    losses = res["losses"]
    img_s = res["batch"] / (res["step_ms"] / 1e3)
    fwd = res["fwd_flops"]
    mfu = img_s * 3 * fwd / PEAK_FLOPS["bf16"]
    print("resnet: resnet50 B=%d %dpx bf16 channels_last, losses %s"
          % (res["batch"], res["px"], " ".join("%.4f" % x for x in losses)))
    print("resnet: step %.3f ms, %.1f images/s, %d buckets, %d bucket "
          "allreduces (NCCL) in %d steps, on %s"
          % (res["step_ms"], img_s, res["buckets"], res["buckets_launched"],
             RESNET_STEPS, card))
    print("resnet: the host took %.3f ms to issue one step (steps 3-%d)"
          % (res["host_ms"], RESNET_STEPS))
    print("resnet: forward FLOPs per image from the layer shapes %.4g "
          "(bench.py's figure %.3g is multiply-adds); a step counts 3x the "
          "forward; MFU %.4f of %.0f TFLOP/s bf16 dense on the shape count"
          % (fwd, BENCH_RESNET50_FWD, mfu, PEAK_FLOPS["bf16"] / 1e12))
    print("resnet: peak memory allocated %.3f GB; flash kernels launched "
          "%s (none is on this path)" % (peak_gb, launches))
    if not all(math.isfinite(x) for x in losses):
        errors.append("resnet: non-finite loss %s" % losses)
    print("check resnet loss falls: first %.4f, last %.4f: %s"
          % (losses[0], losses[-1], "ok" if losses[-1] < losses[0]
             else "FAIL"))
    if not losses[-1] < losses[0]:
        errors.append("resnet: loss did not fall: %s" % losses)
    want = res["buckets"] * RESNET_STEPS
    print("check resnet bucket allreduces: %d, want buckets x steps = %d: %s"
          % (res["buckets_launched"], want,
             "ok" if res["buckets_launched"] == want else "FAIL"))
    if res["buckets"] <= 0 or res["buckets_launched"] != want:
        errors.append("resnet: buckets %d, launched %d" % (
            res["buckets"], res["buckets_launched"]))
    if breakdown is None:
        print("resnet: device breakdown not measured (the profiler saw no "
              "device activity)")
    else:
        by_family, _, busy_ms, window_ms, top, host_ms, by_kernel = \
            breakdown
        print("resnet: kernel ms per step by family (torch.profiler, 2 "
              "steps): %s; kernels busy %.3f ms of the profiled step of "
              "%.3f ms = %.1f%%, on %s"
              % (", ".join("%s %.3f" % kv for kv in sorted(
                  by_family.items(), key=lambda kv: -kv[1])),
                 busy_ms, window_ms, 100 * busy_ms / window_ms, card))
        print("resnet: host ops by self CPU ms per step (torch.profiler, 2 "
              "steps; all host ops %.3f ms): %s"
              % (host_ms, "; ".join("%s x%g %.3f" % row for row in top)))
        heavy = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
        print("resnet: kernels by ms per step: %s" % "; ".join(
            "[%s] %s %.3f" % (fam, name[:90], ms)
            for (fam, name), ms in heavy))
    card_err, sync_err = resnet_checks(torch, hvd_models, device)
    for what, errs, tol in (
            ("card vs CPU (reduced ResNet, fp32, TF32 off)", card_err,
             CARD_VS_CPU_TOL),
            ("SyncBatchNorm vs BatchNorm at size 1 (card, fp32)", sync_err,
             SYNC_BN_TOL)):
        ok = all(e <= tol for e in errs.values())
        print("check resnet %s: worst error / largest magnitude %s "
              "(limit %.0e): %s"
              % (what, ", ".join("%s %.3e" % kv for kv in errs.items()),
                 tol, "ok" if ok else "FAIL"))
        if not ok:
            errors.append("resnet: %s: %s" % (what, errs))


# ---------------------------------------------------------------- eager ---

EAGER_STEPS = 10
EAGER_WARM = 2
# Segment sizes of the kernel checks, laid out from element 3 on, so no
# segment starts on a 16-byte boundary, then an absent entry (zeros).
FUSION_SIZES = (1, 7, 4097, 1 << 20)
FUSION_FACTORS = (1.0, 0.5, 1.0 / 3.0, 3.0)
FUSION_DTYPES = ("uint8", "int8", "int32", "int64", "float16", "float32",
                 "float64", "bool", "bfloat16")
# The eager loop against the bucketed loop, step by step: at size 1 both
# apply the same SGD update to the same gradients. Set from repeated runs
# on the H100, where the two agreed at every step to 4 decimals and a
# step's loss moved by 1e-4 from run to run (cuDNN's benchmark picks).
EAGER_AB_LOSS_TOL = 2e-3
# A reduced gradient against torch.autograd.grad of the same loss, with
# deterministic cuDNN in fp32: worst |error| over the largest |value|. A
# swapped or shifted segment errs by order 1.
EAGER_GRAD_TOL = 1e-4


def _bytes(t):
    """A tensor's raw bytes on the CPU, for bit-for-bit comparisons."""
    import torch

    return t.detach().contiguous().reshape(-1).cpu().view(torch.uint8)


def fusion_values(torch, dtype, n, gen):
    """``n`` values of ``dtype`` from ``gen`` on the CPU: integers in
    [-300, 300] clipped to the dtype (so scaling makes halves and wraps
    around), floats N(0, 50^2)."""
    if dtype == torch.bool:
        return torch.randint(0, 2, (n,), generator=gen,
                             dtype=torch.uint8).view(torch.bool)
    if dtype.is_floating_point:
        return (torch.randn(n, generator=gen, dtype=torch.float64)
                * 50.0).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -300), min(info.max, 300) + 1, (n,),
                         generator=gen, dtype=torch.int64).to(dtype)


def _same_bits(got, want):
    """Whether two tensors on one device are equal bit for bit."""
    import torch

    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.reshape(-1).view(torch.uint8),
                            want.reshape(-1).view(torch.uint8)))


def _held(worst, name, got, want):
    """Whether ``got`` equals ``want`` bit for bit; keeps the largest
    |got - want| of kernel ``name`` in ``worst`` (in float64)."""
    want = want.to(got.device)
    if got.numel():
        err = float((got.double() - want.double()).abs().max())
        worst[name] = max(worst[name], err)
    return _same_bits(got, want)


def fusion_checks(torch, fusion, device):
    """fusion_pack and fusion_unpack against their plain versions, bit for
    bit, for every dtype and factor of ``FUSION_*``. Returns the failures,
    the number of comparisons and the largest |kernel - plain| of each
    kernel (in float64)."""
    gen = torch.Generator().manual_seed(SEED + 3)
    counts = list(FUSION_SIZES) + [5]
    offsets = [3 + off for off in fusion.offsets_of(counts)]
    total = offsets[-1] + counts[-1]
    failures, compared = [], 0
    worst = {"fusion_pack": 0.0, "fusion_unpack": 0.0}

    for dname in FUSION_DTYPES:
        dt = getattr(torch, dname)
        segs = [fusion_values(torch, dt, c, gen) for c in FUSION_SIZES]
        segs.append(None)
        card = [s.to(device) if s is not None else None for s in segs]
        for factor in FUSION_FACTORS:
            buf = torch.ones(total, dtype=dt, device=device)
            ref = torch.ones(total, dtype=dt)
            fusion.pack(buf, card, counts, offsets, factor)
            fusion.pack(ref, segs, counts, offsets, factor)
            outs = [torch.empty_like(s) for s in card[:-1]] + [None]
            refs = [torch.empty_like(s) for s in segs[:-1]] + [None]
            fusion.unpack(ref.to(device), outs, counts, offsets, factor)
            fusion.unpack(ref, refs, counts, offsets, factor)
            compared += 2
            if not _held(worst, "fusion_pack", buf, ref):
                failures.append("fusion_pack %s factor %r" % (dname, factor))
            if not all(_held(worst, "fusion_unpack", o, r)
                       for o, r in zip(outs[:-1], refs[:-1])):
                failures.append("fusion_unpack %s factor %r"
                                % (dname, factor))
    return failures, compared, worst


def fusion_times(torch, fusion, params, device):
    """Both kernels on one response holding every gradient of the model
    (fp32, factor 1.0, as the main path's responses): the kernel alone over
    a table built once (CUDA events), the wrapper with its table, the
    plain versions on the same card tensors, and the library calls,
    ``torch.cat`` of the same tensors for the pack and
    ``torch._foreach_copy_`` of the split buffer for the unpack. Kernels
    and library calls take the median of 5 rounds of 50 launches. The bound
    is the bytes read and written over the card's memory rate. Then the
    wrapper against the plain version on these card tensors, bit for bit,
    at factors 1 and 1/3: this layout is the main path's widest (161
    segments, the largest grid). Returns the times, the failures and the
    largest |kernel - plain| of each kernel."""
    grads = [torch.randn(p.numel(), device=device) for p in params]
    counts = [g.numel() for g in grads]
    offsets = fusion.offsets_of(counts)
    total = sum(counts)
    buf = torch.empty(total, device=device)
    outs = [torch.empty_like(g) for g in grads]
    t_pack = fusion.table(buf, grads, counts, offsets)
    t_unpack = fusion.table(buf, outs, counts, offsets)
    bound = 2 * total * 4 / PEAK_BYTES * 1e3
    splits = list(buf.split(counts))
    out = {}
    for name, kern, wrapper, plain, library in (
            ("fusion_pack",
             lambda: fusion.launch("fusion_pack", t_pack, buf, total, 1.0),
             lambda: fusion.pack(buf, grads, counts, offsets),
             lambda: fusion.plain_pack(buf, grads, counts, offsets, 1.0),
             lambda: torch.cat(grads)),
            ("fusion_unpack",
             lambda: fusion.launch("fusion_unpack", t_unpack, buf, total,
                                   1.0),
             lambda: fusion.unpack(buf, outs, counts, offsets),
             lambda: fusion.plain_unpack(buf, outs, offsets, 1.0),
             lambda: torch._foreach_copy_(outs, splits))):
        out[name] = dict(ms=median_ms(torch, kern),
                         wrapper_ms=time_ms(torch, wrapper, 20),
                         plain_ms=time_ms(torch, plain, 5),
                         library_ms=median_ms(torch, library),
                         bound_ms=bound, tensors=len(grads), elems=total)
    failures = []
    worst = {"fusion_pack": 0.0, "fusion_unpack": 0.0}
    for factor in (1.0, 1.0 / 3.0):
        fusion.pack(buf, grads, counts, offsets, factor)
        want = torch.empty_like(buf)
        fusion.plain_pack(want, grads, counts, offsets, factor)
        if not _held(worst, "fusion_pack", buf, want):
            failures.append("fusion_pack of all %d gradients, factor %r"
                            % (len(grads), factor))
        fusion.unpack(buf, outs, counts, offsets, factor)
        wants = [torch.empty_like(g) for g in grads]
        fusion.plain_unpack(buf, wants, offsets, factor)
        if not all(_held(worst, "fusion_unpack", o, w)
                   for o, w in zip(outs, wants)):
            failures.append("fusion_unpack of all %d gradients, factor %r"
                            % (len(grads), factor))
    return out, failures, worst


def eager_step_check(torch, fusion, res):
    """One more step of the eager loop, with deterministic cuDNN and no
    TF32, held against plain PyTorch on the same card tensors:

    * every fusion_pack and fusion_unpack call of the step, at the layouts
      of the main path's own responses and on their data, against
      plain_pack and plain_unpack on copies of its inputs, bit for bit;
    * every reduced gradient against ``torch.autograd.grad`` of the same
      loss (no hooks; the reduction is the identity at size 1), as the
      worst |error| over the gradient's largest |value|;
    * every parameter against a plain SGD(0.01) step on copies of the old
      parameters with the same reduced gradients, bit for bit: it differs
      if the step read a gradient before the executor had written it.

    Returns the failures, the kernel calls and the segments compared, the
    largest |kernel - plain| of each kernel and the worst gradient
    error."""
    F = torch.nn.functional
    model, data, target = res["model"], res["data"], res["target"]
    params = res["params"]
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32
    pack, unpack = fusion.pack, fusion.unpack
    calls = []

    def copies(segs):
        return [None if s is None else s.clone() for s in segs]

    # Called on the core's thread, inside the executor's stream: the
    # copies are ordered after the kernel's inputs and outputs.
    def recorded_pack(buf, segs, counts, offsets, factor=1.0):
        inputs = copies(segs)
        pack(buf, segs, counts, offsets, factor)
        calls.append(("fusion_pack", buf[:offsets[-1] + counts[-1]].clone(),
                      inputs, counts, offsets, factor))

    def recorded_unpack(buf, segs, counts, offsets, factor=1.0):
        src = buf[:offsets[-1] + counts[-1]].clone()
        unpack(buf, segs, counts, offsets, factor)
        calls.append(("fusion_unpack", src, copies(segs), counts, offsets,
                      factor))

    try:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = \
            True, False, False
        want_grads = torch.autograd.grad(
            F.cross_entropy(model(data), target), params)
        old = [p.detach().clone().requires_grad_() for p in params]
        fusion.pack, fusion.unpack = recorded_pack, recorded_unpack
        try:
            res["step"]()
        finally:
            fusion.pack, fusion.unpack = pack, unpack
        if data.is_cuda:
            torch.cuda.synchronize()
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32 = saved
    failures, segments = [], 0
    worst = {"fusion_pack": 0.0, "fusion_unpack": 0.0}
    for kind, src, segs, counts, offsets, factor in calls:
        segments += len(counts)
        if kind == "fusion_pack":
            want = torch.empty_like(src)
            fusion.plain_pack(want, segs, counts, offsets, factor)
            ok = _held(worst, kind, src, want)
        else:
            wants = [None if s is None else torch.empty_like(s) for s in segs]
            fusion.plain_unpack(src, wants, offsets, factor)
            ok = all(_held(worst, kind, s, w) for s, w in zip(segs, wants)
                     if s is not None)
        if not ok:
            failures.append("%s of a response of %d segments"
                            % (kind, len(counts)))
    ran = sorted({c[0] for c in calls})
    if ran != ["fusion_pack", "fusion_unpack"]:
        failures.append("the step ran %s, not both fusion kernels" % ran)
    grad_err = 0.0
    for p, w in zip(params, want_grads):
        err = float((p.grad - w).abs().max()) / (float(w.abs().max()) or 1.0)
        grad_err = max(grad_err, err)
    if not grad_err <= EAGER_GRAD_TOL:
        failures.append("reduced gradients differ from autograd.grad by "
                        "%.3e" % grad_err)
    for q, p in zip(old, params):
        q.grad = p.grad.detach().clone()
    torch.optim.SGD(old, lr=0.01).step()
    moved = sum(not _same_bits(p.detach(), q.detach())
                for p, q in zip(params, old))
    if moved:
        failures.append("%d of %d parameters differ from a plain SGD step "
                        "on the same gradients" % (moved, len(params)))
    return failures, len(calls), segments, worst, grad_err


def eager_collective_checks(torch, eager, device):
    """Each eager op on card tensors, through the core and the device plane
    at size 1, against ``LocalBackend`` on the same values on the CPU, bit
    for bit. Returns the failures and the number of comparisons."""
    from horovod_tpu_torch.common.process_sets import global_process_set
    from horovod_tpu_torch.ops.collective_ops import (
        Adasum, Average, Max, Min, Product, Sum)

    gen = torch.Generator().manual_seed(SEED + 4)
    local = eager.LocalBackend()
    gps = global_process_set
    failures, compared = [], 0

    def check(what, got, want):
        nonlocal compared
        compared += 1
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        if not all(g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape)
                   and torch.equal(_bytes(g), _bytes(w))
                   for g, w in zip(got, want)):
            failures.append(what)

    for dname in FUSION_DTYPES:
        dt = getattr(torch, dname)
        x = fusion_values(torch, dt, 17 * 241, gen).reshape(17, 241)
        xs = [fusion_values(torch, dt, n, gen) for n in (5, 4097, 1)]
        # At size 1 Adasum is ScaleBuffer, to fp64 and back: the identity
        # between the scalings, as LocalBackend has it.
        ops = (Sum, Average, Min, Max, Product) + (
            (Adasum,) if dt.is_floating_point else ())
        for op in ops:
            for pre, post in ((1.0, 1.0), (0.5, 3.0), (1.0 / 3.0, 1.0)):
                tag = "%s.%d.%r.%r" % (dname, op, pre, post)
                check("allreduce " + tag, eager.allreduce(
                    x.to(device), name="ck.ar." + tag, op=op,
                    prescale_factor=pre, postscale_factor=post),
                    local.allreduce_async([x], None, op, pre, post,
                                          gps).result()[0])
            # A group: the core fuses it into one response (pack, NCCL,
            # unpack).
            check("grouped_allreduce %s.%d" % (dname, op),
                  eager.grouped_allreduce(
                      [t.to(device) for t in xs], name="ck.gr.%s.%d"
                      % (dname, op), op=op, prescale_factor=0.5,
                      postscale_factor=1.0 / 3.0),
                  local.allreduce_async(xs, None, op, 0.5, 1.0 / 3.0,
                                        gps).result())
        check("allgather " + dname, eager.allgather(
            x.to(device), name="ck.ag." + dname),
            local.allgather_async([x], None, gps).result()[0])
        check("broadcast " + dname, eager.broadcast(
            x.to(device), 0, name="ck.bc." + dname),
            local.broadcast_async([x], None, 0, gps).result()[0])
        for splits in (None, [17]):
            got = eager.alltoall(x.to(device), splits,
                                 name="ck.a2a.%s.%s" % (dname, splits))
            check("alltoall %s splits %s" % (dname, splits), list(got),
                  list(local.alltoall_async(x, splits, gps, None).result()))
        for op in (Sum, Average):
            check("reducescatter %s.%d" % (dname, op), eager.reducescatter(
                x.to(device), op=op, name="ck.rs.%s.%d" % (dname, op)),
                local.reducescatter_async([x], None, op, gps).result()[0])
    eager.barrier()
    compared += 1
    if eager.join() != 0:
        failures.append("join at size 1 returned another rank than 0")
    compared += 1
    return failures, compared


def eager_model(torch, hvd_models, device, tiny=False):
    """The example's model: resnet50 (ResNet-50 v1.5, 1000 classes) in
    fp32 from seed ``SEED``; batch 32 at 224px. ``tiny`` shrinks it for a
    CPU rehearsal. Returns (model, batch, px, classes)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    if tiny:
        return hvd_models.ResNet([1, 1, 1, 1], num_filters=8,
                                 num_classes=10, dtype=torch.float32,
                                 device=device, generator=gen), 4, 32, 10
    return hvd_models.ResNet50(num_classes=1000, dtype=torch.float32,
                               device=device, generator=gen), 32, 224, 1000


def run_eager(torch, hvd_t, hvd_models, device, steps, bucketed=None,
              tiny=False, op=None):
    """The loop of examples/pytorch/pytorch_synthetic_benchmark.py:45-75
    on the port's negotiated eager path (``horovod_tpu_torch.torch``): the
    named ``DistributedOptimizer`` on the process set [0], whose hooks
    send every gradient through the core at size 1 as at any size, then
    ``broadcast_parameters`` and ``broadcast_optimizer_state``, then
    ``steps`` steps of SGD(0.01) on one batch of random data. With
    ``bucketed`` (the top-level package), the same loop on its bucketed
    in-graph optimizer instead, for the A/B line. ``op`` (default Average)
    is the named optimizer's op: under Adasum it is the delta optimizer,
    whose deltas take the device plane's Adasum. Returns the
    losses, step and host ms, the core's and the executor's counts over
    the steps, the kernel launches, ``step`` and its model and batch."""
    from horovod_tpu_torch.ops import fusion

    F = torch.nn.functional
    model, batch, px, classes = eager_model(torch, hvd_models, device, tiny)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    data = torch.randn(batch, 3, px, px, generator=gen, device=device)
    target = torch.randint(0, classes, (batch,), generator=gen,
                           device=device)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01)
    if bucketed is None:
        ps = hvd_t.global_process_set
        if hvd_t.size() == 1:  # the set [0], registered by an earlier loop
            ps = next((hvd_t.get_process_set(i)
                       for i in hvd_t.get_process_set_ids()
                       if i and hvd_t.get_process_set(i).ranks == [0]),
                      None) or hvd_t.add_process_set([0])
        optimizer = hvd_t.DistributedOptimizer(
            optimizer, named_parameters=model.named_parameters(),
            process_set=ps, op=hvd_t.Average if op is None else op)
        hvd_t.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd_t.broadcast_optimizer_state(optimizer, root_rank=0)
    else:
        bucketed.broadcast_parameters(model.state_dict(), root_rank=0)
        bucketed.broadcast_optimizer_state(optimizer, root_rank=0)
        optimizer = bucketed.DistributedOptimizer(optimizer)

    def step():
        optimizer.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    core = hvd_t.core_session()
    cuda = device.startswith("cuda")
    for name in fusion.LAUNCHES:
        fusion.LAUNCHES[name] = 0
    before, plane0 = core.counters(), core.plane.responses
    losses, marks, issue = [], [], []
    for _ in range(steps):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        t0 = time.perf_counter()
        losses.append(step())
        issue.append(time.perf_counter() - t0)
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
        torch.cuda.synchronize()
    after = core.counters()
    step_ms = None
    if cuda:
        step_ms = marks[EAGER_WARM].elapsed_time(marks[-1]) \
            / (steps - EAGER_WARM)
    return dict(
        batch=batch, px=px, losses=[float(x) for x in losses],
        step_ms=step_ms,
        host_ms=1e3 * sum(issue[EAGER_WARM:]) / max(steps - EAGER_WARM, 1),
        params=[p for p in model.parameters() if p.requires_grad],
        counters={k: after[k] - before[k] for k in after},
        plane_responses=core.plane.responses - plane0,
        launches=dict(fusion.LAUNCHES), step=step, model=model, data=data,
        target=target)


def eager_phase(torch, hvd, hvd_models, device, card, errors):
    """The negotiated eager path on the card: the fusion kernels against
    their plain versions, the eager ops at size 1 against LocalBackend,
    then the example's full-width ResNet-50 loop, beside the bucketed
    optimizer's. Prints its lines, appends failures to ``errors`` and
    returns the kernels' entries of the ``kernels`` line."""
    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch.ops import eager, fusion

    fails, compared, worst = fusion_checks(torch, fusion, device)
    print("check eager fusion kernels vs plain, bit for bit: %d "
          "comparisons (9 dtypes x factors %s, segments %s at unaligned "
          "offsets and an absent one): %s"
          % (compared, ", ".join("%.4g" % f for f in FUSION_FACTORS),
             list(FUSION_SIZES), "ok" if not fails else "FAIL %s" % fails))
    errors.extend("eager: %s differs from its plain version" % f
                  for f in fails)
    fails, compared = eager_collective_checks(torch, eager, device)
    print("check eager collectives at size 1 vs LocalBackend, bit for bit "
          "(allreduce x 5 ops x 3 scalings, grouped allreduce, allgather, "
          "broadcast, alltoall, reducescatter, over 9 dtypes; barrier, "
          "join): %d comparisons: %s"
          % (compared, "ok" if not fails else "FAIL %s" % fails))
    errors.extend("eager: %s differs from LocalBackend" % f for f in fails)

    # The torch default for a user's script: cuDNN may use TF32.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    torch.cuda.reset_peak_memory_stats()
    try:
        res = run_eager(torch, hvd_t, hvd_models, device, EAGER_STEPS)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        breakdown = device_breakdown(torch, res["step"], 2)
        step_fails, calls, segments, step_worst, grad_err = \
            eager_step_check(torch, fusion, res)
        ab = run_eager(torch, hvd_t, hvd_models, device, EAGER_STEPS,
                       bucketed=hvd)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
    times, fails, times_worst = fusion_times(torch, fusion, res["params"],
                                             device)
    print("check eager fusion kernels vs plain on all %d gradients of the "
          "model at once (factors 1, 1/3), bit for bit: %s"
          % (len(res["params"]), "ok" if not fails else "FAIL %s" % fails))
    errors.extend("eager: %s differs from its plain version" % f
                  for f in fails)
    print("check eager real step (deterministic cuDNN, fp32): %d fusion "
          "kernel calls at the main path's own layouts (%d segments) vs "
          "plain, bit for bit; reduced gradients vs torch.autograd.grad, "
          "worst error / largest magnitude %.3e (limit %.0e); parameters vs "
          "a plain SGD step on the same gradients, bit for bit: %s"
          % (calls, segments, grad_err, EAGER_GRAD_TOL,
             "ok" if not step_fails else "FAIL %s" % step_fails))
    errors.extend("eager: real step: %s" % f for f in step_fails)
    for name in worst:
        worst[name] = max(worst[name], times_worst[name], step_worst[name])
    n, ctr = EAGER_STEPS, res["counters"]
    losses = res["losses"]
    print("eager: resnet50 fp32 B=%d %dpx (TF32 convolutions), SGD(0.01), "
          "%d steps through horovod_tpu_torch.torch.DistributedOptimizer on "
          "process set [0], losses %s"
          % (res["batch"], res["px"], n, " ".join("%.4f" % x for x in losses)))
    print("eager: step %.3f ms, %.1f images/s; the host took %.3f ms to "
          "issue one step (steps %d-%d), on %s"
          % (res["step_ms"], res["batch"] / res["step_ms"] * 1e3,
             res["host_ms"], EAGER_WARM + 1, n, card))
    print("eager: per step: %s; executor responses %.1f; fusion kernels "
          "launched %s in %d steps; %d parameter tensors"
          % (", ".join("%s %.1f" % (k, ctr[k] / n) for k in (
              "responses", "cached_responses", "fused_tensors",
              "allreduced_tensors", "allreduce_bytes")),
             res["plane_responses"] / n, res["launches"], n,
             len(res["params"])))
    print("eager: peak memory allocated %.3f GB" % peak_gb)
    print("eager A/B: bucketed in-graph DistributedOptimizer, same loop: "
          "step %.3f ms, %.1f images/s, host %.3f ms a step, losses %s"
          % (ab["step_ms"], ab["batch"] / ab["step_ms"] * 1e3, ab["host_ms"],
             " ".join("%.4f" % x for x in ab["losses"])))
    for name, t in times.items():
        print("time %-14s %.4f ms (median of 5 rounds of 50; wrapper with "
              "its table %.4f ms, plain %.4f ms, library %.4f ms (median), "
              "bound %.4f ms by bytes) fp32, %d tensors, %d elements"
              % (name, t["ms"], t["wrapper_ms"], t["plain_ms"],
                 t["library_ms"], t["bound_ms"], t["tensors"], t["elems"]))
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    print("check eager loss falls: first %.4f, last %.4f: %s"
          % (losses[0], losses[-1], "ok" if ok else "FAIL"))
    if not ok:
        errors.append("eager: loss did not fall: %s" % losses)
    gap = max(abs(a - b) for a, b in zip(losses, ab["losses"]))
    ok = gap <= EAGER_AB_LOSS_TOL
    print("check eager losses vs the bucketed loop's, step by step: worst "
          "|difference| %.3e (limit %.0e): %s"
          % (gap, EAGER_AB_LOSS_TOL, "ok" if ok else "FAIL"))
    if not ok:
        errors.append("eager: losses %s, the bucketed loop's %s"
                      % (losses, ab["losses"]))
    want = len(res["params"]) * n
    ok = ctr["allreduced_tensors"] == want
    print("check eager allreduced tensors: %d, want parameter tensors x "
          "steps = %d: %s" % (ctr["allreduced_tensors"], want,
                              "ok" if ok else "FAIL"))
    if not ok:
        errors.append("eager: %d tensors allreduced, want %d"
                      % (ctr["allreduced_tensors"], want))
    ok = res["plane_responses"] == ctr["responses"] > 0
    print("check eager executor ran every response: %d of %d: %s"
          % (res["plane_responses"], ctr["responses"], "ok" if ok
             else "FAIL"))
    if not ok:
        errors.append("eager: the executor ran %d of %d responses"
                      % (res["plane_responses"], ctr["responses"]))
    for name, count in res["launches"].items():
        if count <= 0:
            errors.append("eager: %s never launched in the loop" % name)
    if breakdown is None:
        print("eager: device breakdown not measured (the profiler saw no "
              "device activity)")
        errors.append("eager: the profiler saw no kernel")
    else:
        by_family, _, busy_ms, window_ms, top, host_ms, by_kernel = \
            breakdown
        print("eager: kernel ms per step by family (torch.profiler, 2 "
              "steps): %s; kernels busy %.3f ms of the profiled step of "
              "%.3f ms = %.1f%%, on %s"
              % (", ".join("%s %.3f" % kv for kv in sorted(
                  by_family.items(), key=lambda kv: -kv[1])),
                 busy_ms, window_ms, 100 * busy_ms / window_ms, card))
        print("eager: host ops by self CPU ms per step (torch.profiler, 2 "
              "steps; all host ops %.3f ms): %s"
              % (host_ms, "; ".join("%s x%g %.3f" % row for row in top)))
        seen = {kind: sum(ms for (fam, name), ms in by_kernel.items()
                          if fam == "fusion" and flag in name)
                for kind, flag in (("fusion_pack", "true>"),
                                   ("fusion_unpack", "false>"))}
        ok = all(ms > 0 for ms in seen.values())
        print("check eager profiler saw the fusion kernels in the step: %s "
              "ms per step: %s"
              % (", ".join("%s %.4f" % kv for kv in seen.items()),
                 "ok" if ok else "FAIL"))
        if not ok:
            errors.append("eager: the profiler did not see %s" % seen)
    return [{
        "name": name, "route": "cuda",
        "source": "horovod_tpu_torch/csrc/fusion.cu",
        "replaces": "horovod_tpu/core/src/operations.cc:364",
        "launches": res["launches"][name], "max_abs_err": worst[name],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": t["library_ms"]} for name, t in times.items()], losses


# --------------------------------------------------------------- adasum ---

# Adasum's kernels against their plain versions on every gradient of
# ResNet-50 as a segment: the dots differ from the plain version's only by
# the order of summation, which moves a sum of n products by at most about
# n * 2^-53 of the sum of their magnitudes, 1e-12 at these sizes: per
# segment, |dot| is held to 1e-12 of |a| |b| (its Cauchy-Schwarz bound)
# and each squared norm to 1e-12 of itself. The combine, given the same
# dots, and the conversions are held bit for bit.
ADASUM_DOTS_RTOL = 1e-12
# The plane's tree at 4 members against adasum_reference (float64),
# converted the core's way: at most one unit in the last place.
ADASUM_RANKS = 4
ADASUM_ULPS = 1


def adasum_values(torch, counts, seed, device):
    """Gradient-like fp32 values, N(0, 1) from ``seed``, laid out as the
    segments ``counts``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(sum(counts), generator=gen, device=device)


def adasum_kernel_checks(torch, adasum, counts, device):
    """The three kernels against their plain versions on one response
    holding every gradient (fp64 inside, ``theirs`` from a second seed),
    and two runs of each, bit for bit. Returns the failures, the largest
    |kernel - plain| of each kernel and the worst dots error / limit."""
    segs = adasum.Segments(counts, device)
    failures = []
    worst = dict.fromkeys(adasum.LAUNCHES, 0.0)
    a32 = adasum_values(torch, counts, SEED + 5, device)
    b32 = adasum_values(torch, counts, SEED + 6, device)
    mine = torch.empty(segs.total, dtype=torch.float64, device=device)
    theirs = torch.empty_like(mine)
    adasum.to_double(a32, mine)
    adasum.to_double(b32, theirs)
    for dt in adasum.FLOATS:
        x = a32.to(dt)
        got = torch.empty_like(mine)
        adasum.to_double(x, got)
        ok = _held(worst, "adasum_convert", got, adasum.plain_to_double(x))
        back = torch.empty_like(x)
        adasum.from_double(mine, back)
        ok &= _held(worst, "adasum_convert", back,
                    adasum.plain_from_double(mine, dt))
        if not ok:
            failures.append("adasum_convert %s" % dt)
    dots = adasum.dots(mine, theirs, segs)
    plain = adasum.plain_dots(mine, theirs, segs)
    norms = (plain[:, 1] * plain[:, 2]).sqrt()
    scale = torch.stack([norms, plain[:, 1], plain[:, 2]], 1)
    ratio = float(((dots - plain).abs()
                   / (ADASUM_DOTS_RTOL * scale).clamp(min=1e-300)).max())
    worst["adasum_dots"] = float((dots - plain).abs().max())
    if not ratio <= 1.0:
        failures.append("adasum_dots vs plain: error / limit %.3f" % ratio)
    if not _same_bits(adasum.dots(mine, theirs, segs), dots):
        failures.append("adasum_dots differs between two runs")
    got, want, again = mine.clone(), mine.clone(), mine.clone()
    adasum.combine(got, theirs, dots, segs)
    adasum.plain_combine(want, theirs, dots, segs)
    adasum.combine(again, theirs, dots, segs)
    if not _held(worst, "adasum_combine", got, want):
        failures.append("adasum_combine vs plain on the same dots")
    if not _same_bits(got, again):
        failures.append("adasum_combine differs between two runs")
    torch.cuda.synchronize()
    return failures, worst, ratio


def adasum_tree_check(torch, adasum, counts, dtype, device):
    """The plane's tree (``adasum.tree`` with a copying exchange) at
    ``ADASUM_RANKS`` members, each holding every gradient in ``dtype``
    (member r's scaled by r + 1, every third one negated), converted the
    core's way, against ``adasum_reference`` in float64 per gradient.
    Returns the largest distance in units in the last place and the share
    of elements that are not bit-equal to the reference's."""
    import numpy as np
    from horovod_tpu_torch.parallel.adasum import adasum_reference

    segs = adasum.Segments(counts, device)
    members = []
    for r in range(ADASUM_RANKS):
        x = adasum_values(torch, counts, SEED + 20 + r, device) * (r + 1)
        members.append((-x if r % 3 == 2 else x).to(dtype))
    mines = []
    for x in members:
        mines.append(torch.empty(segs.total, dtype=torch.float64,
                                 device=device))
        adasum.to_double(x, mines[-1])
    merged = torch.empty(segs.total, dtype=dtype, device=device)
    adasum.from_double(adasum.simulated_tree(mines, segs), merged)
    host = [adasum.plain_to_double(x.cpu()).numpy() for x in members]
    want = np.concatenate([
        adasum_reference([h[off:off + c] for h in host])
        for off, c in zip(segs.offsets, segs.counts)])
    want = adasum.plain_from_double(torch.from_numpy(want), dtype)
    dist = adasum.ulp_distance(merged.cpu(), want)
    return int(dist.max()), float((dist > 0).double().mean())


def adasum_times(torch, adasum, counts, device):
    """Each kernel on one response of every gradient (fp32 in, fp64
    inside; CUDA events), its plain version on the same card tensors, a
    PyTorch call for the same function, and the bound by bytes: dots read
    16 B an element, combine reads 16 B and writes 8 B, the conversion
    from fp32 reads 4 B and writes 8 B."""
    segs = adasum.Segments(counts, device)
    n = segs.total
    a32 = adasum_values(torch, counts, SEED + 5, device)
    mine = torch.empty(n, dtype=torch.float64, device=device)
    theirs = torch.empty_like(mine)
    adasum.to_double(a32, mine)
    adasum.to_double(adasum_values(torch, counts, SEED + 6, device), theirs)
    dots = adasum.dots(mine, theirs, segs)
    ca, cb = adasum.coefficients(dots)
    lengths = torch.tensor(counts, device=device)
    ca_full = ca.repeat_interleave(lengths)
    cb_full = cb.repeat_interleave(lengths)
    products = torch.stack([mine * theirs, mine * mine, theirs * theirs], 1)
    out = {}
    scratch = mine.clone()
    out["adasum_dots"] = dict(
        ms=time_ms(torch, lambda: adasum.dots(mine, theirs, segs), 50),
        plain_ms=time_ms(torch, lambda: adasum.plain_dots(mine, theirs,
                                                          segs), 5),
        library_ms=time_ms(torch, lambda: torch.segment_reduce(
            products, "sum", lengths=lengths, axis=0), 20),
        library="torch.segment_reduce(products [n, 3], 'sum', lengths)",
        bound_ms=16 * n / PEAK_BYTES * 1e3)
    out["adasum_combine"] = dict(
        ms=time_ms(torch, lambda: adasum.combine(scratch, theirs, dots,
                                                 segs), 50),
        plain_ms=time_ms(torch, lambda: adasum.plain_combine(
            scratch, theirs, dots, segs), 5),
        library_ms=time_ms(torch, lambda: torch.addcmul(
            ca_full * mine, cb_full, theirs), 20),
        library="torch.addcmul(ca_full * mine, cb_full, theirs)",
        bound_ms=24 * n / PEAK_BYTES * 1e3)
    back = torch.empty_like(a32)
    out["adasum_convert"] = dict(
        ms=time_ms(torch, lambda: adasum.to_double(a32, scratch), 50),
        from_ms=time_ms(torch, lambda: adasum.from_double(mine, back), 50),
        plain_ms=time_ms(torch, lambda: scratch.copy_(
            adasum.plain_to_double(a32)), 5),
        library_ms=time_ms(torch, lambda: scratch.copy_(a32), 20),
        library="scratch.copy_(fp32 tensor)",
        bound_ms=12 * n / PEAK_BYTES * 1e3)
    return out, n


def adasum_phase(torch, hvd_models, device, card, errors, eager_losses,
                 tiny=False):
    """Adasum on the card at the eager cell's width (ResNet-50 v1.5 fp32,
    161 gradients). The main path, with every Adasum launch counter zeroed
    just before and read just after: the eager loop with op=Adasum (the
    delta optimizer on process set [0]: at size 1 a response is pack, to
    fp64, back, unpack) and the plane's tree over 4 members simulated on
    the one card at full width in fp32 (the levels' dots and combine).
    Then the kernels against their plain versions, the tree in fp16 and
    bf16, and the times. Prints its lines, appends failures to ``errors``
    and returns the kernels' entries of the ``kernels`` line. ``tiny``
    shrinks the model for a CPU rehearsal."""
    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch.ops import adasum

    model = eager_model(torch, hvd_models, device, tiny)[0]
    counts = [p.numel() for p in model.parameters() if p.requires_grad]
    del model
    for name in adasum.LAUNCHES:
        adasum.LAUNCHES[name] = 0
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    try:
        res = run_eager(torch, hvd_t, hvd_models, device, EAGER_STEPS,
                        op=hvd_t.Adasum, tiny=tiny)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
    tree = {torch.float32: adasum_tree_check(torch, adasum, counts,
                                             torch.float32, device)}
    torch.cuda.synchronize()
    launches = dict(adasum.LAUNCHES)
    responses = res["plane_responses"]
    print("adasum: resnet50 fp32 B=%d %dpx, SGD(0.01), %d steps through "
          "horovod_tpu_torch.torch.DistributedOptimizer(op=Adasum) on "
          "process set [0]: losses %s; step %s ms, host %.3f ms a step; "
          "executor responses %d; on %s"
          % (res["batch"], res["px"], EAGER_STEPS,
             " ".join("%.4f" % x for x in res["losses"]),
             "%.3f" % res["step_ms"] if res["step_ms"] else "not measured",
             res["host_ms"], responses, card))
    gap = max(abs(a - b) for a, b in zip(res["losses"], eager_losses))
    ok = gap <= EAGER_AB_LOSS_TOL and all(math.isfinite(x)
                                          for x in res["losses"])
    print("check adasum eager losses vs the eager Average loop's (at size "
          "1 both are plain SGD), step by step: worst |difference| %.3e "
          "(limit %.0e): %s" % (gap, EAGER_AB_LOSS_TOL,
                                "ok" if ok else "FAIL"))
    if not ok:
        errors.append("adasum: losses %s, the Average loop's %s"
                      % (res["losses"], eager_losses))
    print("adasum: launches on the main path (eager loop + %d-member tree "
          "of %d gradients, %d elements): %s; per tree level one "
          "adasum_dots (2 kernels) and one adasum_combine"
          % (ADASUM_RANKS, len(counts), sum(counts), launches))
    for name, count in launches.items():
        if count <= 0:
            errors.append("adasum: %s never launched on the main path"
                          % name)
    fails, worst, ratio = adasum_kernel_checks(torch, adasum, counts, device)
    print("check adasum kernels vs plain on all %d gradients (%d elements, "
          "fp64): dots error / limit %.3e (|dot| to %.0e of |a||b|, norms "
          "to %.0e of themselves); combine on the same dots and the four "
          "dtypes' conversions bit for bit; two runs of dots and combine "
          "bit-equal: %s"
          % (len(counts), sum(counts), ratio, ADASUM_DOTS_RTOL,
             ADASUM_DOTS_RTOL, "ok" if not fails else "FAIL %s" % fails))
    errors.extend("adasum: %s" % f for f in fails)
    for dt in (torch.float16, torch.bfloat16):
        tree[dt] = adasum_tree_check(torch, adasum, counts, dt, device)
    for dt, (ulps, share) in tree.items():
        ok = ulps <= ADASUM_ULPS
        print("check adasum tree of %d members vs adasum_reference (float64, "
              "converted the core's way), %s, %d elements: worst %d ulp "
              "(limit %d), %.3e of elements not bit-equal: %s"
              % (ADASUM_RANKS, str(dt)[6:], sum(counts), ulps, ADASUM_ULPS,
                 share, "ok" if ok else "FAIL"))
        if not ok:
            errors.append("adasum: tree %s off by %d ulp" % (dt, ulps))
    times, n = adasum_times(torch, adasum, counts, device)
    for name, t in times.items():
        print("time %-14s %.4f ms%s (plain %.4f ms, library %.4f ms [%s], "
              "bound %.4f ms by bytes) %d elements, %d segments, on %s"
              % (name, t["ms"], " (from fp64 %.4f ms)" % t["from_ms"]
                 if "from_ms" in t else "", t["plain_ms"], t["library_ms"],
                 t["library"], t["bound_ms"], n, len(counts), card))
    source = {"adasum_dots": 197, "adasum_combine": 197,
              "adasum_convert": 145}
    return [{
        "name": name, "route": "cuda",
        "source": "horovod_tpu_torch/csrc/adasum.cu",
        "replaces": "horovod_tpu/core/src/collectives.cc:%d" % source[name],
        "launches": launches[name], "max_abs_err": worst[name],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": t["library_ms"]} for name, t in times.items()]


# ------------------------------------------------------------------ moe ---

# The expert count of the repo's ``moe`` workload (__graft_entry__.py:67-70).
MOE_EXPERTS = 4
MOE_STEPS = 8
# One MoE layer in fp32 (TF32 off), card against CPU. The router's logits
# are exact on both: inputs on a 1/8 grid in [-1, 1], router weights on a
# 1/64 grid in [-1/8, 1/8], so every partial sum of the 512 products is a
# multiple of 1/512 below 2^6, exact in fp32 in any order; a dispatch
# that differs is then the port's fault, not rounding's. The rest is fp32
# GEMMs summed in other orders: 1e-4 of each tensor's largest magnitude.
MOE_LAYER_RTOL = 1e-4


def moe_breakdown(torch, step, n, t, e, c):
    """Kernel ms per step of the MoE step by family, over ``n`` steps
    under torch.profiler with input shapes: the dispatch einsums (their
    GEMMs forward and backward, ``aten::bmm`` of batch 1 with one side T
    and the other E C: ``tec,tm->ecm`` and ``tec,ecm->tm``), the expert
    FFN (``aten::bmm`` batched over the E experts), the three attention
    kernels, and the rest of the kernels; the step time of the same
    window (CUDA events); the ``TOP_KERNELS`` kernels and the
    ``HOST_OPS`` host ops that took the most time. None when the
    profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        start.record()
        for _ in range(n):
            step()
        end.record()
        torch.cuda.synchronize()
    total = attention = 0.0
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
            continue
        ms = (ev.time_range.end - ev.time_range.start) / 1e3 / n
        total += ms
        by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) + ms
        name = ev.name.lower()
        fam = next((f for f, key in KERNEL_FAMILIES if key in name), "")
        if fam.startswith("flash"):
            attention += ms
    if total == 0.0:
        return None
    host = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CPU]
    top_host = [(ev.key, ev.count / n, ev.self_cpu_time_total / 1e3 / n)
                for ev in sorted(host, key=lambda ev: -ev.self_cpu_time_total)
                [:HOST_OPS]]
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[
        :TOP_KERNELS]
    dispatch = ffn = 0.0
    for avg in prof.key_averages(group_by_input_shape=True):
        shapes = [sh for sh in avg.input_shapes[:2] if len(sh) == 3]
        if avg.key != "aten::bmm" or len(shapes) != 2:
            continue
        ms = getattr(avg, "self_device_time_total",
                     getattr(avg, "self_cuda_time_total", 0.0)) / 1e3 / n
        dims = set(shapes[0][1:]) | set(shapes[1][1:])
        if shapes[0][0] == 1 and t in dims and e * c in dims:
            dispatch += ms
        elif shapes[0][0] == e:
            ffn += ms
    return dict(dispatch=dispatch, ffn=ffn, attention=attention,
                rest=total - dispatch - ffn - attention, total=total,
                window_ms=start.elapsed_time(end) / n, top_host=top_host,
                top_kernels=top_kernels)


def moe_layer_check(torch, moe, cfg, batch, seq, device):
    """One ``MoeMlp`` at the step's widths and tokens, fp32, on the card
    and on the CPU from the same weights and inputs: whether the dispatch
    is equal, the worst relative error of the output and of every
    gradient, and the tokens dropped at the capacity."""
    import copy
    import dataclasses

    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED + 2)
    layer = moe.MoeMlp(cfg, gen, "cpu")
    m, t = cfg.d_model, batch * seq
    capacity = max(1, 2 * t // cfg.num_experts)
    with torch.no_grad():
        layer.router.copy_(torch.randint(
            -8, 9, layer.router.shape, generator=gen) / 64.0)
    x = torch.randint(-8, 9, (batch, seq, m), generator=gen) / 8.0
    dout = torch.randn(batch, seq, m, generator=gen)
    res = {}
    for dev in ("cpu", device):
        mod = copy.deepcopy(layer).to(dev)
        xd = x.detach().to(dev).requires_grad_()
        out = mod(xd)
        (out * dout.to(dev)).sum().backward()
        with torch.no_grad():
            dispatch, _ = moe.top1_dispatch(
                xd.reshape(t, m) @ mod.router, capacity)
        res[dev] = ([out.detach(), xd.grad] + [p.grad for p in
                                               mod.parameters()],
                    dispatch)
    same = torch.equal(res["cpu"][1], res[device][1].cpu())
    worst = max(_rel(a.cpu(), b) for a, b in zip(res[device][0],
                                                 res["cpu"][0]))
    dropped = t - int(res["cpu"][1].sum())
    return same, worst, dropped


def moe_phase(torch, hvd, hvd_models, fa, device, card, errors,
              tiny=False):
    """The MoE transformer at transformer_long's widths, ``MOE_EXPERTS``
    experts a layer, trained for ``MOE_STEPS`` steps through the bucketed
    optimizer, with every launch counter zeroed just before and read just
    after; its breakdown; one MoE layer on the card against the CPU.
    ``tiny`` on the CPU rehearses it (no times, no breakdown)."""
    from horovod_tpu_torch.parallel import moe

    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = run_slice(torch, hvd, hvd_models, fa, device, MOE_STEPS, tiny,
                    num_experts=MOE_EXPERTS)
    if not cuda:
        res["step_ms"] = float("nan")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda \
        else float("nan")
    cfg, losses = res["cfg"], res["losses"]
    t = res["batch"] * res["seq"]
    c = max(1, 2 * t // MOE_EXPERTS)
    print("moe: transformer_long with %d experts a layer (T=%d tokens, "
          "capacity %d) B=%d S=%d layers=%d, losses %s"
          % (MOE_EXPERTS, t, c, res["batch"], res["seq"], cfg.n_layers,
             " ".join("%.4f" % x for x in losses)))
    print("moe: step %.3f ms, %.1f tokens/s; the host took %.3f ms to "
          "issue one step (steps 3-%d); peak memory allocated %.3f GB; %d "
          "buckets, %d bucket allreduces; on %s"
          % (res["step_ms"], t / (res["step_ms"] / 1e3), res["host_ms"],
             MOE_STEPS, peak_gb, res["buckets"], res["buckets_launched"],
             card))
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    print("check moe loss falls: first %.4f, last %.4f: %s"
          % (losses[0], losses[-1], "ok" if ok else "FAIL"))
    if not ok:
        errors.append("moe: loss did not fall: %s" % losses)
    ok = res["buckets"] > 0 and \
        res["buckets_launched"] == res["buckets"] * MOE_STEPS
    print("check moe bucket allreduces: %d, want buckets x steps = %d: %s"
          % (res["buckets_launched"], res["buckets"] * MOE_STEPS,
             "ok" if ok else "FAIL"))
    if not ok:
        errors.append("moe: buckets %d, launched %d"
                      % (res["buckets"], res["buckets_launched"]))
    want = cfg.n_layers * MOE_STEPS
    ok = all(n == want for n in res["launches"].values())
    print("check moe attention kernel launches: %s, want %d each (%d a "
          "step): %s" % (res["launches"], want, cfg.n_layers,
                         "ok" if ok else "FAIL"))
    if not ok:
        errors.append("moe: attention launches %s, want %d each"
                      % (res["launches"], want))
    parts = moe_breakdown(torch, res["step"], 2, t, MOE_EXPERTS, c) \
        if cuda else None
    if parts is None:
        print("moe: kernel breakdown not measured (the profiler saw no "
              "device activity)")
    else:
        print("moe: kernel ms per step (torch.profiler, 2 steps): dispatch "
              "einsums %.3f, expert FFN %.3f, attention kernels %.3f, rest "
              "%.3f; all kernels %.3f of the profiled step of %.3f ms, on %s"
              % (parts["dispatch"], parts["ffn"], parts["attention"],
                 parts["rest"], parts["total"], parts["window_ms"], card))
        print("moe: top kernels, ms per step: %s"
              % "; ".join("%s %.3f" % (name[:60], ms)
                          for name, ms in parts["top_kernels"]))
        print("moe: host ops by self CPU ms per step: %s"
              % "; ".join("%s x%g %.3f" % row for row in parts["top_host"]))
    same, worst, dropped = moe_layer_check(torch, moe, cfg, res["batch"],
                                           res["seq"], device)
    ok = same and worst < MOE_LAYER_RTOL
    print("check moe layer card vs CPU (fp32, T=%d, %d tokens dropped): "
          "dispatch equal %s; output and gradients worst rel %.3e (limit "
          "%.0e): %s" % (t, dropped, same, worst, MOE_LAYER_RTOL,
                         "ok" if ok else "FAIL"))
    if not ok:
        errors.append("moe: layer card vs CPU: dispatch equal %s, rel %.3e"
                      % (same, worst))


# ------------------------------------------------------------- sequence ---

SEQ_STEPS = 3
# Ring and Ulysses against flash attention, step by step, bf16: the
# reference's arithmetic rounds q.k to bf16 where the flash kernels keep
# it in fp32, and rounds p to bf16 where the einsums keep it in fp32; a
# loss is a mean over B S positions, so each step's loss is held to
# about one bf16 step (2^-8) of itself.
SEQ_LOSS_RTOL = 5e-3
RING_MEMBERS = 4


def ring_schedule_check(torch, seq_mod, device, dtype, tiny=False):
    """The ring's schedule over ``RING_MEMBERS`` members on one card: the
    port's ``_block_attention`` runs, for each member and in the ring's
    order, over the sequence slices of one causal problem; returns the
    largest error / limit of the merged outputs against full-sequence
    attention (``TOLS``, rows floored at ``ROW_FLOOR``)."""
    b, h, s, d = (2, 4, 64, 16) if tiny else SLICE_SHAPE
    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device,
                           dtype=dtype) for _ in range(3))
    want = seq_mod._dense_attention(q, k, v, True)
    n, sl = RING_MEMBERS, s // RING_MEMBERS
    worst = 0.0
    for idx in range(n):
        mine = slice(idx * sl, (idx + 1) * sl)
        m = torch.full((b, h, sl), seq_mod._NEG, device=device)
        l = torch.zeros((b, h, sl), device=device)
        o = torch.zeros((b, sl, h, d), device=device)
        for step in range(n):
            owner = (idx - step) % n
            blk = slice(owner * sl, (owner + 1) * sl)
            m, l, o = seq_mod._block_attention(
                q[:, mine], k[:, blk], v[:, blk], idx * sl, owner * sl,
                True, m, l, o)
        out = (o / l.transpose(1, 2)[..., None]).to(dtype)
        worst = max(worst, limit_ratio(out, want[:, mine],
                                       *TOLS[str(dtype)[len("torch."):]]))
    return worst


def run_sequence_models(torch, hvd, hvd_models, device, tiny=False):
    """The flash, ring and Ulysses transformers (ring and Ulysses over
    the global set, size 1) from the same weights on the same tokens,
    ``SEQ_STEPS`` steps each through the bucketed optimizer: losses and
    ms per step (CUDA events over every step, or None on the CPU)."""
    import dataclasses

    cfg, batch, seq = slice_config(torch, hvd_models, tiny)
    gen = torch.Generator(device=device).manual_seed(SEED)
    base = hvd_models.Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device)
    out = {}
    for attention in ("flash", "ring", "ulysses"):
        model = hvd_models.Transformer(
            dataclasses.replace(cfg, attention=attention), device=device)
        model.load_state_dict(base.state_dict())
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-3, weight_decay=1e-4))
        cuda = device.startswith("cuda")
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        losses = []
        for _ in range(SEQ_STEPS):
            loss = hvd_models.lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            opt.zero_grad()
            losses.append(loss.detach())
        ms = None
        if cuda:
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / SEQ_STEPS
        out[attention] = ([float(x) for x in losses], ms)
    return out, base


def pipeline_check(torch, pipeline, base, device, tiny=False):
    """``pipeline_apply`` at size 1, its one stage the model's blocks,
    over 4 microbatches of (1, S, d_model), against the blocks run in
    sequence on each: the largest error / limit (``TOLS``)."""
    cfg = base.cfg
    s = 16 if tiny else cfg.max_seq_len
    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    xs = torch.randn(4, 1, s, cfg.d_model, generator=gen, device=device,
                     dtype=cfg.dtype)

    def stage(blocks, x):
        for blk in blocks:
            x = blk(x)
        return x

    with torch.no_grad():
        got = pipeline.pipeline_apply(stage, base.layers, xs)
        want = torch.stack([stage(base.layers, x) for x in xs])
    return limit_ratio(got, want, *TOLS[str(cfg.dtype)[len("torch."):]])


def sequence_phase(torch, hvd, hvd_models, device, card, errors,
                   tiny=False):
    """Ring and Ulysses attention on one card: their transformers at size
    1 against the flash transformer, the ring's 4-member schedule against
    full-sequence attention in bf16 and fp32, and ``pipeline_apply`` at
    size 1 against the sequential stack."""
    from horovod_tpu_torch.parallel import pipeline
    from horovod_tpu_torch.parallel import sequence as seq_mod

    runs, base = run_sequence_models(torch, hvd, hvd_models, device, tiny)
    flash = runs["flash"][0]
    for attention in ("ring", "ulysses"):
        losses, ms = runs[attention]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, flash))
        ok = rel <= SEQ_LOSS_RTOL
        print("check sequence %s transformer at size 1 vs flash, %d steps: "
              "losses %s vs %s, worst rel %.3e (limit %.0e), %s ms a step "
              "(flash %s ms), on %s: %s"
              % (attention, SEQ_STEPS, " ".join("%.4f" % x for x in losses),
                 " ".join("%.4f" % x for x in flash), rel, SEQ_LOSS_RTOL,
                 "%.3f" % ms if ms else "not measured",
                 "%.3f" % runs["flash"][1] if ms else "not measured", card,
                 "ok" if ok else "FAIL"))
        if not ok:
            errors.append("sequence: %s losses %s, flash %s"
                          % (attention, losses, flash))
    for dtype in (torch.bfloat16, torch.float32):
        worst = ring_schedule_check(torch, seq_mod, device, dtype, tiny)
        ok = worst <= 1.0
        print("check sequence ring schedule of %d members vs full-sequence "
              "attention, %s causal: error / limit %.3f: %s"
              % (RING_MEMBERS, str(dtype)[len("torch."):], worst,
                 "ok" if ok else "FAIL"))
        if not ok:
            errors.append("sequence: ring schedule %s, error / limit %.3f"
                          % (dtype, worst))
    worst = pipeline_check(torch, pipeline, base, device, tiny)
    ok = worst <= 1.0
    print("check sequence pipeline_apply at size 1 vs the sequential stack "
          "(%d blocks, 4 microbatches): error / limit %.3f: %s"
          % (base.cfg.n_layers, worst, "ok" if ok else "FAIL"))
    if not ok:
        errors.append("sequence: pipeline_apply error / limit %.3f" % worst)


# -------------------------------------------------------------- elastic ---

ELASTIC_STEPS = 16
ELASTIC_SEQS = 256
ELASTIC_CKPT_INTERVAL = 4
ELASTIC_FAIL_STEP = 6    # this step raises HorovodInternalError
ELASTIC_GROW_STEP = 10   # this step's commit sees rendezvous version 2
ELASTIC_SLOT = "localhost:0"
ELASTIC_HEARTBEAT_SEC = "0.5"
TIMING_ROUNDS = 5


class KVServer:
    """The elastic driver's rendezvous KV store, as the port's client
    speaks to it (GET and PUT ``/<scope>/<key>``), on a local port. It
    keeps every heartbeat it is sent, in order of arrival. Also the KV
    store of tests/torch_port_elastic_cards_driver.py."""

    def __init__(self):
        import http.server
        import threading

        store, beats, lock = {}, [], threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def _key(self):
                return tuple(self.path.strip("/").split("/", 1))

            def _reply(self, status, body=b""):
                self.send_response(status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — the handler's interface
                with lock:
                    value = store.get(self._key())
                self._reply(404) if value is None else self._reply(200,
                                                                   value)

            def do_PUT(self):  # noqa: N802
                value = self.rfile.read(int(self.headers.get(
                    "Content-Length", 0)))
                key = self._key()
                with lock:
                    store[key] = value
                    if key[0] == "heartbeat":
                        beats.append(json.loads(value))
                self._reply(200)

            def log_message(self, *args):
                pass

        self._store, self._beats, self._lock = store, beats, lock
        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                       Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def publish(self, version, slots=(ELASTIC_SLOT,)):
        """A world of ``slots`` (in rank order, one host) at ``version``,
        as the driver publishes one (``horovod_tpu/runner/
        elastic_run.py:295-317``): the slots' assignments first, a removed
        slot's deleted, then the meta, its port negotiated."""
        n = len(slots)
        with self._lock:
            for key in [k for k in self._store if k[0] == "rendezvous"]:
                del self._store[key]
            for rank, slot in enumerate(slots):
                self._store[("rendezvous", slot)] = (
                    "%d,%d,%d,%d,0,1" % (rank, n, rank, n)).encode()
            self._store[("control", "meta")] = json.dumps({
                "version": version, "controller_addr": "127.0.0.1",
                "controller_port": 0, "size": n}).encode()

    def beat_versions(self):
        with self._lock:
            return [b["version"] for b in self._beats]

    def wait_for_beat(self, version, timeout=5.0):
        deadline = time.monotonic() + timeout
        while version not in self.beat_versions() and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        return version in self.beat_versions()

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def elastic_env(port):
    """The worker env of ``elastic_run.py:378-380`` for the one slot."""
    return {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "1",
            "HOROVOD_LOCAL_RANK": "0", "HOROVOD_LOCAL_SIZE": "1",
            "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
            "HOROVOD_CONTROLLER_ADDR": "127.0.0.1",
            "HOROVOD_CONTROLLER_PORT": "0",
            "HOROVOD_RENDEZVOUS_ADDR": "127.0.0.1",
            "HOROVOD_RENDEZVOUS_PORT": str(port),
            "HOROVOD_SLOT_KEY": ELASTIC_SLOT,
            "HOROVOD_RENDEZVOUS_VERSION": "0", "HOROVOD_ELASTIC": "1",
            "HVD_HEARTBEAT_SEC": ELASTIC_HEARTBEAT_SEC}


def _snapshot(torch, model, opt):
    """A clone of the model's and the optimizer's state."""
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            {pid: {k: v.clone() if isinstance(v, torch.Tensor) else v
                   for k, v in entries.items()}
             for pid, entries in opt.state_dict()["state"].items()})


def _same_state(torch, snap, model, opt):
    """Whether the live model and optimizer equal ``snap`` bit for bit."""
    params, moments = snap
    live = model.state_dict()
    if set(live) != set(params) or any(
            not torch.equal(live[k], params[k]) for k in params):
        return False
    state = opt.state_dict()["state"]
    return set(state) == set(moments) and all(
        torch.equal(state[pid][k], v) if isinstance(v, torch.Tensor)
        else state[pid][k] == v
        for pid, entries in moments.items() for k, v in entries.items())


class ElasticRun:
    """One training run under ``elastic.run``: transformer_long (or the
    tiny config) from ``seed``, AdamW through the bucketed optimizer, the
    data through ``ElasticSampler(shuffle=True, seed=0)`` and an async
    loader of pinned batches, a ``TorchState`` that commits every step
    and checkpoints every ``ELASTIC_CKPT_INTERVAL``-th into ``ckpt_dir``.
    ``hooks`` (a dict) may hold ``after_step(run)``, which may raise,
    ``before_commit(run)`` and ``after_commit(run)``."""

    def __init__(self, torch, hvd, hvd_models, cfg, device, data, batch,
                 seed, ckpt_dir, hooks=None):
        from horovod_tpu_torch import elastic
        from horovod_tpu_torch.data import AsyncDataLoaderMixin
        from horovod_tpu_torch.torch.elastic import ElasticSampler
        from horovod_tpu_torch.utils.checkpoint import Checkpointer

        self.torch, self.hvd_models, self.device = torch, hvd_models, device
        self.cuda = device.startswith("cuda")
        gen = torch.Generator(device=device).manual_seed(seed)
        self.model = hvd_models.Transformer(cfg, device=device,
                                            generator=gen)
        self.opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            self.model.parameters(), lr=1e-3, weight_decay=1e-4))
        self.sampler = ElasticSampler(len(data), shuffle=True, seed=0)
        self.ckpt = Checkpointer(ckpt_dir, max_to_keep=2)
        self.state = elastic.TorchState(
            self.model, self.opt, sampler=self.sampler, step=0,
            checkpointer=self.ckpt, checkpoint_interval=ELASTIC_CKPT_INTERVAL)
        pin = self.cuda

        class Loader:
            """Batches of the sampler's current shard, in its order."""

            def __init__(self, sampler):
                self.sampler = sampler

            def __iter__(self):
                order = list(self.sampler)  # reshards
                for b in range(len(order) // batch):
                    rows = order[b * batch:(b + 1) * batch]
                    x = data[rows]
                    yield b, rows, x.pin_memory() if pin else x

        class AsyncLoader(AsyncDataLoaderMixin, Loader):
            pass

        self.loader = AsyncLoader(self.sampler, async_loader_queue_size=2)
        self.hooks = hooks or {}
        self.losses, self.rows = {}, {}
        self.step_s, self.commit_s, self.ckpt_commit_s = [], [], []
        self.executed = 0
        self.train = elastic.run(self._train)

    def _train(self, state):
        torch = self.torch
        while state.step < ELASTIC_STEPS:
            try:
                for b, rows, x in self.loader:
                    if state.step >= ELASTIC_STEPS:
                        break
                    t0 = time.perf_counter()
                    tokens = x.to(self.device, non_blocking=True)
                    inputs = tokens[:, :-1]
                    loss = self.hvd_models.lm_loss(self.model(inputs),
                                                   inputs, tokens[:, 1:])
                    loss.backward()
                    self.opt.step()
                    self.opt.zero_grad()
                    value = float(loss.detach())
                    t1 = time.perf_counter()
                    self.executed += 1
                    if "after_step" in self.hooks:
                        self.hooks["after_step"](self)
                    if self.sampler.get_indices(b, len(rows)) != rows:
                        raise AssertionError("the loader's rows are not "
                                             "the sampler's")
                    self.sampler.record_batch(b, len(rows))
                    state.step += 1
                    self.losses[state.step] = value
                    self.rows[state.step] = rows
                    if "before_commit" in self.hooks:
                        self.hooks["before_commit"](self)
                    t2 = time.perf_counter()
                    state.commit()
                    if self.cuda:
                        torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    self.step_s.append(t1 - t0)
                    (self.ckpt_commit_s if state.step %
                     ELASTIC_CKPT_INTERVAL == 0 else
                     self.commit_s).append(t3 - t2)
                    if "after_commit" in self.hooks:
                        self.hooks["after_commit"](self)
            finally:
                self.loader.close_async_loader()


def replay(torch, hvd, hvd_models, cfg, device, data, seed, start, rows):
    """The plain loop, without elastic: the model from ``seed`` (or the
    state ``start``, a ``_snapshot``), one step per batch of ``rows``.
    Returns the losses and the final snapshot."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = hvd_models.Transformer(cfg, device=device, generator=gen)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(
        model.parameters(), lr=1e-3, weight_decay=1e-4))
    if start is not None:
        model.load_state_dict(start[0])
        sd = opt.state_dict()
        sd["state"] = {pid: {k: v.clone() if isinstance(v, torch.Tensor)
                             else v for k, v in entries.items()}
                       for pid, entries in start[1].items()}
        opt.load_state_dict(sd)
    losses = []
    for r in rows:
        tokens = data[r].to(device)
        inputs = tokens[:, :-1]
        loss = hvd_models.lm_loss(model(inputs), inputs, tokens[:, 1:])
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))
    return losses, _snapshot(torch, model, opt)


def _ms(seconds):
    return 1e3 * sorted(seconds)[len(seconds) // 2] if seconds else \
        float("nan")


def elastic_phase(torch, hvd, hvd_models, fa, device, card, errors,
                  tiny=False):
    """transformer_long under ``elastic.run`` on one card, with this
    script as the elastic driver (``KVServer``): run A uninterrupted; run
    B fails at step ``ELASTIC_FAIL_STEP`` (HorovodInternalError after the
    harness publishes version 1), restores, reinitialises and goes on,
    then takes a graceful reset at step ``ELASTIC_GROW_STEP``'s commit
    (version 2); run C, a fresh model from another seed, auto-resumes
    from run B's checkpoints, then falls back one step from a corrupt
    newest step. The attention launch counters are zeroed just before
    run B and read just after."""
    import os
    import shutil
    import tempfile

    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.elastic import worker

    cuda = device.startswith("cuda")
    cfg, batch, seq = slice_config(torch, hvd_models, tiny)
    data = torch.randint(0, cfg.vocab_size, (ELASTIC_SEQS, seq + 1),
                         generator=torch.Generator().manual_seed(SEED))

    def check(name, ok, detail):
        print("check elastic %s: %s: %s" % (name, detail,
                                           "ok" if ok else "FAIL"))
        if not ok:
            errors.append("elastic: %s: %s" % (name, detail))

    saved_env = dict(os.environ)
    kv = KVServer()
    tmp = tempfile.mkdtemp(prefix="hvd_elastic_")
    real_reinit = worker.reinit_for_version
    hvd.shutdown()
    try:
        kv.publish(0)
        os.environ.update(elastic_env(kv.port))
        hvd.init(device=device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        args = (torch, hvd, hvd_models, cfg, device, data, batch)

        # Run A: uninterrupted.
        run_a = ElasticRun(*args, SEED, os.path.join(tmp, "a"))
        save_s = []
        real_save = run_a.ckpt.save

        def timed_save(*a, **k):
            t0 = time.perf_counter()
            try:
                return real_save(*a, **k)
            finally:
                save_s.append(time.perf_counter() - t0)

        run_a.ckpt.save = timed_save
        run_a.train(run_a.state)
        step_ms, commit_ms = _ms(run_a.step_s[2:]), _ms(run_a.commit_s[2:])
        ckpt_mb = os.path.getsize(os.path.join(
            run_a.ckpt.step_dir(ELASTIC_STEPS), "state.pt")) / 1e6
        print("elastic: transformer_long B=%d S=%d, %d steps under "
              "elastic.run, commit every step, checkpoint every %d; run A "
              "losses %s" % (batch, seq, ELASTIC_STEPS, ELASTIC_CKPT_INTERVAL,
                             " ".join("%.4f" % run_a.losses[s] for s in
                                      range(1, ELASTIC_STEPS + 1))))
        print("elastic: step %.3f ms without its commit, %.3f ms with it "
              "(commit %.3f ms; medians of steps 3-%d, host clock, the loss "
              "read back each step); a checkpoint commit %.3f ms, of which "
              "Checkpointer.save %.3f ms for %.1f MB; on %s"
              % (step_ms, step_ms + commit_ms, commit_ms, ELASTIC_STEPS,
                 _ms(run_a.ckpt_commit_s), _ms(save_s), ckpt_mb, card))

        # Commit of TorchState (a deepcopy on the card) against CudaState
        # (a host snapshot), on the same tensors.
        tensors = ([p.detach() for p in run_a.model.parameters()],
                   [v for entries in run_a.opt.state_dict()["state"].values()
                    for v in entries.values()
                    if isinstance(v, torch.Tensor) and v.dim()])
        nbytes = sum(t.numel() * t.element_size()
                     for part in tensors for t in part)
        times = {}
        for name, st in (("TorchState", elastic.TorchState(run_a.model,
                                                           run_a.opt)),
                         ("CudaState", elastic.CudaState(
                             params=tensors[0], moments=tensors[1]))):
            rounds = []
            for _ in range(TIMING_ROUNDS):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                st.save()
                if cuda:
                    torch.cuda.synchronize()
                rounds.append(time.perf_counter() - t0)
            times[name] = _ms(rounds)
        print("elastic: commit (save) of %.1f MB of fp32 parameters and "
              "AdamW moments: TorchState %.3f ms (deepcopy on the card), "
              "CudaState %.3f ms (host snapshot); medians of %d, on %s"
              % (nbytes / 1e6, times["TorchState"], times["CudaState"],
                 TIMING_ROUNDS, card))
        t0 = time.perf_counter()
        run_a.ckpt.restore(step=ELASTIC_STEPS)
        restore_ms = 1e3 * (time.perf_counter() - t0)
        del tensors

        # Run B: a failure, then a host-set change.
        rec = {"injected": False, "recovered": None, "reinit_s": [],
               "snap": {}}

        def timed_reinit(version):
            t0 = time.perf_counter()
            try:
                return real_reinit(version)
            finally:
                rec["reinit_s"].append(time.perf_counter() - t0)

        worker.reinit_for_version = timed_reinit

        def after_step(run):
            if rec["recovered"] is None and rec["injected"]:
                # The first step after the restore.
                rec["recovered"] = time.perf_counter() - rec["t_raise"]
            if run.state.step + 1 == ELASTIC_FAIL_STEP and \
                    not rec["injected"]:
                rec["injected"] = True
                kv.publish(1)
                rec["t_raise"] = time.perf_counter()
                raise HorovodInternalError("injected: a peer is gone")

        def before_commit(run):
            if run.state.step == ELASTIC_GROW_STEP:
                rec["beat_v1"] = kv.wait_for_beat(1)
                kv.publish(2)

        def after_commit(run):
            if run.state.step in (ELASTIC_FAIL_STEP - 1, 12):
                rec["snap"][run.state.step] = _snapshot(torch, run.model,
                                                        run.opt)

        run_b = ElasticRun(*args, SEED, os.path.join(tmp, "b"),
                           dict(after_step=after_step,
                                before_commit=before_commit,
                                after_commit=after_commit))
        real_restore = run_b.state.restore

        def checked_restore():
            real_restore()
            rec["restored_exact"] = _same_state(
                torch, rec["snap"][ELASTIC_FAIL_STEP - 1], run_b.model,
                run_b.opt)

        run_b.state.restore = checked_restore
        fa.reset_launches()
        run_b.train(run_b.state)
        launches = {f.__name__: f.launches for f in fa.KERNELS}
        worker.reinit_for_version = real_reinit
        beat_v2 = kv.wait_for_beat(2)
        final_b = _snapshot(torch, run_b.model, run_b.opt)
        losses_b = [run_b.losses[s] for s in range(1, ELASTIC_STEPS + 1)]
        rows_b = [run_b.rows[s] for s in range(1, ELASTIC_STEPS + 1)]
        print("elastic: run B losses %s; recovery %.3f ms from the raise to "
              "the end of the next step, of which the reinit (shutdown, "
              "rendezvous, init) %.3f ms; the reset at version 2 %.3f ms; "
              "on %s" % (" ".join("%.4f" % x for x in losses_b),
                         1e3 * rec["recovered"], 1e3 * rec["reinit_s"][0],
                         1e3 * rec["reinit_s"][1], card))
        check("restore is the step-%d commit" % (ELASTIC_FAIL_STEP - 1),
              rec.get("restored_exact") is True,
              "parameters and AdamW state bit for bit: %s"
              % rec.get("restored_exact"))
        same = [losses_b[s] == run_a.losses[s + 1]
                for s in range(ELASTIC_FAIL_STEP - 1)]
        check("run B before the failure", all(same),
              "steps 1-%d equal run A's bit for bit: %s"
              % (ELASTIC_FAIL_STEP - 1, same))
        # After a reset the reference's sampler reshuffles the indices not
        # yet processed (horovod_tpu/data/sampler.py:80-113), so run B's
        # later batches are not run A's: its losses are held to the plain
        # loop on run B's own batches, from the same seed.
        losses_r, final_r = replay(*args[:-1], SEED, None, rows_b)
        diff = [a == b for a, b in zip(losses_b, losses_r)]
        check("run B against the plain loop on its batches", all(diff)
              and _same_state(torch, final_r, run_b.model, run_b.opt),
              "%d of %d losses bit for bit, final tensors equal %s"
              % (sum(diff), len(diff),
                 _same_state(torch, final_r, run_b.model, run_b.opt)))
        consumed = [i for r in rows_b for i in r]
        check("sampler", sorted(run_b.sampler.processed_indices) ==
              sorted(consumed) and len(set(consumed)) == len(consumed) ==
              ELASTIC_STEPS * batch,
              "processed %d indices, %d consumed, %d distinct"
              % (len(run_b.sampler.processed_indices), len(consumed),
                 len(set(consumed))))
        versions = kv.beat_versions()
        ok = rec.get("beat_v1") and beat_v2 and 1 in versions and \
            versions.index(1) < len(versions) - versions[::-1].index(2)
        check("heartbeats", ok, "%d heartbeats, versions in order of "
              "arrival %s" % (len(versions),
                              sorted(set(versions), key=versions.index)))
        want = cfg.n_layers * run_b.executed
        check("attention kernel launches", all(
            n == want for n in launches.values()),
            "%s over run B's %d executed steps, want %d each (%d a step)"
            % (launches, run_b.executed, want, cfg.n_layers))
        check("run B's steps", run_b.executed == ELASTIC_STEPS + 1 and
              sorted(run_b.losses) == list(range(1, ELASTIC_STEPS + 1)),
              "%d executed (one again after the failure), %d committed"
              % (run_b.executed, len(run_b.losses)))

        # Run C: a cold process on run B's checkpoints.
        run_c = ElasticRun(*args, SEED + 1, os.path.join(tmp, "b"))
        resume_s = []
        real_resume = run_c.state._maybe_auto_resume

        def timed_resume():
            t0 = time.perf_counter()
            try:
                return real_resume()
            finally:
                resume_s.append(time.perf_counter() - t0)

        run_c.state._maybe_auto_resume = timed_resume
        run_c.train(run_c.state)
        check("auto-resume", run_c.state.step == ELASTIC_STEPS and
              run_c.executed == 0 and
              _same_state(torch, final_b, run_c.model, run_c.opt),
              "resumed at step %d with run B's final tensors bit for bit: "
              "%s" % (run_c.state.step,
                      _same_state(torch, final_b, run_c.model, run_c.opt)))
        newest = os.path.join(run_c.ckpt.step_dir(ELASTIC_STEPS), "state.pt")
        with open(newest, "wb") as f:
            f.write(b"not a checkpoint")
        run_d = ElasticRun(*args, SEED + 2, os.path.join(tmp, "b"))
        run_d.state._maybe_auto_resume()  # as elastic.run's first entry
        rec_c = {"resumed": run_d.state.step,
                 "exact": _same_state(torch, rec["snap"][12], run_d.model,
                                      run_d.opt)}
        run_d.train(run_d.state)
        rows_d = [run_d.rows[s] for s in range(13, ELASTIC_STEPS + 1)]
        losses_d = [run_d.losses[s] for s in range(13, ELASTIC_STEPS + 1)]
        losses_r, _ = replay(*args[:-1], SEED, rec["snap"][12], rows_d)
        check("torn newest step", rec_c["resumed"] == 12 and rec_c["exact"]
              and losses_d == losses_r and run_d.executed == 4,
              "fell back to step %d (tensors of run B's step-12 commit bit "
              "for bit: %s), steps 13-%d equal the plain loop from that "
              "commit on their batches: %s"
              % (rec_c["resumed"], rec_c["exact"], ELASTIC_STEPS,
                 losses_d == losses_r))
        consumed_d = sorted(set(i for r in rows_b[:12] for i in r) |
                            set(i for r in rows_d for i in r))
        check("sampler after the fallback",
              sorted(run_d.sampler.processed_indices) == consumed_d and
              len(consumed_d) == ELASTIC_STEPS * batch,
              "%d indices processed, none twice"
              % len(run_d.sampler.processed_indices))
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else \
            float("nan")
        print("elastic: checkpoint restore %.3f ms, auto-resume %.3f ms "
              "(restore and apply, step %d); peak memory allocated %.3f GB; "
              "on %s" % (restore_ms, _ms(resume_s), ELASTIC_STEPS, peak,
                         card))
    finally:
        worker.reinit_for_version = real_reinit
        kv.close()
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.clear()
        os.environ.update(saved_env)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the card",
              file=sys.stderr)
        return 1
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import models as hvd_models
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print("chip_smoke: run from the root of a horovod_tpu checkout (%s)"
              % e, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print("card: %s" % card)
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))

    # Every build at once: one nvcc for each kernel source, and make for
    # the native core.
    from horovod_tpu_torch.core import build as core_build

    builds = {"flash_attention.cu": lambda: _build.build("flash_attention"),
              "fusion.cu": lambda: _build.build("fusion"),
              "adasum.cu": lambda: _build.build("adasum"),
              "the native core": core_build.library_path}
    build_s = {}

    def timed(name):
        t0 = time.perf_counter()
        builds[name]()
        build_s[name] = time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        for f in [pool.submit(timed, name) for name in builds]:
            f.result()
    for name in builds:
        print("build: %s in %.1f s (all started together)"
              % (name, build_s[name]))
    for lib in ("flash_attention", "fusion", "adasum"):
        _build.load(lib)
        for row in ptxas_summary(_build.build_logs.get(lib, "")):
            print("ptxas: " + row)

    device = "cuda"
    slice_abs, timings, bnd = kernel_phase(torch, fa, device)

    hvd.init(device=device)
    steps = 8
    res = run_slice(torch, hvd, hvd_models, fa, device, steps)
    cfg, losses = res["cfg"], res["losses"]
    print("slice: transformer_long B=%d S=%d layers=%d losses %s"
          % (res["batch"], res["seq"], cfg.n_layers,
             " ".join("%.4f" % x for x in losses)))
    tokens_per_s = res["batch"] * res["seq"] / (res["step_ms"] / 1e3)
    print("slice: step %.3f ms, %.1f tokens/s, %d buckets, %d bucket "
          "allreduces (NCCL), on %s"
          % (res["step_ms"], tokens_per_s, res["buckets"],
             res["buckets_launched"], card))
    print("slice: the host took %.3f ms to issue one step (steps 3-%d, "
          "host clock around each call; the step has no explicit "
          "synchronisation)"
          % (res["host_ms"], steps))
    want = cfg.n_layers * steps
    errors = []
    if not all(math.isfinite(x) for x in losses):
        errors.append("non-finite loss %s" % losses)
    if not losses[-1] < losses[0]:
        errors.append("loss did not fall: %s" % losses)
    for name, n in res["launches"].items():
        if n != want:
            errors.append("%s launched %d times, expected %d" % (name, n,
                                                                 want))
    if res["buckets"] <= 0 or res["buckets_launched"] != \
            res["buckets"] * steps:
        errors.append("buckets %d, launched %d" % (
            res["buckets"], res["buckets_launched"]))
    breakdown = device_breakdown(torch, res["step"], 2)
    if breakdown is None:
        print("slice: device breakdown not measured (the profiler saw no "
              "device activity)")
    else:
        by_family, seen, busy_ms, window_ms, top, host_ms, _ = breakdown
        print("slice: kernel ms per step by family (torch.profiler, 2 "
              "steps): %s; kernels busy %.3f ms of the profiled step of "
              "%.3f ms = %.1f%%, on %s"
              % (", ".join("%s %.3f%s" % (fam, ms, " [%s]" % ", ".join(
                  sorted(seen[fam])) if fam in seen else "")
                  for fam, ms in sorted(by_family.items(),
                                        key=lambda kv: -kv[1])),
                 busy_ms, window_ms, 100 * busy_ms / window_ms, card))
        print("slice: host ops by self CPU ms per step (torch.profiler, 2 "
              "steps; all host ops %.3f ms): %s"
              % (host_ms, "; ".join("%s x%g %.3f" % row for row in top)))
        # The bf16 step runs every attention kernel on the tensor cores.
        ran = {fam: sorted(keys) for fam, keys in seen.items()}
        if ran != TENSOR_CORE_KERNELS:
            errors.append("the step's attention kernels were %s, not %s"
                          % (ran, TENSOR_CORE_KERNELS))
    rel, grad_rel, finite = flash_matches_dense(torch, hvd_models,
                                                res["model"], device)
    print("slice: flash vs dense (fp32, seq 256): logits max rel err %.3e, "
          "gradients max rel err %.3e (tol %.0e)"
          % (rel, grad_rel, FP32_TOL))
    if not (rel < FP32_TOL and grad_rel < FP32_TOL and finite):
        errors.append("flash vs dense differ: logits %.3e, gradients %.3e, "
                      "finite %s" % (rel, grad_rel, finite))
    resnet_phase(torch, hvd, hvd_models, fa, device, card, errors)
    eager_kernels, eager_losses = eager_phase(torch, hvd, hvd_models, device,
                                              card, errors)
    eager_kernels += adasum_phase(torch, hvd_models, device, card, errors,
                                  eager_losses)
    moe_phase(torch, hvd, hvd_models, fa, device, card, errors)
    sequence_phase(torch, hvd, hvd_models, device, card, errors)
    elastic_phase(torch, hvd, hvd_models, fa, device, card, errors)
    hvd.shutdown()
    if errors:
        for e in errors:
            print("FAIL: " + e, file=sys.stderr)
        return 1

    replaces = {"flash_fwd": 55, "flash_bwd_dkv": 114, "flash_bwd_dq": 174}
    kernels = []
    for name, (ms, plain_ms, lib_ms) in timings.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": "horovod_tpu_torch/csrc/flash_attention.cu",
            "replaces": "horovod_tpu/ops/pallas_attention.py:%d"
                        % replaces[name],
            "launches": res["launches"][name],
            "max_abs_err": slice_abs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
            "library_ms": lib_ms,
        })
    kernels += eager_kernels
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
