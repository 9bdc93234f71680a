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
   (``SYNC_BN_TOL``).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
            dim = re.search(r"ILi(\d+)E", name)
            dt = "bf16" if "bfloat16" in name else "fp32"
            pipe = "tensor cores" if "_mma_" in name else "FMA"
            rows.append("%s D=%s %s (%s): %s registers, %s bytes spilled"
                        % (kern.group(0) if kern else name,
                           dim.group(1) if dim else "?", dt, pipe,
                           m.group(1), spills))
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


def run_slice(torch, hvd, hvd_models, fa, device, steps, tiny=False):
    """Train ``steps`` steps on one fixed batch; returns losses, launch
    counts, bucket count, the steady-state step time (ms), the host's
    time to issue one step (ms, no synchronisation inside the step) and
    ``step``, a closure that runs one more step."""
    cfg, batch, seq = slice_config(torch, hvd_models, tiny)
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
KERNEL_FAMILIES = (("flash_fwd", "fwd_kernel"),
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

    t0 = time.perf_counter()
    _build.load("flash_attention")
    print("build: flash_attention.cu in %.1f s" % (time.perf_counter() - t0))
    for row in ptxas_summary(_build.build_logs.get("flash_attention", "")):
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
