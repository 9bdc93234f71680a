#!/usr/bin/env python3
"""On-card smoke test of horovod_tpu_torch, the PyTorch / H100 port.

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device probe: no CUDA device -> exit 1 (there is no CPU fallback);
   prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``horovod_tpu_torch/csrc`` with nvcc, all
   at once; prints each kernel's ptxas registers, spills and static shared
   memory, the dynamic shared memory of the Hopper forwards and of the
   wide family as launched, and whether the SASS of every instantiation of
   both libraries' Hopper kernels (``fwd_wgmma_kernel``,
   ``wide_fwd_wgmma_kernel``, ``wide_dkv_wgmma_kernel`` and
   ``wide_dq_wgmma_kernel``) holds ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   loads), and whether the wide library's wgmma kernels spill, which they
   must and must not;
3. holds each kernel against its plain PyTorch version, element by
   element (``TOLS``), at the flagship's long-context attention shape
   (bf16 and fp16), at ragged fp32 shapes (FMA kernels), at ragged bf16
   and fp16 shapes for every compiled head dim (tensor-core kernels and
   the Hopper forward, causal and not), and, zero-padded as
   ``flash_attention`` runs them, at the full-width attention of
   Pythia-2.8B (32 heads of 80) and GPT-NeoX-20B (64 heads of 96), fp16,
   causal, S = 2048 (``PADDED_SHAPES``), each against the plain version at
   its true head dim; the wide family (head dims above 128,
   ``csrc/flash_attention_wide.cu``) at ``WIDE_CHECK_DIMS`` (160 padded to
   192, 192, 256, 320, 512, 576, and 640 past the Hopper forward's head
   dims) in bf16 and fp16 and at 192, 256 and 512 in fp32, causal and not,
   and at the wide path's own attention (``WIDE_PATH_SHAPE``, bf16),
   Qwen3-Next-80B-A3B's (bf16 and fp16), GLM-5.2's, DeepSeek-V4-Flash's
   and sarvam-105b's (bf16), causal, S = 2048; and every forward route
   (fp32, bf16 and fp16, a narrow and a wide head dim of each layout) at
   Sq > Skv, causal, where the first Sq - Skv query rows see no key
   (``C18_CHECK_DIMS``); the backward kernels also run chained on the
   forward kernel's lse and delta, as the main path runs them; runs the
   dK/dV and dQ kernels twice (bf16 and fp16 at the slice shape, the wide
   family at Qwen3-Next-80B-A3B's attention in all three dtypes, and every
   head dim of ``WIDE_BWD_TILES`` in bf16 and fp16), and the wide
   bf16/fp16 forward twice (the wide path's attention, Qwen3-Next in fp16,
   sarvam-105b's in bf16), and requires bit-equal results (no atomics);
   times kernel, plain version, and the
   library call (SDPA forward, and SDPA backward against both backward
   kernels together, at the same dtype and true head dim) beside the
   bound, in bf16 and fp16 at the slice's shape, at the two padded shapes,
   at head dim 128 (``D128_SHAPE``) and at Qwen3-Next-80B-A3B's attention
   (wide; tools/flash_wide_times.py times all of ``WIDE_SHAPES``);
   with ``--parent DIR`` (an unpacked parent tree) it also times the
   parent's forward kernels (both libraries') and the parent's wide
   backward pair (at Qwen3-Next-80B-A3B's attention) against this tree's
   in turns (parent, new, new, parent);
4. drives the port's main path: ``transformer_long`` (the flagship at
   seq 2048 with flash attention, full width) trained for a few steps
   with ``DistributedOptimizer(AdamW)`` under ``init()`` at size 1, with
   every launch counter zeroed just before and read just after; reports
   the step time and the host's time to issue a step, the kernel time by
   family (and which kernels ran in it) and the host ops with the most
   self CPU time under torch.profiler; checks the loss falls and that
   flash and dense attention give the same logits on a small input;
4a. the ``tune:`` check, the flash tile tuner on the card
   (``tune_phase``): ``HVD_FLASH_TUNE=1`` with a temporary cache writes
   one record at the slice's attention shape (the compiled tile, the
   card's key), a second call hits it (the trials counter stays),
   ``HVD_FLASH_TUNE=cache`` reads it, ``HVD_FLASH_BLOCK_Q=128`` raises,
   and the slice under ``HVD_FLASH_TUNE=cache`` gives phase 4's first
   ``TUNE_SLICE_STEPS`` losses bit for bit; then the fp16 slice
   (``fp16_slice_phase``): transformer_long at full width with fp16
   compute for ``FP16_SLICE_STEPS`` steps, the loss falling and finite,
   each fp16 attention kernel launched once a layer a step; then the wide
   path (``wide_phase``): a transformer at Qwen3-Next-80B-A3B's attention
   width (16 heads of 256) trained ``WIDE_STEPS`` steps, the
   launch counters zeroed just before and read just after, each wide
   kernel launched once a layer a step, each step's loss within
   ``WIDE_LOSS_RTOL`` of the same steps with dense attention;
4b. the ``launch:`` phase, the port's own launcher on the card
   (``python -m horovod_tpu_torch.runner``): ``--check-build`` lists CUDA
   with the card, NCCL and the kernels; ``-np 1`` runs
   tests/torch_port_launch_worker.py, which trains transformer_long
   through ``run_slice`` for ``LAUNCH_STEPS`` steps: its losses must equal
   phase 4's first ones bit for bit and each attention kernel launch
   ``n_layers`` times a step; ``horovod_tpu_torch.run`` of a module-level
   function returns from ``cuda:0`` without jax; ``-np 2`` on the one
   card is refused within ``LAUNCH_REFUSE_SEC`` before any worker starts;
   the elastic driver (``--min-np 1 --max-np 1``, a discovery script, a
   journal) respawns a worker that exits at step ``LAUNCH_FAIL_STEP`` of
   ``LAUNCH_ELASTIC_STEPS``, which resumes from its checkpoint to the
   uninterrupted run's weights bit for bit, with the journal's two
   rendezvous and one failed exit. Prints the time from the launcher's
   start to the worker's first step and from the exit to the respawned
   worker's first step;
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
8. the ``codec:`` phase at the same width: the eager loop under the int8
   wire codec (``stage_wire_codec``; its error feedback on every gradient
   of every step, one real step's feedback calls held to the plain
   feedback bit for bit) and the device plane's compressed ring over
   ``CODEC_RANKS`` members simulated on the card for bf16, fp16 and int8,
   with the codec launch counters zeroed just before and read just after
   (the ring against its plain version bit for bit, every member equal,
   within ``WIRE_TOLERANCE`` of the exact sum); the same loop with no
   codec for its step time; the three codec kernels against their plain
   versions bit for bit on all the gradients and on edge blocks (NaN,
   infinities, subnormals, halfway values, blocks of 0, 1 and n - 1
   elements); encode and decode-reduce at every phase of the fp32 block
   and of the wire (blocks of 0-67 values, the ring's chunks 0 and 1, the
   edge blocks), and exhaustively over every fp32 pattern (fp16, bf16
   encode) and every half (fp16 decode-reduce); the kernels one encode
   runs (int8: two); and their times at the ring's two phases, on the
   card's clock, beside their bounds and the library calls;
9. the ``observability:`` phase on the eager loop at the same width:
   ``init`` (from the main thread) under HOROVOD_TIMELINE and
   HVD_METRICS_PORT=0; ``/metrics`` and ``/metrics.json`` scraped from
   127.0.0.1 before and after ``OBS_STEPS`` steps (the allreduce bytes
   102,228,128 x steps; the collective count and the latency and bytes
   histograms' counts the submitted tensors); both timelines parsed (each
   card tensor one span a step, its card ms in (0, the step's ms]);
   ``dump_flight_record`` (a ``submit`` and a ``complete`` for every
   tensor in the Python file, its ENQUEUE and NEG_END in the native one);
   ``HOROVOD_AUTOTUNE=1`` then ``=native`` for ``AUTOTUNE_STEPS`` steps
   each, the parameters moving within the tuner's box while every step's
   results equal ``LocalBackend``'s bit for bit; then the eager step with
   all of it on against HVD_FLIGHTREC=0 with no timeline and no server
   (median pair ratio of ``OVERHEAD_PAIRS`` alternating runs), and the
   host cost of a timing-enabled event. A server that cannot bind, a
   timeline that cannot open, or a card latency that never resolves
   fails the phase;
10. the ``moe:`` phase: transformer_long with ``MOE_EXPERTS`` top-1
   experts in place of each MLP (flash attention, bf16), ``MOE_STEPS``
   steps through the bucketed optimizer with the launch counters zeroed
   just before and read just after; step time, tokens/s, host time, peak
   memory, the kernel time of the dispatch einsums, the expert FFN, the
   attention kernels and the rest; checks that the loss falls, that every
   bucket launched every step, that each attention kernel ran once a layer
   a step, and that one MoE layer in fp32 gives the CPU's dispatch exactly
   and its output and gradients within ``MOE_LAYER_RTOL``;
11. the ``sequence:`` phase: the ring and the Ulysses transformer at size 1
   (the global set) against the flash transformer from the same weights,
   step by step (``SEQ_LOSS_RTOL``); the ring's schedule over
   ``RING_MEMBERS`` slices of one (4, 2048, 8, 64) problem against
   full-sequence attention in bf16 and fp32 (``TOLS``); and
   ``pipeline_apply`` at size 1 against the sequential stack;
12. the ``elastic:`` phase: transformer_long at full width under
    ``elastic.run``, with this script as the elastic driver (the port's
    ``RendezvousServer``, the slot published before the meta, heartbeats
    every 0.5 s, received through the server's ``put_callback``).
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
    before run B), the resumes, and the ``hvd_elastic_*`` counters against
    the commits, checkpoints, resets, restores and heartbeats the phase
    caused; prints step, commit, checkpoint, restore, auto-resume and
    recovery times and peak memory;
13. the ``tuning:`` phase: the ``eager`` loop (ResNet-50, batch 32 at
    224px, 161 gradients a step through the core and the device plane,
    each step's results held to ``LocalBackend`` bit for bit) under
    ``elastic.run`` with HVD_TUNE=1, the online tuner started first on the
    core's allreduced bytes (at size 1 NCCL moves nothing, so the training
    objective reads 0), windows of ``TUNE_WINDOW_SEC``, ``TUNE_SAMPLES``
    rounds; step ``TUNE_FAIL_STEP`` raises ``HorovodInternalError`` once.
    Prints the tuner's trajectory (each window's rates and moves) and the
    step time searching and frozen; checks that it measured windows,
    applied and judged moves and froze, that every fusion threshold it
    applied reached the core and the plane's buffer, the results, the
    reset (``on_world_change`` ran once, without error; the wrapper's hook
    returned the started tuner), the fusion launches, and that a tuner
    under HVD_TUNE=cache replays the journal to the same values without a
    search;
14. the C8 check: a broadcast of a card tensor with root 1 at size 1
    raises within ``C8_LIMIT_SEC`` (under a watchdog thread), and a
    broadcast with root 0 then runs;
15. the ``plan:`` phase (after ``moe:``): the planner's summary and JSON
    for transformer_long, resnet50 and moe at 1, 4 and 8 devices on the
    H100 topology; then the plan at this world's size applied and the MoE
    transformer trained ``PLAN_STEPS`` steps through ``Plan.optimizer``,
    whose losses must equal the ``moe:`` phase's first bit for bit, with
    the attention launch counters zeroed just before and read just after;
16. the ``serve:`` phase: MnistCNN trained on the card and saved
    at step N, ``python -m horovod_tpu_torch.serve`` (a router and two
    replicas, subprocesses, on the card) serving it, step N + 1 saved;
    ``SERVE_REQUESTS`` requests of 1-8 rows from ``SERVE_CLIENTS``
    threads through the router, a directed reload of both replicas to
    N + 1 and a drain of one mid-stream. Checks: every request answered
    200, the reloads and the drain (the drained replica culled by its
    goodbye), the step tags, each answer bit for bit against the
    replica's own bucket path (a fresh process on the card) and within
    ``SERVE_CPU_RTOL`` of the CPU's plain forward of its step; prints
    rows/s, latency p50/p99, batches per bucket and each reload's time;
17. the ``spark:`` phase (last), the port's Spark path over
    tests/fake_pyspark.py (barrier tasks are spawned processes): (a)
    ``spark.run(num_proc=1)`` of a task that trains transformer_long
    through ``run_slice`` for ``SPARK_STEPS`` steps, whose losses must
    equal phase 4's first ones bit for bit, with each attention kernel
    launched ``n_layers`` times a step, on ``cuda:0``, without jax; (b)
    ``spark.run_elastic`` over a ``TorchState`` of transformer_long that
    raises ``HorovodInternalError`` once at step ``SPARK_FAIL_STEP`` of
    ``SPARK_ELASTIC_STEPS``, retried after a shutdown and init, ending
    with the weights (sha256) of the same run uninterrupted in this
    process; (c) where pandas and pyarrow import, ``TorchEstimator``
    fitted inline (``LocalBackend(num_proc=1)``) on transformer_long
    wrapped in ``TokenLM``, ``SPARK_ROWS`` rows, the attention counters
    zeroed just before the fit and read just after, its history and
    checkpoint bit for bit against a plain loop over the same bytes, rows,
    order and optimizer, ``predict`` on the card against the loop's
    forward, and ``save``/``load``; where they do not, one line says that
    the estimator waits for them. (a)'s and (b)'s jobs run at the same
    time. Prints the task's start-up split, the retry's time and the
    fit's.

After phase 4, ``check introspect`` holds ``horovod_tpu_torch.introspect``
on the slice's step: one ``c10d::allreduce_`` a bucket under
torch.profiler, and every parameter and AdamW state tensor updated in
place.

Each phase prints when it is done (``phase ...: done at``, seconds since
the card was found).

The line before the last is ``{"kernels": [...]}`` (the bf16 kernels with
phase 4's launches, the fp16 instantiations as ``*_fp16`` with the fp16
slice's, the wide family as ``*_wide`` with the wide path's and the
errors of the check at its shape, timed at Qwen3-Next-80B-A3B's
attention); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

try:  # the spark: phase's TokenLM subclasses torch's Module
    import torch as _torch
except ImportError:  # main() reports it
    _torch = None

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

SEED = 0
# A kernel's output against its plain version, element by element:
#   |kernel - plain| <= rtol * |plain| + atol * (RMS of plain's row),
# the row being the last axis (a query row of O or dQ, a key row of dK or
# dV). bf16: rtol 2^-7 is one bf16 rounding step (both sides round their
# output to bf16); atol 2^-5 of the row's RMS covers the tensor cores'
# rounding of P and dS to bf16 before their products, summed over keys.
# fp16: rtol 2^-10 is one fp16 rounding step; atol 2^-8 is the bf16 atol
# scaled by fp16's 3 more mantissa bits, as P and dS are rounded to fp16
# before their products (dS below 2^-14 goes subnormal: its absolute
# error stays below 2^-25, far under the limit of any row).
# fp32: the same math summed in another order. A row's RMS is floored at
# ROW_FLOOR of the whole tensor's: a row whose exact value is zero (dQ of
# a query that sees one key, where dS = P (dP - delta) and dP = delta)
# holds only fp32 rounding residue on either side, which a limit of 0
# would reject. That residue comes from fp32 sums (the kernel's dP on the
# tensor cores, delta in PyTorch) whatever the 16-bit type, so a 16-bit
# output's floor term, atol * the floored RMS, is the same fraction of the
# tensor's RMS for both types: RESIDUE_FLOOR = 2^-13 (bf16's 2^-5 * 2^-8),
# which floors an fp16 row's RMS at 2^-5 of the tensor's. (A floor of
# 2^-8 for fp16 put it at 2^-16, below the card's residue in dQ's first
# row at the slice's shape: 2.448 of that limit on an H100.)
TOLS = {"bfloat16": (2 ** -7, 2 ** -5), "float16": (2 ** -10, 2 ** -8),
        "float32": (1e-4, 1e-4)}
ROW_FLOOR = 2 ** -8
RESIDUE_FLOOR = 2 ** -13
LSE_TOL = 1e-4    # absolute (nats): lse is fp32 from fp32 max and sum
FP32_TOL = 1e-4   # flash vs dense attention in fp32
SLICE_SHAPE = (4, 8, 2048, 64)   # (B, H, S, D) of transformer_long
# Two public attention layers whose head dim no kernel compiles, fp16,
# causal, batch 1 (B, H, S, D): they run zero-padded to the next compiled
# head dim. Pythia-2.8B (EleutherAI/pythia-2.8b config.json:
# num_attention_heads 32, hidden_size 2560, max_position_embeddings 2048)
# and GPT-NeoX-20B (EleutherAI/gpt-neox-20b config.json: 64 heads,
# hidden_size 6144, 2048 positions); both trained in fp16.
PADDED_SHAPES = (("Pythia-2.8B", (1, 32, 2048, 80)),
                 ("GPT-NeoX-20B", (1, 64, 2048, 96)))
# Four public attention layers with head dims above 128, which run on the
# wide family (csrc/flash_attention_wide.cu), bf16, causal, batch 1, S =
# 2048, k and v at the query head count (B, H, S, D): GLM-5.2
# (zai-org/GLM-5.2 config.json: num_attention_heads 64, head_dim 192),
# Qwen3-Next-80B-A3B (Qwen/Qwen3-Next-80B-A3B-Instruct config.json: 16
# heads, head_dim 256), DeepSeek-V4-Flash (deepseek-ai/DeepSeek-V4-Flash
# config.json: 64 heads, head_dim 512) and sarvam-105b (sarvamai/sarvam-105b
# config.json: num_attention_heads 64, head_dim 576).
WIDE_SHAPES = (("GLM-5.2", (1, 64, 2048, 192)),
               ("Qwen3-Next-80B-A3B", (1, 16, 2048, 256)),
               ("DeepSeek-V4-Flash", (1, 64, 2048, 512)),
               ("sarvam-105b", (1, 64, 2048, 576)))
# The head dims at which the wide family is held to its plain version on
# ragged shapes: in bf16 and fp16 each layout of the Hopper forward (160
# runs padded to 192) and 640, past its head dims, on ``wide_fwd_kernel``;
# fp32 (``wide_fwd_kernel``) at three of them.
WIDE_CHECK_DIMS = (160, 192, 256, 320, 512, 576, 640)
WIDE_FP32_CHECK_DIMS = (192, 256, 512)
# Rows that see no key (causal, Sq > Skv): every forward route at a narrow
# and a wide head dim of each layout, in fp32, bf16 and fp16 (64: the
# narrow library's fwd_wgmma_kernel and fwd_kernel; 192: the wide "rows";
# 576: the wide "columns"; 640: the sliced wide_fwd_kernel), held to the
# plain version, which gives those rows the reference's one convention.
C18_CHECK_DIMS = (64, 192, 576, 640)
C18_SHAPE = (2, 2, 200, 130)  # (B, H, Sq, Skv): 70 rows see no key
# Head dim 128, the catalog's most common, at 32 heads (B, H, S, D).
D128_SHAPE = (1, 32, 2048, 128)
# The attention of the wide path (``wide_phase``, ``wide_config``):
# (B, H, S, D), bf16, causal.
WIDE_PATH_SHAPE = (2, 16, 2048, 256)
WIDE_STEPS = 3
# Each step's loss on the wide path against dense attention's from the
# same seed, relative: the two differ by the order of bf16's rounding of
# the attention (2^-8 relative, an element), averaged over 4096 tokens'
# losses; a kernel that gets the attention wrong beyond that moves it.
WIDE_LOSS_RTOL = 1e-3
FP16_SLICE_STEPS = 3
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
    """One line per compiled kernel: name, registers, spills, and the
    static shared memory ptxas reports."""
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
            smem = re.search(r"(\d+) bytes smem", line)
            kern = re.search(r"(wide_fwd_wgmma|wide_dkv_wgmma|wide_dq_wgmma|"
                             r"wide_dq_rows_wgmma|fwd_wgmma|wide_fwd|"
                             r"wide_dkv|wide_dq|dkv_mma|dq_mma|fwd|dkv|dq)"
                             r"_kernel", name)
            if kern:  # flash attention: head dim or slice, dtype, pipe
                dim = re.search(r"Li(\d+)E", name)
                wide = kern.group(0).startswith("wide") and \
                    "wgmma" not in name
                kind = "bf16" if "bfloat16" in name else \
                    "fp16" if "__half" in name else "fp32"
                label = "%s %s=%s %s (%s)" % (
                    kern.group(0), "slice" if wide else "D",
                    dim.group(1) if dim else "64", kind,
                    "wgmma" if "wgmma" in name else
                    "FMA" if kind == "fp32" else "tensor cores")
            else:  # the collectives' kernels: name<dtype id, flag>
                base = re.search(r"\d+([A-Z][A-Za-z]*Kernel)", name)
                args = re.search(r"Kernel(?:ILi(\d+)ELb([01])E)", name)
                label = (base.group(1) if base else name) + (
                    "<%s, %s>" % args.groups() if args else "")
            rows.append("%s: %s registers, %s bytes spilled%s"
                        % (label, m.group(1), spills,
                           ", %s bytes static smem" % smem.group(1)
                           if smem else ""))
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
    tensor's (for a 16-bit ``want``, at least ``RESIDUE_FLOOR / atol``
    times); an output passes at <= 1."""
    floor = ROW_FLOOR
    if want.element_size() == 2:
        floor = max(floor, RESIDUE_FLOOR / atol)
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt().clamp(
        min=floor * float(want.pow(2).mean().sqrt()))
    ratio = (got - want).abs() / (rtol * want.abs() + atol * rms)
    return float(ratio.nan_to_num(nan=0.0, posinf=math.inf).max())


def make_inputs(torch, b, h, sq, skv, d, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return rnd(b, h, sq, d), rnd(b, h, skv, d), rnd(b, h, skv, d), \
        rnd(b, h, sq, d)


def padded_kernels(torch, fa, d):
    """The three kernel wrappers as ``flash_attention`` runs them at head
    dim ``d``: inputs zero-padded to ``fa.padded_head_dim(d)``, outputs cut
    back to ``d`` (the wrappers themselves where ``d`` is compiled)."""
    dp = fa.padded_head_dim(d)
    if dp == d:
        return fa.flash_fwd, fa.flash_bwd_dkv, fa.flash_bwd_dq

    def pad(*xs):
        return [torch.nn.functional.pad(x, (0, dp - d)) for x in xs]

    def fwd(q, k, v, causal, scale):
        o, lse = fa.flash_fwd(*pad(q, k, v), causal, scale)
        return o[..., :d], lse

    def dkv(q, k, v, do, lse, delta, causal, scale):
        return tuple(x[..., :d] for x in fa.flash_bwd_dkv(
            *pad(q, k, v, do), lse, delta, causal, scale))

    def dq(q, k, v, do, lse, delta, causal, scale):
        return fa.flash_bwd_dq(*pad(q, k, v, do), lse, delta, causal,
                               scale)[..., :d]

    return fwd, dkv, dq


def compare_kernels(torch, fa, b, h, sq, skv, d, dtype, causal, device):
    """Each kernel against its plain version on the same inputs: for each
    output, its largest error as a fraction of its limit (``limit_ratio``;
    lse against ``LSE_TOL``), and the kernel's largest absolute error.
    A head dim that no kernel compiles runs zero-padded, as
    ``flash_attention`` runs it (``padded_kernels``), against the plain
    versions at the true head dim and scale.
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
    fwd, dkv, dq = padded_kernels(torch, fa, d)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    o, lse = fwd(q, k, v, causal, scale)
    alone = (q, k, v, do, lse_ref, (do.float() * o_ref.float()).sum(-1),
             causal, scale)
    chained = (q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal,
               scale)
    out = {"flash_fwd": (
        [("O", limit_ratio(o, o_ref, rtol, atol)),
         ("lse", _abs(lse, lse_ref) / LSE_TOL)],
        max(_abs(o, o_ref), _abs(lse, lse_ref)))}
    for name, kern, plain, labels in (
            ("flash_bwd_dkv", dkv, fa.flash_bwd_dkv_plain, ("dK", "dV")),
            ("flash_bwd_dq", lambda *a: (dq(*a),),
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


# The sleep that ``queued_ms`` puts ahead of each round: long enough for
# the host to issue a round of calls (the codec wrappers take tens of
# microseconds each).
QUEUE_MS = 20.0


def queued_ms(torch, fn, reps=50, rounds=5):
    """The card's ms per call of ``fn``: median over ``rounds`` of the
    mean over ``reps`` calls (CUDA events) that the host issued while a
    sleep kernel of ``QUEUE_MS`` held the card, so the calls run back to
    back whatever the host's issue rate; after warm-up. Raises when the
    host took longer to issue a round than the sleep lasted."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(1 << 20)
    b.record()
    torch.cuda.synchronize()
    cycles = int((1 << 20) * QUEUE_MS / a.elapsed_time(b))
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        issued = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if issued > 0.8 * QUEUE_MS:
            raise RuntimeError("queued_ms: the host took %.3f ms to issue "
                               "%d calls, near the %.1f ms sleep"
                               % (issued, reps, QUEUE_MS))
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[rounds // 2]


def bounds(b, h, sq, skv, d, kind, causal):
    """(bound_ms, bound_by) of each kernel at head dim ``d`` in ``kind``
    ("bf16", "fp16" or "fp32"): the larger of the bytes it must move over
    HBM bandwidth and the products over the type's peak. Products count
    only the (q, k) pairs the mask leaves."""
    itemsize = 4 if kind == "fp32" else 2
    off = skv - sq
    pairs = sum(min(max(r + off + 1, 0), skv) for r in range(sq)) \
        if causal else sq * skv
    pairs *= b * h
    panel_q = b * h * sq * d * itemsize
    panel_k = b * h * skv * d * itemsize
    rows = b * h * sq * 4
    peak = PEAK_FLOPS[kind]
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


KINDS = {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}


def kernel_checks(torch, fa):
    """(b, h, sq, skv, d, dtype, causal) of every kernel check: the slice's
    shape in bf16 and fp16, ragged fp32 shapes (FMA kernels), the
    tensor-core kernels in bf16 and fp16 at every compiled head dim
    (ragged, Sq != Skv, causal and not), the two padded public
    layers in fp16, and the wide family (ragged, causal and not) in bf16
    and fp16 at ``WIDE_CHECK_DIMS`` (the Hopper kernels; 160 padded to
    192) and in fp32 at ``WIDE_FP32_CHECK_DIMS``, at the wide path's
    attention (bf16), at Qwen3-Next-80B-A3B's (bf16 and fp16) and at
    GLM-5.2's, DeepSeek-V4-Flash's and sarvam-105b's (bf16), causal; then
    the rows that see no key at ``C18_CHECK_DIMS`` in three dtypes."""
    b, h, s, d = SLICE_SHAPE
    return [
        (b, h, s, s, d, torch.bfloat16, True),
        (b, h, s, s, d, torch.float16, True),
        (2, 2, 130, 200, 64, torch.float32, True),
        (2, 2, 130, 200, 64, torch.float32, False),
        (1, 2, 130, 130, 16, torch.float32, True),
        (1, 2, 130, 130, 32, torch.float32, True),
        (1, 2, 130, 130, 128, torch.float32, True),
        (1, 2, 100, 100, 128, torch.bfloat16, False),
    ] + [
        (2, 2, 130, 200, d, dtype, causal)
        for dtype in (torch.bfloat16, torch.float16)
        for d in fa.HEAD_DIMS for causal in (True, False)
    ] + [(pb, ph, ps, ps, pd, torch.float16, True)
         for _, (pb, ph, ps, pd) in PADDED_SHAPES] + [
        (2, 2, 130, 200, d, dtype, causal)
        for dtype in (torch.bfloat16, torch.float16)
        for d in WIDE_CHECK_DIMS for causal in (True, False)
    ] + [
        (2, 2, 130, 200, d, torch.float32, causal)
        for d in WIDE_FP32_CHECK_DIMS for causal in (True, False)
    ] + [
        (wb, wh, ws, ws, wd, dtype, True)
        for (wb, wh, ws, wd), dtype in (
            (WIDE_PATH_SHAPE, torch.bfloat16),
            (dict(WIDE_SHAPES)["Qwen3-Next-80B-A3B"], torch.bfloat16),
            (dict(WIDE_SHAPES)["Qwen3-Next-80B-A3B"], torch.float16),
            (dict(WIDE_SHAPES)["GLM-5.2"], torch.bfloat16),
            (dict(WIDE_SHAPES)["DeepSeek-V4-Flash"], torch.bfloat16),
            (dict(WIDE_SHAPES)["sarvam-105b"], torch.bfloat16))] + [
        C18_SHAPE + (d, dtype, True)
        for dtype in (torch.float32, torch.bfloat16, torch.float16)
        for d in C18_CHECK_DIMS]


def kernel_times(torch, fa, b, h, s, d, dtype, device, label=""):
    """At (b, h, s, s, d), causal: each kernel's ms (on inputs padded to
    the compiled head dim before the timing; median of 5 rounds of 20, in
    turns with SDPA's forward for the forward), its plain version's at the
    true ``d``, SDPA's forward at the true ``d`` and dtype, and the bound
    at the true ``d``; then SDPA's backward against the two backward
    kernels together. Returns ({name: (ms, plain_ms, library_ms)},
    bounds)."""
    kind = KINDS[str(dtype)[6:]]
    q, k, v, do = make_inputs(torch, b, h, s, s, d, dtype, device, SEED)
    scale = d ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    bwd = (q, k, v, do, lse, delta, True, scale)
    dp = fa.padded_head_dim(d)
    pq, pk, pv, pdo = (torch.nn.functional.pad(x, (0, dp - d))
                       for x in (q, k, v, do))
    pbwd = (pq, pk, pv, pdo, lse, delta, True, scale)
    fns = {
        "flash_fwd": (lambda: fa.flash_fwd(pq, pk, pv, True, scale),
                      lambda: fa.flash_fwd_plain(q, k, v, True, scale)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*pbwd),
                          lambda: fa.flash_bwd_dkv_plain(*bwd)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*pbwd),
                         lambda: fa.flash_bwd_dq_plain(*bwd)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = {"flash_fwd": lambda: sdpa(q, k, v, is_causal=True)}
    bnd = bounds(b, h, s, s, d, kind, True)
    shape = "B=%d H=%d S=%d D=%d%s %s causal%s" % (
        b, h, s, d, "" if dp == d else " (run at D=%d)" % dp, kind, label)
    timings = {}
    for name, (kern, plain) in fns.items():
        # Kernel and library: the median of 5 rounds of 20 each, taken in
        # turns, so a slow stretch of the card's clock hits both.
        rounds = {"kern": [], "lib": []}
        for _ in range(5):
            rounds["kern"].append(time_ms(torch, kern, 20))
            if name in library:
                rounds["lib"].append(time_ms(torch, library[name], 20))
        ms = sorted(rounds["kern"])[2]
        lib_ms = sorted(rounds["lib"])[2] if rounds["lib"] else None
        plain_ms = time_ms(torch, plain, 5)
        timings[name] = (ms, plain_ms, lib_ms)
        print("time %-14s %.4f ms (plain %.4f ms, library %s, bound %.4f "
              "ms by %s) %s"
              % (name, ms, plain_ms,
                 "%.4f ms" % lib_ms if lib_ms is not None else "none",
                 bnd[name][0], bnd[name][1], shape))
    # SDPA's flash backward computes dQ, dK and dV in one call: it is the
    # yardstick of the two backward kernels together, not of either. Both
    # sides take the median of 5 rounds of 20, in turns; the host's time to
    # launch one call says whether a reading is the card's or the host's.
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = sdpa(qg, kg, vg, is_causal=True)

    def sdpa_bwd():
        return torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)

    def pair():
        fa.flash_bwd_dkv(*pbwd)
        fa.flash_bwd_dq(*pbwd)

    rounds = {"sdpa": [], "pair": []}
    for _ in range(5):
        rounds["pair"].append(time_ms(torch, pair, 20))
        rounds["sdpa"].append(time_ms(torch, sdpa_bwd, 20))
    launch = {}
    for name, fn in (("pair", pair), ("sdpa", sdpa_bwd)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        launch[name] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    med = {key: sorted(val)[2] for key, val in rounds.items()}
    print("time sdpa backward (dQ, dK, dV) %.4f ms, median of 5 rounds of "
          "20 (rounds %s; the host launches a call in %.4f ms) against "
          "flash_bwd_dkv + flash_bwd_dq %.4f ms, median (rounds %s; launch "
          "%.4f ms), %s"
          % (med["sdpa"], " ".join("%.4f" % x for x in rounds["sdpa"]),
             launch["sdpa"], med["pair"],
             " ".join("%.4f" % x for x in rounds["pair"]), launch["pair"],
             shape))
    return timings, bnd


def kernel_phase(torch, fa, device):
    """Every kernel check (``kernel_checks``), the backward kernels' bit
    equality over two runs (bf16 and fp16 at the slice's shape, the wide
    family in all three dtypes), and the kernels' times at the slice's
    shape in bf16 and fp16, at the padded shapes, at head dim 128 and at
    the wide shapes. Returns {kind: (largest absolute error at the slice's
    shape by kernel, timings, bounds)} for bf16 and fp16, and for "wide"
    the errors of the check at the wide path's attention
    (``WIDE_PATH_SHAPE``) with the timings at Qwen3-Next-80B-A3B's."""
    failures = []
    for kind, (rtol, atol) in TOLS.items():
        print("limit %s: |kernel - plain| <= %.3g |plain| + %.3g rms(row "
              "of plain), printed as error / limit; lse %.0e absolute"
              % (kind, rtol, atol, LSE_TOL))
    b, h, s, d = SLICE_SHAPE
    slice_abs, wide_abs = {}, {}
    for cb, ch, sq, skv, cd, dtype, causal in kernel_checks(torch, fa):
        errs = compare_kernels(torch, fa, cb, ch, sq, skv, cd, dtype, causal,
                               device)
        kind = KINDS[str(dtype)[6:]]
        pad = fa.padded_head_dim(cd)
        for name, (parts, ab) in errs.items():
            ok = all(r <= 1.0 for _, r in parts)
            print("check %-14s B=%d H=%d Sq=%d Skv=%d D=%d%s %s causal=%s: "
                  "error / limit %s %s"
                  % (name, cb, ch, sq, skv, cd,
                     "" if pad == cd else " (padded to %d)" % pad, kind,
                     causal, ", ".join("%s %.3f" % p for p in parts),
                     "ok" if ok else "FAIL"))
            if not ok:
                failures.append(name)
            if (cb, ch, sq, skv, cd, causal) == (b, h, s, s, d, True):
                slice_abs.setdefault(kind, {})[name] = ab
            if ((cb, ch, sq, cd), kind, causal, sq == skv) == (
                    WIDE_PATH_SHAPE, "bf16", True, True):
                wide_abs[name] = ab
    if failures:
        raise SystemExit("kernel check failed: %s" % sorted(set(failures)))

    # Each dK/dV and dQ element is summed by one block in a fixed order:
    # the slice's shape in bf16 and fp16, the wide family at
    # Qwen3-Next-80B-A3B's attention in all three dtypes, and the Hopper
    # backward at every head dim it is compiled for (ragged, 300 rows).
    wb, wh, ws, wd = dict(WIDE_SHAPES)["Qwen3-Next-80B-A3B"]
    for (cb, ch, cs, cd), dtype in [
            ((b, h, s, d), torch.bfloat16), ((b, h, s, d), torch.float16),
            ((wb, wh, ws, wd), torch.float32),
            ((wb, wh, ws, wd), torch.bfloat16),
            ((wb, wh, ws, wd), torch.float16)] + [
            ((2, 4, 300, dd), dtype) for dd in fa.WIDE_BWD_TILES
            for dtype in (torch.bfloat16, torch.float16)]:
        scale = cd ** -0.5
        q, k, v, do = make_inputs(torch, cb, ch, cs, cs, cd, dtype, device,
                                  SEED)
        o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta, True, scale)
        for name, kern in (("flash_bwd_dkv", fa.flash_bwd_dkv),
                           ("flash_bwd_dq",
                            lambda *a: (fa.flash_bwd_dq(*a),))):
            first, second = kern(*bwd), kern(*bwd)
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            print("check %-14s B=%d H=%d S=%d D=%d %s causal, two runs: %s"
                  % (name, cb, ch, cs, cd, KINDS[str(dtype)[6:]],
                     "bit-equal ok" if same else "differ FAIL"))
            if not same:
                raise SystemExit("kernel check failed: %s is not "
                                 "deterministic in %s at D=%d"
                                 % (name, dtype, cd))
    # The wide Hopper forward's O and lse: each element is written by one
    # block in a fixed order.
    for shape, dtype in ((WIDE_PATH_SHAPE, torch.bfloat16),
                         ((wb, wh, ws, wd), torch.float16),
                         (dict(WIDE_SHAPES)["sarvam-105b"], torch.bfloat16)):
        forward_bit_equal(torch, fa, shape, dtype, device)
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        kind = KINDS[str(dtype)[6:]]
        out[kind] = (slice_abs[kind],) + kernel_times(
            torch, fa, b, h, s, d, dtype, device)
    for label, (pb, ph, ps, pd) in PADDED_SHAPES:
        kernel_times(torch, fa, pb, ph, ps, pd, torch.float16, device,
                     " (%s)" % label)
    kernel_times(torch, fa, *D128_SHAPE, torch.bfloat16, device,
                 " (head dim 128)")
    # The wide family at Qwen3-Next-80B-A3B's attention; the other catalog
    # shapes are timed by tools/flash_wide_times.py (they would take the
    # script past its time).
    out["wide"] = (wide_abs,) + kernel_times(
        torch, fa, wb, wh, ws, wd, torch.bfloat16, device,
        " (Qwen3-Next-80B-A3B, wide)")
    return out


def forward_bit_equal(torch, fa, shape, dtype, device):
    """The forward kernel twice on the same inputs at (B, H, S, D), causal:
    O and lse must be bit-equal."""
    b, h, s, d = shape
    q, k, v, _ = make_inputs(torch, b, h, s, s, d, dtype, device, SEED)
    first = fa.flash_fwd(q, k, v, True, d ** -0.5)
    second = fa.flash_fwd(q, k, v, True, d ** -0.5)
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    print("check %-14s B=%d H=%d S=%d D=%d %s causal, two runs: %s"
          % ("flash_fwd", b, h, s, d, KINDS[str(dtype)[6:]],
             "bit-equal ok" if same else "differ FAIL"))
    if not same:
        raise SystemExit("kernel check failed: flash_fwd is not "
                         "deterministic in %s at D=%d" % (dtype, d))


def parent_library(root, name):
    """The parent tree's library ``name``, built with nvcc from ``root``'s
    ``horovod_tpu_torch/csrc/<name>.cu`` (which includes the parent's own
    headers) into its ``csrc/build``, with every entry point's signature
    set."""
    import ctypes
    from pathlib import Path

    from horovod_tpu_torch.ops import _build

    csrc = Path(root) / "horovod_tpu_torch" / "csrc"
    lib_path = csrc / "build" / ("lib%s_parent.so" % name)
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        _build.nvcc_command(csrc / (name + ".cu"), lib_path),
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit("ab: the parent's %s.cu does not build:\n"
                         % name + proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in _build.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def ab_forward(torch, fa, fn, shape, dtype, device, label):
    """The parent's forward ``fn`` (its library's ``hvd_flash_fwd``)
    against this tree's at (B, H, S, D),
    causal, in turns parent, new, new, parent (each the median of 5 rounds
    of 20, CUDA events). Both sides are the same bare ctypes call of
    ``hvd_flash_fwd`` on the same buffers, so the host's work per call is
    the same. Returns the four times."""
    from horovod_tpu_torch.ops import _build

    b, h, s, d = shape
    q, k, v, _ = make_inputs(torch, b, h, s, s, d, dtype, device, SEED)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, device=device)
    fns = {"parent": fn, "new": _build.load(
        "flash_attention_wide" if fa._wide(d) else "flash_attention")
        .hvd_flash_fwd}

    def call(side):
        err = fns[side](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), b, h, s, s, d,
                        fa._DTYPE_CODES[dtype], 1, d ** -0.5,
                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit("ab forward: the %s kernel failed (%d)"
                             % (side, err))

    def parent():
        call("parent")

    def new():
        call("new")

    turns = [median_ms(torch, fn_, 20) for fn_ in (parent, new, new,
                                                    parent)]
    print("ab forward B=%d H=%d S=%d D=%d %s causal: parent %.4f, new %.4f, "
          "new %.4f, parent %.4f ms (%s)"
          % (b, h, s, d, KINDS[str(dtype)[6:]], *turns, label))
    return turns


def ab_backward(torch, fa, lib, shape, dtype, device, label):
    """The parent library ``lib``'s backward pair (``hvd_flash_bwd_dkv``
    then ``hvd_flash_bwd_dq``) against this tree's at (B, H, S, D), causal,
    on the lse and delta of this tree's forward, in turns parent, new, new,
    parent (each the median of 5 rounds of 20, CUDA events), both through
    the same bare ctypes calls on the same buffers. Returns the four
    times."""
    from horovod_tpu_torch.ops import _build

    b, h, s, d = shape
    scale = d ** -0.5
    q, k, v, do = make_inputs(torch, b, h, s, s, d, dtype, device, SEED)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv, dq = (torch.empty_like(x) for x in (k, v, q))
    libs = {"parent": lib, "new": _build.load(
        "flash_attention_wide" if fa._wide(d) else "flash_attention")}
    code = fa._DTYPE_CODES[dtype]

    def pair(side):
        stream = torch.cuda.current_stream().cuda_stream
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
               lse.data_ptr(), delta.data_ptr())
        errs = (libs[side].hvd_flash_bwd_dkv(
                    *ins, dk.data_ptr(), dv.data_ptr(), b, h, s, s, d, code,
                    1, scale, stream),
                libs[side].hvd_flash_bwd_dq(
                    *ins, dq.data_ptr(), b, h, s, s, d, code, 1, scale,
                    stream))
        if any(errs):
            raise SystemExit("ab backward: the %s kernels failed (%s)"
                             % (side, errs))

    turns = [median_ms(torch, lambda side=side: pair(side), 20)
             for side in ("parent", "new", "new", "parent")]
    print("ab backward B=%d H=%d S=%d D=%d %s causal: parent %.4f, new "
          "%.4f, new %.4f, parent %.4f ms (%s)"
          % (b, h, s, d, KINDS[str(dtype)[6:]], *turns, label))
    # Each side's gradients against the plain version (fp32 sums of the
    # same inputs): mean |error| over mean |plain|, and the limit ratio.
    args = (q, k, v, do, lse, delta, True, scale)
    want = fa.flash_bwd_dkv_plain(*args) + (fa.flash_bwd_dq_plain(*args),)
    rtol, atol = TOLS[str(dtype)[6:]]
    errs = {}
    for side in ("parent", "new"):
        pair(side)
        torch.cuda.synchronize()
        errs[side] = ", ".join(
            "%s %.4e (limit %.3f)" % (
                name, float((g.float() - w.float()).abs().mean()
                            / w.float().abs().mean()),
                limit_ratio(g, w, rtol, atol))
            for name, g, w in zip(("dK", "dV", "dQ"), (dk, dv, dq), want))
    print("ab backward accuracy B=%d H=%d S=%d D=%d %s causal, mean |error| "
          "/ mean |plain|: parent %s; new %s"
          % (b, h, s, d, KINDS[str(dtype)[6:]], errs["parent"], errs["new"]))
    return turns


def parent_forward_ab(torch, fa, root, device):
    """The parent tree's forward kernels against this tree's, in turns
    (``ab_forward``): ``flash_attention.cu``'s at the slice's shape in bf16
    and fp16 and at ``D128_SHAPE`` in bf16, and
    ``flash_attention_wide.cu``'s at Qwen3-Next-80B-A3B's attention in
    bf16; then the wide backward pair there and at the wide path's
    attention (``ab_backward``, with each side's gradient error)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        lib, wide = pool.map(lambda name: parent_library(root, name),
                             ("flash_attention", "flash_attention_wide"))
    for shape, dtype in ((SLICE_SHAPE, torch.bfloat16),
                         (SLICE_SHAPE, torch.float16),
                         (D128_SHAPE, torch.bfloat16)):
        ab_forward(torch, fa, lib.hvd_flash_fwd, shape, dtype, device,
                   "the parent's fwd_wgmma_kernel against this tree's")
    qwen = dict(WIDE_SHAPES)["Qwen3-Next-80B-A3B"]
    ab_forward(torch, fa, wide.hvd_flash_fwd, qwen, torch.bfloat16, device,
               "Qwen3-Next-80B-A3B; the parent's wide forward against "
               "this tree's")
    ab_backward(torch, fa, wide, qwen, torch.bfloat16, device,
                "Qwen3-Next-80B-A3B; the parent's wide backward pair "
                "against this tree's")
    ab_backward(torch, fa, wide, WIDE_PATH_SHAPE, torch.bfloat16, device,
                "the wide path's attention; the parent's wide backward "
                "pair against this tree's")


def sass_ops(path):
    """{kernel: the ops of HGMMA (wgmma) and UTMALDG (TMA loads) its SASS
    holds} for each Hopper kernel (``fwd_wgmma_kernel``,
    ``wide_fwd_wgmma_kernel``, ``wide_dkv_wgmma_kernel`` and
    ``wide_dq_wgmma_kernel``) in the library at ``path`` (``cuobjdump
    -sass``)."""
    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                        "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    found, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if "_wgmma_kernel" in fn:
                found[fn] = set()
        elif fn in found:
            found[fn].update(op for op in ("HGMMA", "UTMALDG") if op in line)
    return found


def wide_config(torch, hvd_models, tiny=False):
    """The wide path: the transformer at Qwen3-Next-80B-A3B's attention
    width (Qwen/Qwen3-Next-80B-A3B-Instruct config.json: 16 heads of
    head_dim 256, so q, k and v are 4096 wide; the port's transformer ties
    the head dim to d_model / n_heads, so d_model is that 4096, not its
    hidden_size 2048), its intermediate_size 5120 and vocab 151936, 2 of
    its 48 layers, all dense with full attention, seq 2048, batch 2,
    bf16, flash attention (``WIDE_PATH_SHAPE``). ``tiny`` keeps 2 heads of
    160 (padded to 192) at seq 64 in fp32 for a CPU rehearsal."""
    if tiny:
        return hvd_models.TransformerConfig(
            vocab_size=256, d_model=320, n_heads=2, n_layers=2, d_ff=128,
            max_seq_len=64, dtype=torch.float32, attention="flash"), 2, 64
    b, h, s, d = WIDE_PATH_SHAPE
    return hvd_models.TransformerConfig(
        vocab_size=151936, d_model=h * d, n_heads=h, n_layers=2, d_ff=5120,
        max_seq_len=s, dtype=torch.bfloat16, attention="flash"), b, s


def wide_phase(torch, hvd, hvd_models, fa, device, card, errors,
               tiny=False):
    """The wide path through the entry points a user calls: the
    transformer of ``wide_config`` trained ``WIDE_STEPS`` steps with
    ``DistributedOptimizer(AdamW)``, the launch counters zeroed just before
    and read just after; then the same steps from the same seed with dense
    attention. Checks the loss is finite and falls, each step's loss
    within ``WIDE_LOSS_RTOL`` of dense attention's, and each attention
    kernel launched once a layer a step (0 on the CPU). Returns the
    launches by kernel."""
    cfg, batch, seq = wide_config(torch, hvd_models, tiny)

    def train(attention):
        gen = torch.Generator(device=device).manual_seed(SEED)
        model = hvd_models.Transformer(
            dataclasses.replace(cfg, attention=attention), device=device,
            generator=gen)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device=device)
        # At d_model 4096 AdamW's lr 1e-3 overshoots: the loss went 12.79,
        # 8.62, 12.17 with flash and with dense attention alike.
        opt = hvd.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        losses = []
        for _ in range(WIDE_STEPS):
            loss = hvd_models.lm_loss(model(tokens), tokens)
            loss.backward()
            opt.step()
            opt.zero_grad()
            losses.append(float(loss))
        return losses

    fa.reset_launches()
    losses = train("flash")
    launches = {f.__name__: f.launches for f in fa.KERNELS}
    head_dim = cfg.d_model // cfg.n_heads
    want = cfg.n_layers * WIDE_STEPS if device.startswith("cuda") else 0
    print("wide: transformer d_model %d, %d heads of %d (run at %d), %d "
          "layers, B=%d S=%d %s: losses %s; launches %s, on %s"
          % (cfg.d_model, cfg.n_heads, head_dim, fa.padded_head_dim(head_dim),
             cfg.n_layers, batch, seq, KINDS[str(cfg.dtype)[6:]],
             " ".join("%.4f" % x for x in losses), launches, card))
    ok = all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
    print("check wide loss: %s" % ("ok" if ok else "FAIL"))
    if not ok:
        errors.append("wide: losses %s" % losses)
    dense = train("dense")
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, dense))
    ok = rel <= WIDE_LOSS_RTOL
    print("check wide vs dense: dense attention's losses %s, largest "
          "relative difference %.3e (limit %.0e): %s"
          % (" ".join("%.4f" % x for x in dense), rel, WIDE_LOSS_RTOL,
             "ok" if ok else "FAIL"))
    if not ok:
        errors.append("wide: flash losses %s, dense %s" % (losses, dense))
    if device.startswith("cuda"):
        # The two models (vocab 151936) leave tens of GB in the caching
        # allocator; the later phases, and the workers they spawn on the
        # same card, need none of it.
        torch.cuda.empty_cache()
    for name, n in launches.items():
        if n != want:
            errors.append("wide: %s launched %d times, expected %d"
                          % (name, n, want))
    print("check wide launches: %s" % (
        "ok" if all(n == want for n in launches.values()) else "FAIL"))
    return launches


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
              num_experts=0, wrap=None, dtype=None):
    """Train ``steps`` steps on one fixed batch; returns losses, launch
    counts, bucket count, the steady-state step time (ms), the host's
    time to issue one step (ms, no synchronisation inside the step) and
    ``step``, a closure that runs one more step. ``num_experts`` > 0
    puts MoE layers in place of the MLPs; ``wrap`` makes the distributed
    optimizer from the inner one (default ``hvd.DistributedOptimizer``);
    ``dtype`` replaces the compute dtype."""
    import dataclasses

    cfg, batch, seq = slice_config(torch, hvd_models, tiny)
    cfg = dataclasses.replace(cfg, num_experts=num_experts,
                              dtype=dtype or cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(SEED)
    model = hvd_models.Transformer(cfg, device=device, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device)
    opt = (wrap or hvd.DistributedOptimizer)(torch.optim.AdamW(
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
                step_ms=step_ms, host_ms=host_ms, model=model, step=step,
                opt=opt)


TUNE_SLICE_STEPS = 3
_TUNE_ENV = ("HVD_FLASH_TUNE", "HVD_FLASH_TUNE_CACHE", "HVD_FLASH_BLOCK_Q",
             "HVD_FLASH_BLOCK_K", "HVD_FLASH_TUNE_CANDIDATES",
             "HVD_FLASH_TUNE_ITERS")


def tune_phase(torch, hvd, hvd_models, fa, device, card, errors,
               slice_losses, tiny=False):
    """The flash tile tuner (``ops/block_tuner.py``) at the slice's
    attention shape, with a cache in a temporary directory: under
    ``HVD_FLASH_TUNE=1`` the first ``flash_attention`` call tunes and
    writes one record (the card's key, the compiled tile), a second call
    hits the cache (the trials counter does not move),
    ``HVD_FLASH_TUNE=cache`` reads the record, ``HVD_FLASH_BLOCK_Q=128``
    raises on the card, and the slice's model under
    ``HVD_FLASH_TUNE=cache`` gives phase 4's first losses bit for bit."""
    import shutil
    import tempfile

    from horovod_tpu_torch.ops import block_tuner
    from horovod_tpu_torch.utils import metrics

    def check(name, ok, detail):
        print("check tune %s: %s: %s" % (name, detail, "ok" if ok
                                          else "FAIL"))
        if not ok:
            errors.append("tune %s: %s" % (name, detail))

    def trials():
        return metrics.value("hvd_flash_tuner_trials_total") or 0

    def fresh_fold():
        block_tuner._mem_cache, block_tuner._mem_cache_path = {}, None

    b, h, s, d = (2, 4, 64, 16) if tiny else SLICE_SHAPE
    cfg, _, _ = slice_config(torch, hvd_models, tiny)
    saved = {key: os.environ.pop(key, None) for key in _TUNE_ENV}
    tmp = tempfile.mkdtemp(prefix="hvd_flash_tune_")
    path = os.path.join(tmp, "flash_blocks.jsonl")
    try:
        os.environ["HVD_FLASH_TUNE"] = "1"
        os.environ["HVD_FLASH_TUNE_CACHE"] = path
        fresh_fold()
        gen = torch.Generator(device=device).manual_seed(SEED)
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device)
                   .to(cfg.dtype) for _ in range(3))
        pairs = block_tuner.candidate_pairs(s, s, device=device)
        before = trials()
        t0 = time.perf_counter()
        fa.flash_attention(q, k, v, causal=True)
        tune_s = time.perf_counter() - t0
        tuned = trials() - before
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        key = block_tuner.shape_key(s, s, d, cfg.dtype, True,
                                    block_tuner._device_kind(device))
        check("record", len(pairs) == 1 and tuned == 1 and len(recs) == 1
              and recs[0]["key"] == key
              and (recs[0]["block_q"], recs[0]["block_k"]) == pairs[0],
              "HVD_FLASH_TUNE=1 at B=%d S=%d H=%d D=%d %s: candidates %s, "
              "%d trial(s) in %.3f s, records %s (want key %s)"
              % (b, s, h, d, KINDS[str(cfg.dtype)[6:]], pairs, tuned,
                 tune_s, recs, key))
        before = trials()
        fa.flash_attention(q, k, v, causal=True)
        check("hit", trials() == before,
              "a second call: trials counter %d -> %d" % (before, trials()))
        os.environ["HVD_FLASH_TUNE"] = "cache"
        fresh_fold()
        got = block_tuner.best_blocks(s, s, d, cfg.dtype, True,
                                      device=device)
        check("cache", got == pairs[0],
              "HVD_FLASH_TUNE=cache reads %s" % (got,))
        os.environ["HVD_FLASH_BLOCK_Q"] = "128"
        try:
            fa.flash_attention(q, k, v, causal=True)
            raised = None
        except ValueError as e:
            raised = str(e)
        del os.environ["HVD_FLASH_BLOCK_Q"]
        if device == "cpu":
            print("check tune block 128: not checked on the CPU (the "
                  "plain version takes any tile)")
        else:
            check("block 128", raised is not None,
                  "HVD_FLASH_BLOCK_Q=128 raised %r" % (raised,))
        res = run_slice(torch, hvd, hvd_models, fa, device,
                        TUNE_SLICE_STEPS, tiny)
        want = slice_losses[:TUNE_SLICE_STEPS]
        check("slice", res["losses"] == want,
              "transformer_long under HVD_FLASH_TUNE=cache, %d steps, "
              "losses %s (phase 4: %s), launches %s, on %s"
              % (TUNE_SLICE_STEPS, res["losses"], want, res["launches"],
                 card))
    finally:
        for key, val in saved.items():
            os.environ.pop(key, None)
            if val is not None:
                os.environ[key] = val
        fresh_fold()
        shutil.rmtree(tmp, ignore_errors=True)


def fp16_slice_phase(torch, hvd, hvd_models, fa, device, card, errors,
                     tiny=False):
    """``transformer_long`` at full width with fp16 compute for
    ``FP16_SLICE_STEPS`` steps, every launch counter zeroed just before
    and read just after: the loss falls, every loss is finite, and each
    attention kernel launches once a layer a step. Returns the
    ``run_slice`` result."""
    steps = FP16_SLICE_STEPS
    res = run_slice(torch, hvd, hvd_models, fa, device, steps, tiny,
                    dtype=torch.float16)
    losses, cfg = res["losses"], res["cfg"]
    want = cfg.n_layers * steps if device != "cpu" else 0
    ok = (cfg.dtype == torch.float16
          and all(math.isfinite(x) for x in losses)
          and losses[-1] < losses[0]
          and all(n == want for n in res["launches"].values()))
    print("check fp16 slice: transformer_long B=%d S=%d layers=%d fp16, "
          "%d steps, losses %s, launches %s (want %d each), step %s ms, "
          "on %s: %s"
          % (res["batch"], res["seq"], cfg.n_layers, steps,
             " ".join(repr(x) for x in losses), res["launches"], want,
             "%.3f" % res["step_ms"] if res["step_ms"] else "not measured",
             card, "ok" if ok else "FAIL"))
    if not ok:
        errors.append("fp16 slice: losses %s, launches %s"
                      % (losses, res["launches"]))
    return res


def introspect_checks(torch, res, card, errors):
    """``horovod_tpu_torch.introspect`` on the slice's step: the
    collectives one step dispatches (torch.profiler's c10d events) must be
    one allreduce a bucket, and one step must update every parameter and
    every AdamW state tensor in place (``data_ptr()`` before and after)."""
    from horovod_tpu_torch import introspect

    try:
        counts = introspect.assert_bucketed_gradient_sync(
            res["step"], min_buckets=min(2, res["buckets"]))
        donated = introspect.assert_donation_survives_lowering(
            res["step"], res["opt"])
    except AssertionError as e:
        errors.append("introspect: %s" % e)
        print("check introspect: FAIL (%s)" % e)
        return
    ok = counts == {"allreduce_": res["buckets"]}
    print("check introspect: one step dispatched %s (%d buckets); %d "
          "tensors updated in place (parameters and AdamW state), on %s: %s"
          % (counts, res["buckets"], len(donated), card,
             "ok" if ok else "FAIL"))
    if not ok:
        errors.append("introspect: the step dispatched %s for %d buckets"
                      % (counts, res["buckets"]))



# --------------------------------------------------------------- launch ---

LAUNCH_STEPS = 3            # the slice's steps through the launcher
LAUNCH_ELASTIC_STEPS = 8
LAUNCH_FAIL_STEP = 5        # the elastic worker exits once, at this step
LAUNCH_CKPT_INTERVAL = 2
LAUNCH_REFUSE_SEC = 10.0
LAUNCH_TIMEOUT_SEC = 300


def _launch_result(text):
    """The ``LAUNCH_RESULT`` object a worker printed (the launcher puts
    ``[rank]<stdout>: `` before it), or None."""
    for line in text.splitlines():
        if "LAUNCH_RESULT " in line:
            return json.loads(line.split("LAUNCH_RESULT ", 1)[1])
    return None


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def launch_phase(torch, card, errors, slice_losses, n_layers,
                 platform="gpu", tiny=False):
    """The port's launcher, ``run`` and elastic driver on the card, each
    in processes of its own (see the module docstring, 4b). ``platform``
    ``cpu`` and ``tiny`` rehearse it on the CPU."""
    import shutil
    import stat
    import tempfile

    from horovod_tpu_torch.runner.journal import journal_path

    root = os.path.dirname(os.path.abspath(__file__))
    tests = os.path.join(root, "tests")
    worker = os.path.join(tests, "torch_port_launch_worker.py")
    launcher = [sys.executable, "-m", "horovod_tpu_torch.runner"]
    path = os.pathsep.join([root, tests] + [p for p in [os.environ.get(
        "PYTHONPATH")] if p])
    env = dict(os.environ, PYTHONPATH=path)
    if tiny:
        env["LAUNCH_TINY"] = "1"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    gpu = platform == "gpu"

    def check(name, ok, detail):
        print("check launch %s: %s: %s" % (name, detail,
                                          "ok" if ok else "FAIL"))
        if not ok:
            errors.append("launch: %s: %s" % (name, detail))

    def launch(args, extra=None, timeout=LAUNCH_TIMEOUT_SEC):
        return subprocess.run(launcher + args, cwd=root,
                              env=dict(env, **(extra or {})),
                              capture_output=True, text=True,
                              timeout=timeout)

    def tail(out):
        return (out.stdout[-2000:] + out.stderr[-2000:]).replace("\n",
                                                                 " | ")

    tmp = tempfile.mkdtemp(prefix="hvd_launch_")
    phase_t0 = time.perf_counter()
    try:
        # (a) --check-build.
        out = launch(["--check-build"], timeout=120)
        for line in out.stdout.splitlines():
            if line.strip():
                print("launch: check-build | " + line)
        rows = out.stdout.splitlines()
        want = (["[X] CUDA", "%d card(s)" % cards, "[X] NCCL"] if gpu
                else ["[X] gloo"])
        want += ["[X] %s.cu" % lib for lib in (
            "flash_attention", "flash_attention_wide", "fusion", "adasum",
            "codec")] if gpu else []
        missing = [w for w in want if not any(w in r for r in rows)]
        check("check-build", out.returncode == 0 and not missing
              and (cards >= 1 or not gpu) and "JAX" not in out.stdout,
              "rc %d, %d card(s), missing rows %s"
              % (out.returncode, cards, missing))

        # (b) The main path through the launcher, -np 1.
        t0 = time.time()
        out = launch(["-np", "1", "--platform", platform, sys.executable,
                      worker, "slice"],
                     {"LAUNCH_STEPS": str(LAUNCH_STEPS)})
        res = _launch_result(out.stdout)
        if res is None:
            check("slice", False, "rc %d, no result: %s"
                  % (out.returncode, tail(out)))
        else:
            want_launches = n_layers * LAUNCH_STEPS if gpu else 0
            start_s = res["t_first_step"] - t0
            print("launch: -np 1 transformer_long, %d steps, losses %s "
                  "(phase 4: %s), launches %s on %s; %.3f s from the "
                  "launcher's start to the worker's first step (the "
                  "worker's process started at %.3f s, its imports done "
                  "at %.3f s, init at %.3f s, then the model), on %s"
                  % (LAUNCH_STEPS, res["losses"],
                     slice_losses[:LAUNCH_STEPS], res["launches"],
                     res["device"], start_s, res["t_started"] - t0,
                     res["t_imported"] - t0, res["t_initialized"] - t0,
                     card))
            check("slice losses", out.returncode == 0 and
                  res["losses"] == slice_losses[:LAUNCH_STEPS],
                  "rc %d, bit for bit against phase 4's first %d"
                  % (out.returncode, LAUNCH_STEPS))
            check("slice launches", all(
                n == want_launches for n in res["launches"].values()),
                "%s, %d each expected" % (res["launches"], want_launches))
            check("slice device", res["device"] ==
                  ("cuda:0" if gpu else "cpu") and not res["jax"],
                  "%s, jax imported: %s" % (res["device"], res["jax"]))

        # (c) run() of a module-level function.
        sys.path.insert(0, tests)
        try:
            import torch_port_launch_worker as launch_worker

            import horovod_tpu_torch as hvd_root

            got = hvd_root.run(launch_worker.report, np=1,
                               env={"PYTHONPATH": path}, platform=platform)
        finally:
            sys.path.remove(tests)
        check("run", len(got) == 1 and got[0]["device"] ==
              ("cuda:0" if gpu else "cpu") and not got[0]["jax"]
              and got[0]["sum"] == [1.0] * 4,
              "horovod_tpu_torch.run(report, np=1) -> %s" % got)

        # (d) More slots than cards: refused before any worker starts.
        marker = os.path.join(tmp, "spawned")
        t1 = time.perf_counter()
        out = launch(["-np", str(cards + 1), "--platform", "gpu",
                      sys.executable, "-c",
                      "open(%r, 'w').close()" % marker], timeout=60)
        refuse_s = time.perf_counter() - t1
        check("refusal", out.returncode != 0 and refuse_s <
              LAUNCH_REFUSE_SEC and not os.path.exists(marker) and
              "%d CUDA card(s)" % cards in out.stderr,
              "-np %d on %d card(s): rc %d in %.3f s, a worker spawned: "
              "%s; %s" % (cards + 1, cards, out.returncode, refuse_s,
                          os.path.exists(marker), out.stderr.strip()))

        # (e) The elastic driver: a worker exits, is respawned, resumes.
        script = os.path.join(tmp, "discover.sh")
        with open(script, "w") as f:
            f.write("#!/bin/sh\necho localhost:1\n")
        os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)

        def elastic(name, fail):
            log_dir = os.path.join(tmp, name)
            os.makedirs(log_dir)
            extra = {"LAUNCH_LOG_DIR": log_dir,
                     "LAUNCH_CKPT_DIR": os.path.join(log_dir, "ckpt"),
                     "LAUNCH_STEPS": str(LAUNCH_ELASTIC_STEPS),
                     "LAUNCH_CKPT_INTERVAL": str(LAUNCH_CKPT_INTERVAL)}
            if fail:
                extra["LAUNCH_FAIL_STEP"] = str(LAUNCH_FAIL_STEP)
            journal = os.path.join(log_dir, "journal")
            out = launch(["--platform", platform, "--min-np", "1",
                          "--max-np", "1", "--host-discovery-script",
                          script, "--journal-dir", journal,
                          sys.executable, worker, "elastic"], extra)
            log = os.path.join(log_dir, "elastic.log")
            records = _jsonl(log) if os.path.exists(log) else []
            entries = _jsonl(journal_path(journal)) \
                if os.path.exists(journal_path(journal)) else []
            return out, records, entries

        whole, whole_log, _ = elastic("whole", False)
        failed, fail_log, journal = elastic("failed", True)

        def final(records):
            return next((r for r in records if r["event"] == "final"), {})

        exits = [r for r in fail_log if r["event"] == "exit"]
        resumed = [r for r in fail_log if r["event"] == "first_step"
                   and r["version"] == 2]
        respawn_s, spawn_s = (
            (resumed[0]["t"] - exits[0]["t"],
             resumed[0]["started"] - exits[0]["t"])
            if exits and resumed else (float("nan"), float("nan")))
        print("launch: elastic transformer_long, %d steps, a checkpoint "
              "every %d; the worker exited at step %s, the driver "
              "respawned it at version %s, which resumed from step %s; "
              "%.3f s from the exit to its first step after the restore "
              "(its process started at %.3f s), on %s; losses after the "
              "resume %s, uninterrupted %s"
              % (LAUNCH_ELASTIC_STEPS, LAUNCH_CKPT_INTERVAL,
                 [r["step"] for r in exits],
                 [r["version"] for r in resumed],
                 [r["resumed_from"] for r in resumed], respawn_s, spawn_s,
                 card,
                 final(fail_log).get("losses"),
                 final(whole_log).get("losses")))
        check("elastic runs", whole.returncode == 0 and
              failed.returncode == 0, "rc %d and %d%s" % (
                  whole.returncode, failed.returncode,
                  "" if whole.returncode == failed.returncode == 0
                  else ": " + tail(failed)))
        check("elastic respawn", [r["step"] for r in exits] ==
              [LAUNCH_FAIL_STEP] and len(resumed) == 1 and
              resumed[0]["resumed_from"] == LAUNCH_FAIL_STEP - 1,
              "exits %s, resumed %s" % (exits, resumed))
        same = (final(fail_log).get("checksum") is not None and
                final(fail_log).get("checksum") ==
                final(whole_log).get("checksum"))
        check("elastic weights", same and final(fail_log).get("step") ==
              LAUNCH_ELASTIC_STEPS,
              "checksum %s, uninterrupted %s"
              % (final(fail_log).get("checksum"),
                 final(whole_log).get("checksum")))
        kinds = [(e["type"], e.get("version", e.get("rc")))
                 for e in journal]
        check("elastic journal",
              [v for t, v in kinds if t == "rendezvous"] == [1, 2] and
              [v for t, v in kinds if t == "exit"] == [1, 0], kinds)
        print("launch: the phase took %.1f s" % (time.perf_counter()
                                                  - phase_t0))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

# (family, substring of the lowercased kernel name), first match wins:
# the convolution keys come before the matmul ones, since cuDNN's
# implicit-GEMM convolutions also carry "xmma", "cutlass" or "gemm".
KERNEL_FAMILIES = (("fusion", "fusionkernel"),
                   ("flash_bwd_dkv", "wide_dkv_wgmma_kernel"),
                   ("flash_bwd_dq", "wide_dq_wgmma_kernel"),
                   ("flash_bwd_dq", "wide_dq_rows_wgmma_kernel"),
                   ("flash_fwd", "none_rows_kernel"),
                   ("flash_fwd", "wide_fwd_kernel"),
                   ("flash_bwd_dkv", "wide_dkv_kernel"),
                   ("flash_bwd_dq", "wide_dq_kernel"),
                   ("flash_fwd", "wide_fwd_wgmma_kernel"),
                   ("flash_fwd", "fwd_wgmma_kernel"),
                   ("flash_fwd", "fwd_kernel"),
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
TENSOR_CORE_KERNELS = {"flash_fwd": ["fwd_wgmma_kernel"],
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
    losses, step and host ms (and each step's ms on the card's clock), the
    core's and the executor's counts over the steps, the kernel launches,
    ``step`` and its model and batch."""
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
    step_ms, each_ms = None, None
    if cuda:
        step_ms = marks[EAGER_WARM].elapsed_time(marks[-1]) \
            / (steps - EAGER_WARM)
        each_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return dict(
        batch=batch, px=px, losses=[float(x) for x in losses],
        step_ms=step_ms, each_ms=each_ms,
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


# ---------------------------------------------------------------- codec ---

# The simulated ring's members: the card holds 4 ranks' gradients.
CODEC_RANKS = 4
CODEC_STEPS = 6
CODEC_NAMES = ("bf16", "fp16", "int8")
# decode_reduce's ops: Sum (Average and Adasum sum too), Min, Max, Product
# (core/src/common.h ReduceOp) and the allgather's copy (ops/codec.py).
CODEC_OPS = {"sum": 1, "min": 3, "max": 4, "product": 5, "copy": -1}
# The limit each codec's ring is held to against the exact sum:
# WIRE_TOLERANCE as the JAX package's equality worker applies it (atol
# times the members, rtol). The core's fp16 TRUNCATES (codec.h
# FloatToHalf), an error below 2^-10 of each encoded value, where the
# table's fp16 row assumes rounding (2^-11): on zero-mean data, where the
# sum cancels, the ring's error can pass the row's rtol, in the core as
# here (the two agree bit for bit). fp16 is held to its truncation bound:
# at each of the members' encodes (n - 1 hops and the allgather's) at
# most 2^-10 of a partial sum, each no larger than the sum of the
# members' magnitudes, plus fp32's rounding of the sums and fp16's
# subnormal step; its table ratio is printed beside it.
CODEC_LIMIT = {"bf16": "WIRE_TOLERANCE", "fp16": "truncation",
               "int8": "WIRE_TOLERANCE"}
# Each kernel's bytes per element, each input read and each output
# written once: encode reads 4 and writes the wire; decode-reduce reads
# the wire and the fp32 range and writes it; the feedback reads x and r
# and writes both.
CODEC_WIRE = {"bf16": 2, "fp16": 2, "int8": 1}
# Block sizes of the phase checks: around the kernels' 4-value accesses,
# their head and their tail.
CODEC_SMALL = range(68)
# fp32 bit patterns per slice of the exhaustive conversion checks, and
# all of them (a CPU rehearsal sets fewer).
CODEC_SLICE = 1 << 26
CODEC_SPAN = 1 << 32
# The phases (fp32 elements past a 16-byte boundary) at which the ring's
# steps find their chunks at full width: chunk 0 at 0, chunk 1 at
# 6,389,258 = 2 (mod 4); the kernels are timed at both.
CODEC_PHASES = (0, 2)


def codec_edge_blocks(torch, codec, device):
    """fp32 blocks where codec.cc's arithmetic has its corners: zeros, NaN
    first, in the middle, last, alone, in several chunks of the int8 max
    pass and on a chunk's last element, infinities, subnormals, fp16
    overflow, bf16 halfway values (ties to even, the largest finite
    value, a NaN whose bits wrap), int8 ties, and blocks of 0, 1 and
    ``CODEC_RANKS - 1`` elements."""
    nan, inf, chunk = float("nan"), float("inf"), codec.CHUNK
    gen = torch.Generator().manual_seed(SEED + 9)

    def wide(n, nans=()):
        x = torch.randn(n, generator=gen) * 3
        for i in nans:
            x[i] = nan
        return x

    bits = torch.tensor([0x3F808000, 0x3F818000, 0x3F80FFFF, 0x7F7FFFFF,
                         -0x80800000, 0x7FFFFFFF],
                        dtype=torch.int64).to(torch.int32).view(
                            torch.float32)
    blocks = {
        "zeros": torch.zeros(17),
        "nan first": torch.tensor([nan, 1.0, -5.0, 2.0]),
        "nan middle": torch.tensor([100.0, nan, 1.0, -5.0, 2.0]),
        "nan last": torch.tensor([1.0, -5.0, 2.0, nan]),
        "nan only": torch.tensor([nan, nan]),
        "nan at a chunk's end": wide(3 * chunk + 5, [chunk - 1]),
        "nans in two chunks": wide(3 * chunk + 5, [10, 2 * chunk + 7]),
        "nan last of 3 chunks": wide(2 * chunk + 9, [2 * chunk + 8]),
        "infinities": torch.tensor([1.0, inf, -2.0, -inf]),
        "subnormals": torch.tensor([1e-40, -3e-41, 1e-45, 0.0]),
        "tiny": torch.tensor([1e-45, -1e-45]),
        "fp16 overflow": torch.tensor([7e4, -1e5, 65504.0, 65520.0, 1e-8,
                                       6e-5, -6e-8]),
        "bf16 halfway": bits,
        "int8 ties": torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]),
        "empty": torch.zeros(0),
        "one": torch.tensor([-3.5]),
        "n - 1": torch.tensor([0.25, -7.0, 3.0])[:CODEC_RANKS - 1],
    }
    return {k: v.to(device) for k, v in blocks.items()}


def codec_kernel_checks(torch, codec, counts, device):
    """Each kernel against its plain version on the card, bit for bit: on
    one fused response of every gradient (25.56M values at full width)
    for each codec, encode, and decode-reduce of the kernel's wire bytes
    for each op; the feedback over all the gradients as segments, three
    steps; and every edge block, alone for encode and decode-reduce, and
    all together (as segments, with residuals) for the feedback. Returns
    the failures, the comparisons and the largest error of each
    kernel."""
    from horovod_tpu_torch.ops import fusion

    failures, compared = [], 0
    worst = dict.fromkeys(codec.LAUNCHES, 0.0)
    x = adasum_values(torch, counts, SEED + 7, device)
    blocks = codec_edge_blocks(torch, codec, device)
    dst = adasum_values(torch, [max([x.numel()] + [
        b.numel() for b in blocks.values()])], SEED + 8, device)
    for name in CODEC_NAMES:
        cid = codec.CODECS[CODEC_NAMES.index(name)]
        for label, src in [("all %d gradients" % len(counts), x)] + \
                sorted(blocks.items()):
            nbytes = codec.wire_bytes(cid, src.numel())
            got = torch.zeros(nbytes + 16, dtype=torch.uint8, device=device)
            want = torch.zeros_like(got)
            codec.encode(cid, src, got)
            codec.plain_encode(cid, src, want)
            compared += 1
            if not _held(worst, "codec_encode", got, want):
                failures.append("codec_encode %s, %s" % (name, label))
            for oname, op in CODEC_OPS.items():
                a, b = dst[:src.numel()].clone(), dst[:src.numel()].clone()
                if label == "n - 1" and a.numel():
                    a[0] = b[0] = float("nan")
                codec.decode_reduce(cid, got, a, op)
                codec.plain_decode_reduce(cid, got, b, op)
                compared += 1
                if not _held(worst, "codec_decode_reduce", a, b):
                    failures.append("codec_decode_reduce %s %s, %s"
                                    % (name, oname, label))
    offsets = fusion.offsets_of(counts)
    for label, segs in (("all %d gradients" % len(counts),
                         [(o, c) for o, c in zip(offsets, counts)]),
                        ("the edge blocks", None)):
        if segs is None:
            xs0 = [b.clone() for b in blocks.values()]
        else:
            xs0 = [x[o:o + c].clone() for o, c in segs]
        rs_k = [torch.zeros_like(t) for t in xs0]
        rs_p = [torch.zeros_like(t) for t in xs0]
        for step in range(3):
            scale = 1.0 + 0.5 * step
            xs_k = [t * scale for t in xs0]
            xs_p = [t.clone() for t in xs_k]
            codec.error_feedback(xs_k, rs_k)
            codec.plain_error_feedback(xs_p, rs_p)
            compared += 1
            if not all(_held(worst, "codec_error_feedback", a, b)
                       for a, b in zip(xs_k + rs_k, xs_p + rs_p)):
                failures.append("codec_error_feedback step %d on %s"
                                % (step, label))
    torch.cuda.synchronize()
    return failures, compared, worst


def _at_phase(torch, values, phase):
    """``values`` copied into a fresh storage ``phase`` fp32 elements past
    its start (the storage starts on 16 bytes or more), and that storage."""
    store = torch.zeros(values.numel() + 4, dtype=values.dtype,
                        device=values.device)
    view = store[phase:phase + values.numel()]
    view.copy_(values)
    return view, store


def _wire_store(torch, codec, cid, count, phase, device):
    """A zeroed storage and in it the wire bytes of a ``count``-value block
    whose wire element 0 has ``phase`` in its word (``wire_pad``, as the
    ring places a chunk at fp32 phase ``phase``)."""
    size = codec.wire_bytes(cid, count)
    store = torch.zeros(size + 32, dtype=torch.uint8, device=device)
    off = codec.wire_pad(cid, 4 * phase, store.data_ptr())
    return store[off:off + size], store


class _Differs:
    """Bit comparisons queued on the card, read back at once."""

    def __init__(self, torch):
        self.torch, self.queued = torch, []

    def add(self, label, got, want):
        t = self.torch
        self.queued.append((label, t.ne(got.view(t.uint8),
                                        want.view(t.uint8)).any()))

    def failures(self):
        if not self.queued:
            return []
        flags = self.torch.stack([f for _, f in self.queued]).cpu().tolist()
        return [label for (label, _), bad in zip(self.queued, flags) if bad]


def codec_block_checks(torch, codec, differs, label, cid, src, f32_phase,
                       wire_phase, dst_values):
    """Encode ``src`` (fp32, placed at ``f32_phase``) with the kernel and
    the plain version into wire bytes at ``wire_phase``, then decode-reduce
    the kernel's bytes with every op and COPY into ``dst_values`` placed at
    ``f32_phase``, kernel against plain; every comparison over the whole
    storage, so a byte written outside its block shows."""
    device = src.device
    n = src.numel()
    x, _ = _at_phase(torch, src, f32_phase)
    got, got_store = _wire_store(torch, codec, cid, n, wire_phase, device)
    want, want_store = _wire_store(torch, codec, cid, n, wire_phase, device)
    codec.encode(cid, x, got)
    codec.plain_encode(cid, x, want)
    differs.add("codec_encode %s" % label, got_store, want_store)
    for oname, op in CODEC_OPS.items():
        a, a_store = _at_phase(torch, dst_values[:n], f32_phase)
        b, b_store = _at_phase(torch, dst_values[:n], f32_phase)
        codec.decode_reduce(cid, got, a, op)
        codec.plain_decode_reduce(cid, got, b, op)
        differs.add("codec_decode_reduce %s %s" % (oname, label), a_store,
                    b_store)


def codec_phase_checks(torch, codec, counts, device):
    """Encode and decode-reduce (``CODEC_OPS``: every op and COPY) against
    the plain versions, bit for bit, for each codec: blocks of 0-67 values
    (around the 4-value accesses, the head and the tail) with the fp32
    block at phases 0-3 and the wire at every phase (its slot's phase among
    them: the vector, pair and scalar launches); the ring's real chunks 0
    and 1 of all the gradients (element offsets 0 and 6,389,258 at full
    width: phases 0 and 2) with the wire at its slot's phase; and the edge
    blocks at fp32 phases 0-3, the wire at its slot's phase. Returns the
    failures and the comparisons."""
    differs = _Differs(torch)
    gen = torch.Generator().manual_seed(SEED + 21)
    blocks = codec_edge_blocks(torch, codec, device)
    total = sum(counts)
    x = adasum_values(torch, counts, SEED + 22, device)
    dst = adasum_values(torch, [total], SEED + 23, device)
    dst[0] = float("nan")
    chunk_counts, offsets = codec.partition(total, CODEC_RANKS)
    for name in CODEC_NAMES:
        cid = codec.CODECS[CODEC_NAMES.index(name)]
        for n in CODEC_SMALL:
            src = torch.randn(n, generator=gen) * 3
            if n and n % 4 == 1:
                src[int(torch.randint(n, (1,), generator=gen))] = \
                    float("nan")
            elif n and n % 4 == 2:
                src[-1] = float("nan")
            elif n > 2 and n % 4 == 3:
                src[0], src[-1] = float("inf"), 1e-40
            src = src.to(device)
            for fp in range(4):
                for wp in range(4):
                    codec_block_checks(
                        torch, codec, differs, "%s, %d values, fp32 phase "
                        "%d, wire phase %d" % (name, n, fp, wp), cid, src,
                        fp, wp, dst)
        for c in (0, 1):
            chunk = x[offsets[c]:offsets[c] + chunk_counts[c]]
            phase = (chunk.data_ptr() // 4) % 4
            codec_block_checks(
                torch, codec, differs, "%s, the ring's chunk %d (phase %d)"
                % (name, c, phase), cid, chunk, phase, phase, dst)
        for label, src in sorted(blocks.items()):
            for fp in range(4):
                codec_block_checks(
                    torch, codec, differs, "%s, %s at phase %d"
                    % (name, label, fp), cid, src, fp, fp, dst)
    torch.cuda.synchronize()
    return differs.failures(), len(differs.queued)


def core_half_to_float(torch, h):
    """core/src/codec.h HalfToFloat on int64 half bits, as int64 fp32
    bits, in integer operations (the core's subnormal loop unrolled)."""
    sign = (h & 0x8000) << 16
    exp = (h >> 10) & 0x1F
    mant = h & 0x3FF
    m, shift = mant.clone(), torch.zeros_like(mant)
    for _ in range(10):
        grow = (exp == 0) & (m != 0) & ((m & 0x400) == 0)
        m = torch.where(grow, m << 1, m)
        shift += grow.to(shift.dtype)
    sub = sign | ((127 - 15 + 1 - shift) << 23) | ((m & 0x3FF) << 13)
    return torch.where(
        exp == 0, torch.where(mant == 0, sign, sub),
        torch.where(exp == 0x1F, sign | 0x7F800000 | (mant << 13),
                    sign | ((exp - 15 + 127) << 23) | (mant << 13)))


def codec_conversion_checks(torch, codec, device):
    """The kernels' conversions, exhaustively. Every one of the 2^32 fp32
    bit patterns through the fp16 and the bf16 encode, in slices of
    ``CODEC_SLICE`` values, against the plain versions (fusion's
    ``_float_to_half`` and ``_float_to_bf16``); every one of the 65,536
    halves through the fp16 decode-reduce: COPY, the kernel's and the
    plain version's, against the core's HalfToFloat
    (``core_half_to_float``), and every op against the plain version on
    all but the NaN halves, where an op's result is a NaN of the card's
    own; every bf16 pattern through COPY against the plain version.
    Returns {check: differing values}, the values compared and the NaN
    halves where the plain version's bits differ from the core's."""
    from horovod_tpu_torch.ops import fusion

    fp16, bf16 = codec.FP16, codec.BF16
    wire = torch.empty(2 * CODEC_SLICE, dtype=torch.uint8, device=device)
    bad = {"fp16 encode": torch.zeros((), dtype=torch.int64, device=device),
           "bf16 encode": torch.zeros((), dtype=torch.int64, device=device)}
    for start in range(-CODEC_SPAN // 2, CODEC_SPAN // 2, CODEC_SLICE):
        x = torch.arange(start, start + CODEC_SLICE, dtype=torch.int64,
                         device=device).to(torch.int32).view(torch.float32)
        for name, cid, plain in (("fp16 encode", fp16,
                                  fusion._float_to_half),
                                 ("bf16 encode", bf16,
                                  fusion._float_to_bf16)):
            codec.encode(cid, x, wire)
            want = plain(x).view(torch.int16)
            bad[name] += (wire.view(torch.int16) != want).sum()
        del x
    compared = 2 * CODEC_SPAN
    halves = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32,
                          device=device).to(torch.int16)
    h = halves.to(torch.int64) & 0xFFFF
    nan = ((h & 0x7C00) == 0x7C00) & ((h & 0x3FF) != 0)
    hw = halves.view(torch.uint8)
    out = torch.empty(1 << 16, dtype=torch.float32, device=device)
    codec.decode_reduce(fp16, hw, out, CODEC_OPS["copy"])
    core = core_half_to_float(torch, h)

    def bits(t):
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    bad["fp16 decode copy vs the core"] = (bits(out) != core).sum()
    plain = torch.empty_like(out)
    codec.plain_decode_reduce(fp16, hw, plain, CODEC_OPS["copy"])
    bad["fp16 plain decode copy vs the core"] = (bits(plain) != core).sum()
    compared += 1 << 16
    plain_nan = int(((bits(plain) != core) & nan).sum())
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    for oname, op in CODEC_OPS.items():
        d = torch.randn(1 << 16, generator=gen, device=device)
        d[::97] = float("nan")
        a, b = d.clone(), d.clone()
        codec.decode_reduce(fp16, hw, a, op)
        codec.plain_decode_reduce(fp16, hw, b, op)
        bad["fp16 decode %s vs plain" % oname] = (
            (a.view(torch.int32) != b.view(torch.int32)) & ~nan).sum()
        compared += 1 << 16
    a = torch.empty_like(out)
    b = torch.empty_like(out)
    codec.decode_reduce(bf16, hw, a, CODEC_OPS["copy"])
    codec.plain_decode_reduce(bf16, hw, b, CODEC_OPS["copy"])
    bad["bf16 decode copy vs plain"] = (a.view(torch.int32)
                                        != b.view(torch.int32)).sum()
    compared += 2 << 16
    torch.cuda.synchronize()
    return {k: int(v) for k, v in bad.items()}, compared, plain_nan


def codec_encode_kernels(torch, codec, counts, device, calls=5,
                         windows=3):
    """The kernels ``calls`` codec_encode calls of each codec run on the
    card (at a ring step's chunk), from one torch.profiler window that
    opens on a few warm-up launches: {codec: {kernel name: launches}},
    each name cut at its arguments, attributed to a codec by its template
    arguments (``EncodeKernel<C, V>``; int8's max pass by its name); None
    when the profiler saw no kernel. The profiler starts recording late
    at times, and then misses the window's first launches: a window that
    saw fewer than ``calls`` launches of a codec's kernel is taken again,
    up to ``windows`` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = -(-sum(counts) // CODEC_RANKS)
    x = adasum_values(torch, [step], SEED + 25, device)
    wire = torch.empty(codec.wire_bytes(codec.FP16, step), dtype=torch.uint8,
                       device=device)
    for cid in codec.CODECS:
        codec.encode(cid, x, wire)
    torch.cuda.synchronize()
    out = {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.zeros(1, device=device)
            torch.cuda.synchronize()
            for cid in codec.CODECS:
                for _ in range(calls):
                    codec.encode(cid, x, wire)
                torch.cuda.synchronize()
        names = [ev.name.split("(")[-2].split("::")[-1] if "(" in ev.name
                 else ev.name for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA
                 and not ev.is_user_annotation]
        out = {}
        for name in names:
            if name.startswith("EncodeMaxKernel"):
                codec_name = "int8"
            elif name.startswith("EncodeKernel<"):
                codec_name = CODEC_NAMES[int(name[len("EncodeKernel<")]) - 1]
            else:
                continue
            out.setdefault(codec_name, {})
            out[codec_name][name] = out[codec_name].get(name, 0) + 1
        if len(out) == len(codec.CODECS) and all(
                n >= calls for ks in out.values() for n in ks.values()):
            break
    return out if out else None


def codec_ring_check(torch, codec, counts, name, device):
    """The plane's compressed ring over ``CODEC_RANKS`` members simulated
    on the card (member r holds every gradient, N(0, 1) from its own
    seed), with the kernels, against the same ring run with the plain
    versions on copies, bit for bit; every member must end with the same
    bytes. Returns (bit-equal, members equal, worst error / limit) with
    the limits of ``codec_limits``."""
    from horovod_tpu_torch.compression import CODEC_IDS, WIRE_TOLERANCE

    cid = CODEC_IDS[name]
    bufs = [adasum_values(torch, counts, SEED + 40 + r, device)
            for r in range(CODEC_RANKS)]
    exact = sum(b.double() for b in bufs)
    magnitude = sum(b.double().abs() for b in bufs)
    plain = [b.clone() for b in bufs]
    codec.simulated_ring(bufs, CODEC_OPS["sum"], cid)
    codec.simulated_ring(plain, CODEC_OPS["sum"], cid, plain=True)
    same = all(_same_bits(a, b) for a, b in zip(bufs, plain))
    members = all(_same_bits(bufs[0], b) for b in bufs[1:])
    err = (bufs[0].double() - exact).abs()
    tol = WIRE_TOLERANCE[name]
    table = tol["atol"] * CODEC_RANKS + tol["rtol"] * exact.abs()
    ratios = {"WIRE_TOLERANCE": float((err / table).max())}
    if name == "fp16":
        limit = CODEC_RANKS * ((2.0 ** -10 + 2.0 ** -24) * magnitude
                               + 2.0 ** -24)
        ratios["truncation"] = float((err / limit).max())
    return same, members, ratios


def cold_sets(torch, make, set_bytes, device):
    """Enough sets ``make(k)`` of one call's inputs that the others, read
    between two calls on the same set, hold twice the card's L2: a call
    that takes the sets in turn finds its inputs in HBM, as a ring step
    finds the next chunk."""
    l2 = getattr(torch.cuda.get_device_properties(device), "L2_cache_size",
                 50 << 20)
    return [make(k) for k in range(1 + -(-2 * l2 // set_bytes))]


def cold_ms(torch, fn, sets, reps=50, rounds=5, queued=False):
    """``median_ms`` (``queued``: ``queued_ms``) of ``fn(*set)`` over
    ``sets`` taken in turn."""
    turn = itertools.cycle(sets)
    timer = queued_ms if queued else median_ms
    return timer(torch, lambda: fn(*next(turn)), reps, rounds)


def codec_times(torch, codec, counts, device, feedback=True):
    """Each kernel at the main path's shapes, its plain version on the same
    card tensors, the PyTorch call that computes the same function where
    one exists, and the bound by bytes. encode and decode-reduce: one step
    of the simulated ring, a chunk of the whole gradient set over
    ``CODEC_RANKS`` members, at each of ``CODEC_PHASES`` (the fp32 block
    and its wire bytes placed as the ring places them), each call on the
    next of ``cold_sets`` (a chunk fits in L2, a ring step's next chunk is
    not there), the library call on the same sets; ``ms`` and
    ``library_ms`` are the card's time per call (``queued_ms``: the
    wrappers take about as long to issue a call as the card to run it),
    ``issue_ms`` the kernel's calls issued back to back with nothing
    queued ahead. Encode also: ``one_wire_ms``, every set encoding into
    one wire (a ring step's send slot; x.to's output, which the allocator
    hands back each call, stays in L2 the same way), and for bf16
    ``library_same_wire_ms``, the PyTorch conversion written into each
    set's own wire as the kernel writes it, and ``copy_ms``, a plain
    fp32 copy of the chunk (the card's practical rate). The feedback (unless not ``feedback``): every gradient
    as a segment, as one fused response of the eager loop (twice L2 on
    its own). Keys (kernel, codec, phase); the feedback's phase is
    None."""
    total = sum(counts)
    step = -(-total // CODEC_RANKS)
    out = {}
    for name, phase in itertools.product(CODEC_NAMES, CODEC_PHASES):
        cid = codec.CODECS[CODEC_NAMES.index(name)]

        def make(k):
            x = _at_phase(torch, adasum_values(
                torch, [step], SEED + 11 + 2 * k, device), phase)[0]
            wire = _wire_store(torch, codec, cid, step, phase, device)[0]
            codec.encode(cid, x, wire)
            d = _at_phase(torch, adasum_values(
                torch, [step], SEED + 12 + 2 * k, device), phase)[0]
            # int8's scale as an fp32 tensor of its own: the wire's
            # first 4 bytes need not lie on 4 bytes.
            return x, wire, d, wire[:4].clone().view(torch.float32)

        sets = cold_sets(torch, make, (8 + CODEC_WIRE[name]) * step, device)
        # The sets with one wire for all, as a ring step's send slot is
        # (and as x.to's output block comes back from the allocator): its
        # lines stay in L2 from one call to the next.
        one_wire = [(x, sets[0][1], d, s) for x, _, d, s in sets]
        lib_enc = lib_same = copy = None
        if name == "bf16":
            lib_enc = cold_ms(torch, lambda x, w, d, s: x.to(torch.bfloat16),
                              sets, queued=True)
            lib_same = cold_ms(
                torch, lambda x, w, d, s: w.view(torch.bfloat16).copy_(x),
                sets, queued=True)
            # The card's practical rate: a plain fp32 copy of the chunk.
            copy = cold_ms(torch, lambda x, w, d, s: d.copy_(x), sets,
                           queued=True)
        if name in ("bf16", "fp16"):
            half = torch.bfloat16 if name == "bf16" else torch.float16

            def library(x, w, d, s):
                return d.add_(w.view(half))
        else:
            # dst += q * scale: the wire's int8 view is free, and addcmul
            # promotes the int8 values to fp32.
            def library(x, w, d, s):
                return d.addcmul_(w[4:4 + step].view(torch.int8), s)
        x, w, d, s = sets[0]
        got, want = d.clone(), d.clone()
        library(x, w, got, s)
        codec.decode_reduce(cid, w, want, CODEC_OPS["sum"])
        lib_err = float((got - want).abs().max())
        lib_dec = cold_ms(torch, library, sets, queued=True)

        def enc(x, w, d, s):
            codec.encode(cid, x, w)

        def dec(x, w, d, s):
            codec.decode_reduce(cid, w, d, CODEC_OPS["sum"])

        out["codec_encode", name, phase] = dict(
            ms=cold_ms(torch, enc, sets, queued=True),
            issue_ms=cold_ms(torch, enc, sets),
            one_wire_ms=cold_ms(torch, enc, one_wire, queued=True),
            library_same_wire_ms=lib_same, copy_ms=copy,
            plain_ms=cold_ms(torch, lambda x, w, d, s: codec.plain_encode(
                cid, x, w), sets, 5, 1),
            library_ms=lib_enc, elems=step, sets=len(sets),
            bound_ms=(4 + CODEC_WIRE[name]) * step / PEAK_BYTES * 1e3)
        out["codec_decode_reduce", name, phase] = dict(
            ms=cold_ms(torch, dec, sets, queued=True),
            issue_ms=cold_ms(torch, dec, sets),
            plain_ms=cold_ms(
                torch, lambda x, w, d, s: codec.plain_decode_reduce(
                    cid, w, d, CODEC_OPS["sum"]), sets, 5, 1),
            library_ms=lib_dec, library_err=lib_err, elems=step,
            sets=len(sets),
            bound_ms=(8 + CODEC_WIRE[name]) * step / PEAK_BYTES * 1e3)
    if not feedback:
        return out
    g = adasum_values(torch, counts, SEED + 13, device)
    xs = list(g.split(counts))
    rs = [torch.zeros_like(t) for t in xs]
    table = codec.feedback_table(list(zip(xs, rs)))
    out["codec_error_feedback", "int8", None] = dict(
        ms=median_ms(torch, lambda: codec.launch_feedback(*table)),
        wrapper_ms=time_ms(torch, lambda: codec.error_feedback(xs, rs), 20),
        plain_ms=time_ms(torch, lambda: codec.plain_error_feedback(xs, rs),
                         2),
        library_ms=None, elems=total,
        bound_ms=16 * total / PEAK_BYTES * 1e3)
    return out


def codec_eager_check(torch, codec, hvd_t, hvd_models, device, tiny):
    """The eager ResNet-50 loop under int8 (``stage_wire_codec``), with one
    more step whose every codec_error_feedback call is held to the plain
    feedback on copies of its inputs (the gradients and the card's
    residuals), bit for bit. Returns the loop's result, the calls, the
    tensors and the failures."""
    core = hvd_t.core_session()
    assert core.stage_wire_codec("int8")
    hvd_t.allreduce(torch.zeros(1, dtype=torch.int32, device=device),
                    name="codec.stage.int8")
    if core.wire_codec() != 3:
        return None, 0, 0, ["int8 was not adopted (codec %d)"
                            % core.wire_codec()]
    res = run_eager(torch, hvd_t, hvd_models, device, CODEC_STEPS,
                    tiny=tiny)
    feedback, calls = codec.error_feedback, []

    def recorded(xs, rs):
        ins = [t.clone() for t in xs], [t.clone() for t in rs]
        feedback(xs, rs)
        calls.append((ins, [t.clone() for t in xs],
                      [t.clone() for t in rs]))

    codec.error_feedback = recorded
    try:
        res["step"]()
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    finally:
        codec.error_feedback = feedback
    failures, tensors = [], 0
    for (xs, rs), xs_out, rs_out in calls:
        codec.plain_error_feedback(xs, rs)
        tensors += len(xs)
        if not all(_same_bits(a, b) for a, b in zip(xs + rs,
                                                     xs_out + rs_out)):
            failures.append("a codec_error_feedback call of %d tensors "
                            "differs from the plain feedback" % len(xs))
    if not calls:
        failures.append("the step ran no codec_error_feedback")
    return res, len(calls), tensors, failures


def codec_phase(torch, hvd_models, device, card, errors, tiny=False):
    """The wire codecs on the card at the eager cell's width (ResNet-50 v1.5
    fp32, 161 gradients). The main path, with every codec launch counter
    zeroed just before and read just after: the eager loop under int8
    (its feedback on every gradient of every step; at size 1 the ring
    moves nothing) and the plane's compressed ring over ``CODEC_RANKS``
    members simulated on the card at full width for each codec. Then the
    kernels against their plain versions (bit for bit, on the gradients
    and on edge blocks, and at every phase: ``codec_phase_checks``), the
    exhaustive conversion checks, the kernels one encode runs, the ring's
    kernels against its plain versions, the same loop with no codec for
    the step time, and the kernels' times at the ring's two phases.
    Prints its lines, appends failures to ``errors`` and returns
    the kernels' entries of the ``kernels`` line. ``tiny`` shrinks the
    model for a CPU rehearsal."""
    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch.ops import codec

    model = eager_model(torch, hvd_models, device, tiny)[0]
    counts = [p.numel() for p in model.parameters() if p.requires_grad]
    del model
    for name in codec.LAUNCHES:
        codec.LAUNCHES[name] = 0
    for key in codec.LAUNCHES_BY_CODEC:
        codec.LAUNCHES_BY_CODEC[key] = 0
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.benchmark = True
    try:
        res, calls, tensors, fails = codec_eager_check(
            torch, codec, hvd_t, hvd_models, device, tiny)
        eager_launches = dict(codec.LAUNCHES)
        rings = {name: codec_ring_check(torch, codec, counts, name, device)
                 for name in CODEC_NAMES}
        torch.cuda.synchronize()
        launches = dict(codec.LAUNCHES)
        by_codec = {(k, CODEC_NAMES[codec.CODECS.index(c)]): v
                    for (k, c), v in codec.LAUNCHES_BY_CODEC.items()}
        core = hvd_t.core_session()
        assert core.stage_wire_codec("none")
        hvd_t.allreduce(torch.zeros(1, dtype=torch.int32, device=device),
                        name="codec.stage.none")
        plain_loop = run_eager(torch, hvd_t, hvd_models, device,
                               CODEC_STEPS, tiny=tiny)
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False
    errors.extend("codec: %s" % f for f in fails)
    if res is None:
        return []
    losses = res["losses"]
    print("codec: resnet50 fp32 B=%d %dpx, SGD(0.01), %d steps through "
          "horovod_tpu_torch.torch.DistributedOptimizer on process set [0] "
          "under HVD_WIRE_CODEC int8 (stage_wire_codec): losses %s; step %s "
          "ms, host %.3f ms a step; the same loop with no codec: step %s ms, "
          "host %.3f ms; on %s"
          % (res["batch"], res["px"], CODEC_STEPS,
             " ".join("%.4f" % v for v in losses),
             "%.3f" % res["step_ms"] if res["step_ms"] else "not measured",
             res["host_ms"], "%.3f" % plain_loop["step_ms"]
             if plain_loop["step_ms"] else "not measured",
             plain_loop["host_ms"], card))
    ok = all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
    print("check codec int8 loss falls: first %.4f, last %.4f: %s"
          % (losses[0], losses[-1], "ok" if ok else "FAIL"))
    if not ok:
        errors.append("codec: the int8 loss did not fall: %s" % losses)
    print("check codec int8 real step: %d codec_error_feedback calls over "
          "%d gradients (the card's residuals included) vs the plain "
          "feedback on copies, bit for bit: %s"
          % (calls, tensors, "ok" if not fails else "FAIL %s" % fails))
    print("codec: launches on the main path (int8 eager loop: %s; then the "
          "%d-member ring of %d gradients, %d elements, for each codec): %s"
          % (eager_launches, CODEC_RANKS, len(counts), sum(counts),
             launches))
    print("codec: encode and decode-reduce launches by codec on the main "
          "path: %s" % ", ".join("%s %s %d" % (k, c, v)
                                 for (k, c), v in sorted(by_codec.items())))
    for name, count in list(launches.items()) + list(by_codec.items()):
        if count <= 0:
            errors.append("codec: %s never launched on the main path"
                          % (name,))
    for name, (same, members, ratios) in rings.items():
        held = CODEC_LIMIT[name]
        ok = same and members and ratios[held] <= 1.0
        print("check codec ring %s: %d members simulated on the card, %d "
              "elements: kernels vs plain versions bit for bit %s, every "
              "member the same bytes %s; error / limit vs the exact sum: "
              "%s; held to the %s limit: %s"
              % (name, CODEC_RANKS, sum(counts), same, members,
                 ", ".join("%s %.3f" % kv for kv in ratios.items()), held,
                 "ok" if ok else "FAIL"))
        if not ok:
            errors.append("codec: ring %s: bit-equal %s, members equal %s, "
                          "error / limit %s" % (name, same, members,
                                                ratios))
    fails, compared, worst = codec_kernel_checks(torch, codec, counts,
                                                 device)
    print("check codec kernels vs plain, bit for bit: %d comparisons (3 "
          "codecs x encode and decode-reduce %s on all %d gradients and "
          "%d edge blocks; the feedback over the gradients and the edge "
          "blocks, 3 steps each): %s"
          % (compared, "/".join(CODEC_OPS), len(counts),
             len(codec_edge_blocks(torch, codec, "cpu")),
             "ok" if not fails else "FAIL %s" % fails))
    errors.extend("codec: %s differs from its plain version" % f
                  for f in fails)
    fails, compared = codec_phase_checks(torch, codec, counts, device)
    print("check codec kernels vs plain at every phase, bit for bit over "
          "whole storages: %d comparisons (3 codecs; encode and "
          "decode-reduce %s; blocks of 0-%d values with the fp32 side at "
          "phases 0-3 and the wire at phases 0-3; the ring's chunks 0 and "
          "1; the edge blocks at phases 0-3): %s"
          % (compared, "/".join(CODEC_OPS), CODEC_SMALL[-1],
             "ok" if not fails else "FAIL %d: %s" % (len(fails), fails[:8])))
    errors.extend("codec: %s differs from its plain version" % f
                  for f in fails)
    bad, compared, plain_nan = codec_conversion_checks(torch, codec, device)
    print("check codec conversions, exhaustive: %d values (every fp32 "
          "pattern through the fp16 and bf16 encode against the plain "
          "versions; every half through the fp16 decode-reduce, copy "
          "(kernel and plain) against the core's HalfToFloat and each op "
          "against the plain "
          "version on the non-NaN halves; every bf16 pattern): differing "
          "%s: %s; the plain version's bits differ from the core's on %d "
          "of the 2046 NaN halves"
          % (compared, bad, "ok" if not any(bad.values()) else "FAIL",
             plain_nan))
    errors.extend("codec: %s differs on %d values" % kv
                  for kv in bad.items() if kv[1])
    kernels = codec_encode_kernels(torch, codec, counts, device)
    if kernels is None:
        print("codec: kernels per codec_encode call: not measured (the "
              "profiler saw no device activity)")
    else:
        print("codec: kernels of 5 codec_encode calls per codec "
              "(torch.profiler): %s" % "; ".join(
                  "%s: %s" % (name, ", ".join("%s x%d" % kv for kv in
                                               sorted(ks.items())))
                  for name, ks in sorted(kernels.items())))
        for name, ks in kernels.items():
            # Launches a window may miss, never adds: a codec's kernels
            # are its own names, each as often as the others.
            want = 2 if name == "int8" else 1
            if len(ks) > want or len(set(ks.values())) > 1:
                errors.append("codec: %s codec_encode ran kernels %s, not "
                              "%d per call" % (name, ks, want))
    times = codec_times(torch, codec, counts, device)
    for (kernel, name, phase), t in times.items():
        extra = "".join(text % t[key] for key, text in (
            ("wrapper_ms", "; wrapper with its table %.4f ms"),
            ("issue_ms", ", queued; issued back to back %.4f ms"),
            ("one_wire_ms", "; into one wire %.4f ms"),
            ("library_same_wire_ms",
             "; library into each set's wire %.4f ms"),
            ("copy_ms", "; an fp32 copy of the chunk %.4f ms"),
            ("sets", ", %d input sets in turn")) if t.get(key) is not None)
        print("time %-20s %-4s %s %.4f ms (median of 5 rounds of 50%s; "
              "plain %.4f ms, library %s%s, bound %.4f ms by bytes) %d "
              "elements, on %s"
              % (kernel, name, "phase %d" % phase if phase is not None
                 else "", t["ms"], extra, t["plain_ms"],
                 "%.4f ms" % t["library_ms"] if t["library_ms"] is not None
                 else "none", " (max |library - kernel| %.3g)"
                 % t["library_err"] if "library_err" in t else "",
                 t["bound_ms"], t["elems"], card))
    for kernel, name in (("codec_encode", "bf16"),
                         ("codec_decode_reduce", "fp16"),
                         ("codec_decode_reduce", "bf16"),
                         ("codec_decode_reduce", "int8")):
        for phase in CODEC_PHASES:
            t = times[kernel, name, phase]
            pairs = [("ms", "library_ms")]
            if kernel == "codec_encode":
                # x.to's output stays in L2: against it, the kernel into
                # one wire; the kernel into each set's wire against the
                # conversion into the same wires.
                pairs += [("one_wire_ms", "library_ms"),
                          ("ms", "library_same_wire_ms")]
            for mine, theirs in pairs:
                print("target codec %s %s phase %d: %s %.4f ms against the "
                      "library's %s %.4f ms: %s (recorded, not a check)"
                      % (kernel, name, phase, mine, t[mine], theirs,
                         t[theirs], "held" if t[mine] <= t[theirs]
                         else "missed"))
    replaces = {"codec_encode": "horovod_tpu/core/src/codec.cc:63",
                "codec_decode_reduce": "horovod_tpu/core/src/codec.cc:102",
                "codec_error_feedback":
                    "horovod_tpu/core/src/operations.cc:273"}
    entries = []
    for (kernel, name, phase), t in times.items():
        if phase not in (None, CODEC_PHASES[0]):
            continue
        entry = {
            "name": kernel if phase is None else "%s[%s]" % (kernel, name),
            "route": "cuda", "source": "horovod_tpu_torch/csrc/codec.cu",
            "replaces": replaces[kernel],
            "launches": (launches[kernel] if phase is None
                         else by_codec[kernel, name]),
            "max_abs_err": worst[kernel], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"]}
        if phase is not None:
            later = times[kernel, name, CODEC_PHASES[1]]
            entry.update(ms_phase2=later["ms"],
                         library_ms_phase2=later["library_ms"])
        entries.append(entry)
    return entries


# -------------------------------------------------------- observability ---

OBS_STEPS = 6
AUTOTUNE_STEPS = 6
# Alternating runs of the eager step with the observability plane on and
# off, and the steps of each run.
# The host's step varies by a third from run to run (PR 11's first
# runs), so many short pairs.
OVERHEAD_PAIRS = 12
OVERHEAD_STEPS = 4
EVENTS_TIMED = 2000  # events created and recorded, per kind
# utils/autotune.py's box (the reference's, parameter_manager.cc:28-66).
FUSION_MB_BOX = (0.0, 64.0)
CYCLE_MS_BOX = (1.0, 100.0)


def scrape(port):
    """``GET /metrics`` from 127.0.0.1 parsed into {series: value}, and
    ``GET /metrics.json``."""
    import urllib.request

    base = "http://127.0.0.1:%d" % port
    with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
        text = r.read().decode()
    with urllib.request.urlopen(base + "/metrics.json", timeout=30) as r:
        snap = json.loads(r.read())
    series = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            series[key] = float(value)
    return series, snap


def _family_value(snap, name, field="value", **labels):
    for v in snap.get(name, {}).get("values", []):
        if all(v["labels"].get(k) == x for k, x in labels.items()):
            return v[field]
    return 0


def read_timeline(path):
    """A Chrome-trace file: the Python writer leaves its array open, the
    core's closes it."""
    with open(path) as f:
        text = f.read().rstrip()
    return json.loads(text if text.endswith("]") else
                      text.rstrip(",") + "]")


def card_spans(events, names, steps, each_ms, cuda):
    """The eager step's spans per tensor: each of ``names`` must have one
    span a step, and on the card each its ``card_ms`` within (0, the
    step's ms]. Returns (failures, card ms of the spans)."""
    fails, card = [], []
    by_name = {}
    for e in events:
        if e.get("cat") == "allreduce" and e.get("ph") in ("B", "E"):
            by_name.setdefault(e["name"], []).append(e)
    if set(by_name) != set(names):
        fails.append("span names %d, tensors %d" % (len(by_name),
                                                    len(names)))
    for name in names:
        spans = by_name.get(name, [])
        ends = sorted((e for e in spans if e["ph"] == "E"),
                      key=lambda e: e["ts"])
        if sum(e["ph"] == "B" for e in spans) != steps or \
                len(ends) != steps:
            fails.append("%s: %d events" % (name, len(spans)))
            continue
        for k, e in enumerate(ends):
            ms = e.get("args", {}).get("card_ms")
            if not cuda:
                continue
            if ms is None or not 0 < ms <= each_ms[k]:
                fails.append("%s step %d: card ms %s, step %.3f ms"
                             % (name, k, ms, each_ms[k]))
            else:
                card.append(ms)
    return fails, card


def flight_records(paths, names):
    """Names of ``names`` missing a ``submit`` or a ``complete`` in the
    Python dump, or an ENQUEUE (the submission, under the device prefix
    for a card tensor) or a NEG_END (emitted in a response) in the
    native one."""
    from horovod_tpu_torch.core.session import DEVICE_PREFIX

    def load(path):
        with open(path) as f:
            return [json.loads(line) for line in f][1:]

    py = load(paths["python"])
    native = load(paths["native"])
    missing = []
    for kind in ("submit", "complete"):
        seen = {e.get("name") for e in py if e["kind"] == kind}
        missing += ["python %s %s" % (kind, n) for n in names
                    if n not in seen]
    for kind in ("ENQUEUE", "NEG_END"):
        seen = {e["name"] for e in native if e["kind"] == kind}
        missing += ["native %s %s" % (kind, n) for n in names
                    if n not in seen and DEVICE_PREFIX + n not in seen]
    return missing, len(py), len(native)


def autotune_steps(torch, hvd_t, hvd_models, device, steps, tiny, read):
    """``steps`` steps of the eager model with every gradient allreduced
    through ``allreduce_async`` and held to ``LocalBackend`` bit for bit,
    then SGD; ``read(core)`` after each step. Returns (steps whose results
    differed, what ``read`` returned)."""
    from horovod_tpu_torch.ops.eager import LocalBackend

    F = torch.nn.functional
    model, batch, px, classes = eager_model(torch, hvd_models, device,
                                            tiny)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    data = torch.randn(batch, 3, px, px, generator=gen, device=device)
    target = torch.randint(0, classes, (batch,), generator=gen,
                           device=device)
    params = [p for p in model.parameters() if p.requires_grad]
    core, bad, seen = hvd_t.core_session(), [], []
    for step in range(steps):
        model.zero_grad()
        F.cross_entropy(model(data), target).backward()
        grads = [p.grad for p in params]
        handles = [hvd_t.allreduce_async(g, name="tune.%d" % i,
                                         op=hvd_t.Average)
                   for i, g in enumerate(grads)]
        got = [hvd_t.synchronize(h) for h in handles]
        want = LocalBackend().allreduce_async(
            grads, None, hvd_t.Average, 1.0, 1.0, None).result()
        if not all(_same_bits(a, b) for a, b in zip(got, want)):
            bad.append(step)
        with torch.no_grad():
            for p, g in zip(params, got):
                p.add_(g, alpha=-0.01)
        seen.append(read(core))
    return bad, seen


def event_cost_us(torch, n):
    """Host µs to create and record one card event, untimed and timed
    (median of 5 rounds of ``n``), on the current stream."""
    out = {}
    for timing in (False, True):
        rounds = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                torch.cuda.Event(enable_timing=timing).record()
            rounds.append((time.perf_counter() - t0) / n * 1e6)
        out[timing] = sorted(rounds)[2]
    return out


def observability_phase(torch, hvd, hvd_models, device, card, errors,
                        tiny=False):
    """The eager path's full-width ResNet-50 loop under the observability
    plane: ``init`` with HOROVOD_TIMELINE and HVD_METRICS_PORT=0, the
    metrics scraped from the server, both timelines parsed (each card
    tensor one span a step, its card ms within the step), both flight
    rings dumped; then HOROVOD_AUTOTUNE=1 and =native, the parameters
    moving within the tuner's box while every step's results stay
    LocalBackend's bit for bit; then the eager step with all of it on
    against HVD_FLIGHTREC=0 with no timeline and no server, in alternating
    runs, and the host cost of a timing-enabled event. Leaves the world
    initialized, as it found it."""
    import os
    import shutil
    import tempfile

    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import eager

    cuda = device.startswith("cuda")

    def check(name, ok, detail):
        print("check observability %s: %s: %s"
              % (name, detail, "ok" if ok else "FAIL"))
        if not ok:
            errors.append("observability: %s: %s" % (name, detail))

    def sync():
        if cuda:
            torch.cuda.synchronize()

    saved_env = dict(os.environ)
    tmp = tempfile.mkdtemp(prefix="hvd_obs_")
    tl_path = os.path.join(tmp, "tl.json")
    tf32, bench = torch.backends.cudnn.allow_tf32, \
        torch.backends.cudnn.benchmark
    hvd.shutdown()
    try:
        # The eager phase's settings: cuDNN may use TF32.
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.benchmark = True
        for var in ("HVD_FLIGHTREC", "HOROVOD_AUTOTUNE"):
            os.environ.pop(var, None)
        os.environ.update(HOROVOD_TIMELINE=tl_path, HVD_METRICS_PORT="0",
                          HVD_FLIGHTREC_DIR=tmp)
        hvd.init(device=device)
        server = basics._ctx.metrics_server
        if server is None or basics.timeline() is None:
            raise RuntimeError("init started no metrics server (%s) or no "
                               "timeline (%s)" % (server,
                                                  basics.timeline()))
        port = server.port
        before, before_js = scrape(port)
        res = run_eager(torch, hvd_t, hvd_models, device, OBS_STEPS,
                        tiny=tiny)
        sync()
        deadline = time.monotonic() + 30
        while eager.card_latency_pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        pending = eager.card_latency_pending()
        after, after_js = scrape(port)
        n = len(res["params"])
        nbytes = sum(p.numel() * p.element_size() for p in res["params"])
        want_bytes = nbytes * OBS_STEPS
        key = "hvd_core_allreduce_bytes_total"
        got_bytes = after.get(key, 0) - before.get(key, 0)
        check("allreduce bytes (/metrics)", got_bytes == want_bytes and (
            tiny or nbytes == 102228128),
              "delta %d, want %d bytes a step (%d gradients) x %d steps = "
              "%d" % (got_bytes, nbytes, n, OBS_STEPS, want_bytes))
        label = '{op="allreduce"}'
        counts = {
            "collectives": after.get("hvd_collectives_total" + label, 0)
            - before.get("hvd_collectives_total" + label, 0),
            "latency histogram": after.get(
                "hvd_collective_latency_seconds_count" + label, 0)
            - before.get("hvd_collective_latency_seconds_count" + label, 0),
            "latency histogram (json)": _family_value(
                after_js, "hvd_collective_latency_seconds", "count",
                op="allreduce") - _family_value(
                before_js, "hvd_collective_latency_seconds", "count",
                op="allreduce"),
            "bytes histogram (json)": _family_value(
                after_js, "hvd_collective_bytes", "count", op="allreduce")
            - _family_value(before_js, "hvd_collective_bytes", "count",
                            op="allreduce")}
        hist_bytes = _family_value(
            after_js, "hvd_collective_bytes", "sum", op="allreduce") \
            - _family_value(before_js, "hvd_collective_bytes", "sum",
                            op="allreduce")
        check("collective counts", pending == 0 and all(
            v == n * OBS_STEPS for v in counts.values())
              and hist_bytes == want_bytes,
              "%s, want submitted tensors %d x %d = %d; bytes histogram "
              "sum %d, want %d; card latencies unresolved after 30 s: %d"
              % (counts, n, OBS_STEPS, n * OBS_STEPS, hist_bytes,
                 want_bytes, pending))
        lat = [v for v in after_js["hvd_collective_latency_seconds"]
               ["values"] if v["labels"]["op"] == "allreduce"][0]
        print("observability: eager allreduce latency, submission to the "
              "plane's done event: p50 %s s, p99 %s s (the run's %d "
              "tensors and before; histogram)"
              % (lat["p50"], lat["p99"], n * OBS_STEPS))

        hvd_t.stop_timeline()
        events = read_timeline(tl_path)
        core_events = read_timeline(tl_path + ".core.json")
        names = sorted({e["name"] for e in events
                        if e.get("cat") == "allreduce"})
        fails, card_ms = card_spans(events, names, OBS_STEPS,
                                    res["each_ms"], cuda)
        check("timeline", not fails and len(names) == n and core_events,
              "%d Python events, %d core events; %d tensors, each %d "
              "spans; card ms per span %s; %s"
              % (len(events), len(core_events), len(names), OBS_STEPS,
                 "min %.4f median %.4f max %.4f (steps %s ms)"
                 % (min(card_ms), sorted(card_ms)[len(card_ms) // 2],
                    max(card_ms), ", ".join("%.3f" % x for x in
                                            res["each_ms"]))
                 if card_ms else "not on the card",
                 fails[:5] if fails else "every span within its step"))

        paths = hvd.dump_flight_record(os.path.join(tmp, "fr"))
        missing, n_py, n_native = (flight_records(paths, names)
                                   if set(paths) == {"python", "native"}
                                   else (["files %s" % paths], 0, 0))
        check("flight record", not missing,
              "%s; %d Python and %d native events; missing %s"
              % (sorted(paths), n_py, n_native, missing[:5] or "none"))

        # HOROVOD_AUTOTUNE=1: utils/autotune.py through hvd_core_set_params.
        hvd.shutdown()
        for var in ("HOROVOD_TIMELINE", "HVD_METRICS_PORT"):
            os.environ.pop(var)
        os.environ.update(HOROVOD_AUTOTUNE="1", HOROVOD_AUTOTUNE_LOG=
                          os.path.join(tmp, "autotune.csv"))
        hvd.init(device=device)
        start = hvd_t.core_session().autotune.current
        bad, seen = autotune_steps(
            torch, hvd_t, hvd_models, device, AUTOTUNE_STEPS, tiny,
            lambda core: (core.autotune.current, core.fusion_bytes(),
                          core.autotune.done))
        points = {p for p, _, _ in seen} - {start}
        inside = all(FUSION_MB_BOX[0] <= f <= FUSION_MB_BOX[1] and
                     CYCLE_MS_BOX[0] <= c <= CYCLE_MS_BOX[1]
                     for f, c in points)
        check("HOROVOD_AUTOTUNE=1", not bad and points and inside,
              "from (%.1f MB, %.2f ms) to %d other points within the box, "
              "per step (fusion MB, cycle ms, core threshold bytes, "
              "frozen): %s; steps whose %d results differ from "
              "LocalBackend: %s"
              % (start[0], start[1], len(points), "; ".join(
                  "%.2f %.2f %d %s" % (p[0], p[1], b, d)
                  for p, b, d in seen), len(res["params"]), bad))

        # HOROVOD_AUTOTUNE=native: the core's own tuner, which samples
        # negotiation cycles; a step submits its gradients at once, in a
        # few cycles, so a sample here is two cycles after one warm-up.
        hvd.shutdown()
        os.environ.update(HOROVOD_AUTOTUNE="native",
                          HOROVOD_AUTOTUNE_WARMUP_SAMPLES="1",
                          HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="2")
        hvd.init(device=device)
        bad, seen = autotune_steps(
            torch, hvd_t, hvd_models, device, AUTOTUNE_STEPS, tiny,
            lambda core: core.autotune_state())
        last = seen[-1]
        moved = {(s["fusion_mb"], s["cycle_ms"]) for s in seen}
        inside = all(FUSION_MB_BOX[0] <= f <= FUSION_MB_BOX[1] and
                     CYCLE_MS_BOX[0] <= c <= CYCLE_MS_BOX[1]
                     for f, c in moved if (f, c) != (128.0, 1.0))
        check("HOROVOD_AUTOTUNE=native", not bad and last["samples"] > 0
              and len(moved) > 1 and inside,
              "per step (fusion MB, cycle ms, samples): %s; steps whose "
              "results differ from LocalBackend: %s"
              % ("; ".join("%.2f %.2f %d" % (s["fusion_mb"], s["cycle_ms"],
                                             s["samples"]) for s in seen),
                 bad))

        # The cost: the eager step with all of it on, against
        # HVD_FLIGHTREC=0 with no timeline and no server, alternating.
        hvd.shutdown()
        for var in ("HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG",
                    "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
                    "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"):
            os.environ.pop(var)
        hvd.init(device=device)
        step = run_eager(torch, hvd_t, hvd_models, device, EAGER_WARM + 1,
                         tiny=tiny)["step"]
        ms = {"on": [], "off": []}
        for k in range(OVERHEAD_PAIRS):
            for mode in (("on", "off") if k % 2 == 0 else ("off", "on")):
                if mode == "on":
                    os.environ.pop("HVD_FLIGHTREC", None)
                    hvd.start_timeline(os.path.join(tmp, "cost.json"))
                    hvd.start_metrics_server(0)
                else:
                    os.environ["HVD_FLIGHTREC"] = "0"
                step()
                sync()
                t0 = time.perf_counter()
                for _ in range(OVERHEAD_STEPS):
                    step()
                sync()
                ms[mode].append(1e3 * (time.perf_counter() - t0)
                                / OVERHEAD_STEPS)
                if mode == "on":
                    hvd.stop_timeline()
                    hvd.stop_metrics_server()
        ratios = sorted(a / b for a, b in zip(ms["on"], ms["off"]))
        q = len(ratios) // 4
        print("observability: eager step with the metrics, the flight "
              "recorder, both timelines and the server on: %s ms; with "
              "HVD_FLIGHTREC=0, no timeline, no server: %s ms (host clock, "
              "%d steps a run, %d pairs, the first of each pair "
              "alternating); pair ratios %s: median %.4f, quartiles %.4f "
              "%.4f; medians %.3f ms on, %.3f ms off; on %s"
              % (" ".join("%.3f" % x for x in ms["on"]),
                 " ".join("%.3f" % x for x in ms["off"]), OVERHEAD_STEPS,
                 OVERHEAD_PAIRS, " ".join("%.4f" % x for x in ratios),
                 (ratios[len(ratios) // 2 - 1] + ratios[len(ratios) // 2])
                 / 2, ratios[q], ratios[-1 - q],
                 sorted(ms["on"])[OVERHEAD_PAIRS // 2],
                 sorted(ms["off"])[OVERHEAD_PAIRS // 2], card))
        if cuda:
            cost = event_cost_us(torch, EVENTS_TIMED)
            per = res["counters"]
            tensors = per["allreduced_tensors"] / OBS_STEPS
            responses = per["responses"] / OBS_STEPS
            extra_ms = (cost[True] - cost[False]) * (tensors + responses) \
                / 1e3
            print("observability: a card event costs the host %.3f us "
                  "untimed, %.3f us timed (create and record, median of 5 "
                  "rounds of %d); a step makes %.1f readiness and %.1f done "
                  "events (%.2f per response), so timing them costs %.4f "
                  "ms a step, %.3f%% of the %.3f ms step; on %s"
                  % (cost[False], cost[True], EVENTS_TIMED, tensors,
                     responses, (tensors + responses) / responses, extra_ms,
                     100 * extra_ms / res["step_ms"], res["step_ms"], card))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.benchmark = bench
        os.environ.clear()
        os.environ.update(saved_env)
        hvd.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    hvd.init(device=device)


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
    return losses


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


class Rendezvous:
    """The port's ``RendezvousServer`` (``horovod_tpu_torch/runner/
    http_server.py``) on a local port, with this script publishing the
    worlds as the elastic driver does (``ElasticDriver._publish``). The
    heartbeats reach it through the server's ``put_callback``, as they
    reach ``ElasticDriver._on_kv_put``, and are kept in order of
    arrival."""

    def __init__(self):
        import threading

        from horovod_tpu_torch.runner.http_server import RendezvousServer

        self._beats, self._lock = [], threading.Lock()
        self.server = RendezvousServer(put_callback=self._on_put)
        self.port = self.server.start()

    def _on_put(self, scope, key, value):
        if scope == "heartbeat":
            with self._lock:
                self._beats.append(json.loads(value))

    def publish(self, version, slots=(ELASTIC_SLOT,)):
        """A world of ``slots`` (in rank order, one host) at ``version``:
        the slots' assignments first, a removed slot's deleted, then the
        meta, its port negotiated (``controller_port`` 0)."""
        from horovod_tpu_torch.runner.hosts import (
            HostInfo, get_host_assignments,
        )

        n = len(slots)
        world = get_host_assignments([HostInfo("localhost", n)], n, n)
        self.server.clear_scope(self.server.SCOPE)
        for slot, a in zip(slots, world):
            self.server.put(self.server.SCOPE, slot,
                            a.to_response_string().encode())
        self.server.put("control", "meta", json.dumps({
            "version": version, "controller_addr": "127.0.0.1",
            "controller_port": 0, "size": n}).encode())

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
        self.server.stop()


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


def elastic_counts():
    """The ``hvd_elastic_*`` counters of the process-wide registry."""
    from horovod_tpu_torch.utils import metrics

    return {k: metrics.value("hvd_elastic_%s_total" % k) or 0 for k in (
        "commits", "ckpt_saves", "ckpt_restores", "ckpt_errors", "failures",
        "resets", "host_updates", "heartbeats", "heartbeats_deferred")}


def elastic_phase(torch, hvd, hvd_models, fa, device, card, errors,
                  tiny=False):
    """transformer_long under ``elastic.run`` on one card, with this
    script as the elastic driver (``Rendezvous``): run A uninterrupted; run
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
    kv = Rendezvous()
    tmp = tempfile.mkdtemp(prefix="hvd_elastic_")
    real_reinit = worker.reinit_for_version
    hvd.shutdown()
    try:
        kv.publish(0)
        os.environ.update(elastic_env(kv.port))
        hvd.init(device=device)
        counts0 = elastic_counts()
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
        # No more beats: the next one finds no rendezvous and is not sent.
        del os.environ["HOROVOD_RENDEZVOUS_ADDR"]
        time.sleep(2 * float(ELASTIC_HEARTBEAT_SEC))
        counts = elastic_counts()
        moved = {k: counts[k] - counts0[k] for k in counts}
        # Run A commits every step and checkpoints every 4th; run B
        # commits its steps 1-5, fails, and commits 6-16 after the restore
        # (step 10's commit raising the host update), checkpointing at 4,
        # 8, 12 and 16; run C resumes and runs nothing; run D falls back
        # from the torn step 16 (one error) to 12 and commits 13-16, its
        # step 16 already on disk (not saved again).
        want = dict(commits=2 * ELASTIC_STEPS + 4, ckpt_saves=8,
                    ckpt_restores=2, ckpt_errors=1, failures=1, resets=2,
                    host_updates=1, heartbeats=len(kv.beat_versions()),
                    heartbeats_deferred=0)
        check("hvd_elastic_* counters", moved == want,
              "moved %s, want %s" % (moved, want))
    finally:
        worker.reinit_for_version = real_reinit
        kv.close()
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.clear()
        os.environ.update(saved_env)


# --------------------------------------------------------------- tuning ---

# The online tuner (utils/online_tuner.py) on the eager cell under
# elastic.run: windows of TUNE_WINDOW_SEC, four sub-windows each. A step
# moves its 102 MB at once, so a sub-window's rate counts whole steps:
# at 0.4 s (2-3 steps of ~150 ms on the H100) that quantization put the
# noise band at 38% of the rate; at 0.8 s (5 steps) it is about half.
# TUNE_SAMPLES search rounds (a baseline and a guard window each) before
# it freezes; TUNE_FAIL_STEP raises HorovodInternalError once;
# TUNE_AFTER_FREEZE steps run frozen; the loop stops at TUNE_MAX_SEC.
TUNE_WINDOW_SEC = 3.2
TUNE_SAMPLES = 3
TUNE_FAIL_STEP = 12
TUNE_AFTER_FREEZE = 8
TUNE_MAX_SEC = 60.0
# A broadcast whose root is outside its set must raise within this.
C8_LIMIT_SEC = 10.0


def core_allreduce_bytes():
    """The tuning phase's objective: the payload bytes the core allreduced
    (at size 1 NCCL moves nothing, so the training objective, the wire
    bytes, reads 0)."""
    from horovod_tpu_torch.utils import metrics

    return float(metrics.value("hvd_core_allreduce_bytes_total") or 0.0)


def tune_counts():
    from horovod_tpu_torch.utils import metrics

    return {"windows": metrics.value("hvd_tune_windows_total") or 0,
            "accept": metrics.value("hvd_tune_moves_total",
                                    outcome="accept") or 0,
            "revert": metrics.value("hvd_tune_moves_total",
                                    outcome="revert") or 0,
            "replays": metrics.value("hvd_tune_replays_total") or 0,
            "resets": metrics.value("hvd_elastic_resets_total") or 0}


def _knobs(values):
    return "fusion %g MB, cycle %g ms, ring chunk %d KiB, socket buf %d KiB" \
        % (values["fusion_threshold_mb"], values["cycle_time_ms"],
           values["ring_chunk_bytes"] // 1024,
           values["socket_buf_bytes"] // 1024)


def tuning_phase(torch, hvd, hvd_models, device, card, errors, tiny=False):
    """The eager cell's loop (161 gradients a step through the core and
    the device plane, each held to LocalBackend bit for bit) under
    ``elastic.run`` with HVD_TUNE=1, the online tuner started first on the
    core's allreduced bytes; one raised failure mid-run; then a tuner under
    HVD_TUNE=cache replays the journal. Leaves the world initialized."""
    import os
    import shutil
    import tempfile

    import horovod_tpu_torch.torch as hvd_t
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.common.knobs import TUNABLE
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.ops.eager import LocalBackend
    from horovod_tpu_torch.utils import online_tuner as ot

    cuda = device.startswith("cuda")
    F = torch.nn.functional

    def check(name, ok, detail):
        print("check tuning %s: %s: %s" % (name, detail,
                                          "ok" if ok else "FAIL"))
        if not ok:
            errors.append("tuning: %s: %s" % (name, detail))

    saved_env = dict(os.environ)
    tf32, bench = torch.backends.cudnn.allow_tf32, \
        torch.backends.cudnn.benchmark
    kv = Rendezvous()
    tmp = tempfile.mkdtemp(prefix="hvd_tune_")
    real_world_change = ot.on_world_change
    hook = {"calls": 0, "errors": [], "tuners": []}

    def world_change():
        hook["calls"] += 1
        try:
            real_world_change()
        except Exception as e:  # noqa: BLE001 — recorded, then the
            # wrapper logs it, as it would any hook failure
            hook["errors"].append(repr(e))
            raise

    t_phase = time.perf_counter()
    hvd.shutdown()
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cudnn.benchmark = True
        for var in ["HVD_TUNE_FREEZE", "HVD_TUNE_GUARD_PCT",
                    "HOROVOD_AUTOTUNE"] + [k.env for k in TUNABLE.values()
                                           if k.env]:
            os.environ.pop(var, None)
        kv.publish(0)
        os.environ.update(elastic_env(kv.port))
        os.environ.update(HVD_TUNE="1", HVD_TUNE_JOURNAL_DIR=tmp,
                          HVD_TUNE_WINDOW_SEC=str(TUNE_WINDOW_SEC))
        ot.on_world_change = world_change
        hvd.init(device=device)
        counts0 = tune_counts()

        model, batch, px, classes = eager_model(torch, hvd_models, device,
                                                tiny)
        gen = torch.Generator(device=device).manual_seed(SEED + 1)
        data = torch.randn(batch, 3, px, px, generator=gen, device=device)
        target = torch.randint(0, classes, (batch,), generator=gen,
                               device=device)
        params = [p for p in model.parameters() if p.requires_grad]
        opt = torch.optim.SGD(model.parameters(), lr=0.01)
        state = elastic.TorchState(model, opt, step=0)
        rec = {"steps": [], "bad": [], "raised": False,
               "t0": time.monotonic()}

        def one_step():
            t0 = time.perf_counter()
            opt.zero_grad()
            F.cross_entropy(model(data), target).backward()
            grads = [p.grad for p in params]
            handles = [hvd_t.allreduce_async(g, name="tune.%d" % i,
                                             op=hvd_t.Average)
                       for i, g in enumerate(grads)]
            got = [hvd_t.synchronize(h) for h in handles]
            want = LocalBackend().allreduce_async(
                grads, None, hvd_t.Average, 1.0, 1.0, None).result()
            same = all(_same_bits(a, b) for a, b in zip(got, want))
            for p, g in zip(params, got):
                p.grad = g
            opt.step()
            if cuda:
                torch.cuda.synchronize()
            return same, 1e3 * (time.perf_counter() - t0), len(got)

        @elastic.run
        def train(state):
            hook["tuners"].append(ot.online_tuner())
            while True:
                same, ms, n = one_step()
                state.step += 1
                core = hvd_t.core_session()
                st = tuner.state()
                rec["steps"].append(dict(
                    step=state.step, ms=ms, same=same, tensors=n,
                    core=core.fusion_bytes(),
                    plane=core.plane.fusion_bytes if core.plane else None,
                    frozen=st["frozen"]))
                if not same:
                    rec["bad"].append(state.step)
                if state.step == TUNE_FAIL_STEP and not rec["raised"]:
                    rec["raised"] = True
                    kv.publish(1)
                    raise HorovodInternalError("injected: a peer is gone")
                state.commit()
                if sum(s["frozen"] for s in rec["steps"]) >= \
                        TUNE_AFTER_FREEZE or \
                        time.monotonic() - rec["t0"] > TUNE_MAX_SEC:
                    return

        # The training objective (the wire bytes) reads 0 at size 1: the
        # phase starts the tuner on the core's allreduced bytes, and the
        # wrapper's hook then returns it.
        tuner = ot.start_online_tuner(role="training",
                                      objective=core_allreduce_bytes,
                                      max_samples=TUNE_SAMPLES)
        if tuner is None:
            raise RuntimeError("HVD_TUNE=1 started no tuner")
        start_values = dict(tuner.state()["values"])
        for name in fusion.LAUNCHES:
            fusion.LAUNCHES[name] = 0
        rec["t0"] = time.monotonic()
        train(state)
        loop_s = time.monotonic() - rec["t0"]
        launches = dict(fusion.LAUNCHES)
        counts = tune_counts()
        moved = {k: counts[k] - counts0[k] for k in counts}
        traj = tuner.trajectory()
        final = tuner.state()

        print("tuning: eager ResNet-50 batch %d at %dpx, %d gradients a "
              "step, HVD_TUNE=1 under elastic.run, window %.1f s, %d "
              "rounds; objective: the core's allreduced bytes; started at "
              "%s" % (batch, px, rec["steps"][0]["tensors"],
                      TUNE_WINDOW_SEC, TUNE_SAMPLES, _knobs(start_values)))
        for r in traj:
            if r["type"] == "tune_idle":
                print("tuning: idle x%d (objective 0)" % r["windows"])
            elif r["type"] == "tune_apply":
                print("tuning: round %d: baseline %.4e B/s (noise %.3e), "
                      "apply %s (guard %.4e)"
                      % (r["sample"], r["baseline"], r["noise"],
                         _knobs(r["values"]), r["threshold"]))
            elif r["type"] in ("tune_accept", "tune_revert"):
                print("tuning: round %d: %s%s at %.4e B/s -> %s"
                      % (r["sample"], r["type"][5:],
                         " (no move)" if r.get("noop") else "",
                         r["objective"], _knobs(r["values"])))
            elif r["type"] == "tune_freeze":
                print("tuning: frozen after %d rounds at %s (best %.4e "
                      "B/s)" % (r["samples"], _knobs(r["values"]),
                                r["objective"]))
            else:
                print("tuning: %s %s" % (r["type"], json.dumps(r)))
        before = [s["ms"] for s in rec["steps"][EAGER_WARM:]
                  if not s["frozen"]]
        after = [s["ms"] for s in rec["steps"] if s["frozen"]]
        print("tuning: step %s ms searching (median of %d), %s ms frozen "
              "(median of %d); host clock, each step synchronised and its "
              "%d results held to LocalBackend; fusion launches %s; on %s"
              % ("%.3f" % _ms([x / 1e3 for x in before]) if before else
                 "none", len(before),
                 "%.3f" % _ms([x / 1e3 for x in after]) if after else
                 "none", len(after), rec["steps"][0]["tensors"], launches,
                 card))

        applies = [r for r in traj if r["type"] == "tune_apply"]
        check("search", moved["windows"] > 0 and len(applies) >= 1 and
              moved["accept"] + moved["revert"] >= 1 and final["frozen"],
              "%d windows, %d applied, %d accepted, %d reverted, frozen %s"
              % (moved["windows"], len(applies), moved["accept"],
                 moved["revert"], final["frozen"]))
        mib = 1 << 20
        applied = sorted({max(int(r["values"]["fusion_threshold_mb"] * mib),
                              1) for r in traj if r["type"] in
                          ("tune_apply", "tune_revert", "tune_freeze")})
        core_seen = {s["core"] for s in rec["steps"]}
        plane_seen = {s["plane"] for s in rec["steps"]}
        # A 1-byte threshold fuses nothing, so the plane keeps its buffer.
        plane_want = [b for b in applied if b > 1] if cuda else []
        check("fusion threshold", applied and
              all(b in core_seen for b in applied) and
              all(b in plane_seen for b in plane_want),
              "applied %s bytes; the core ran with %s; the plane's buffer "
              "followed %s%s" % (applied, sorted(core_seen),
                                 sorted(b for b in plane_seen if b),
                                 "" if cuda else " (no plane on the CPU)"))
        check("results", not rec["bad"] and len(rec["steps"]) > 0,
              "%d steps, each %d results; steps that differ from "
              "LocalBackend: %s" % (len(rec["steps"]),
                                    rec["steps"][0]["tensors"], rec["bad"]))
        check("reset", rec["raised"] and moved["resets"] == 1 and
              hook["calls"] == 1 and not hook["errors"] and
              len(hook["tuners"]) == 2 and
              all(t is tuner for t in hook["tuners"]),
              "raised at step %d, %d reset, on_world_change ran %d time(s), "
              "errors %s; the wrapper's hook returned the started tuner on "
              "both entries: %s"
              % (TUNE_FAIL_STEP, moved["resets"], hook["calls"],
                 hook["errors"] or "none",
                 [t is tuner for t in hook["tuners"]]))
        if cuda:
            check("launches", launches.get("fusion_pack", 0) > 0 and
                  launches.get("fusion_unpack", 0) > 0,
                  "fusion kernels in the tuning loop: %s" % launches)

        ot.stop_online_tuner()
        os.environ["HVD_TUNE"] = "cache"
        replays0 = tune_counts()["replays"]
        cached = ot.start_online_tuner(role="training",
                                       objective=core_allreduce_bytes)
        got = cached.state() if cached is not None else None
        check("replay", got is not None and cached._thread is None and
              got["values"] == final["values"] and got["frozen"] and
              tune_counts()["replays"] - replays0 == 1,
              "HVD_TUNE=cache adopted %s, frozen %s, without a search "
              "thread; live tuner had %s; replays %d"
              % (_knobs(got["values"]) if got else None,
                 got and got["frozen"], _knobs(final["values"]),
                 tune_counts()["replays"] - replays0))
        print("tuning: the phase took %.1f s (host clock), the loop %.1f s; "
              "on %s" % (time.perf_counter() - t_phase,
                         loop_s, card))
    finally:
        ot.stop_online_tuner()
        ot.on_world_change = real_world_change
        kv.close()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cudnn.benchmark = bench
        os.environ.clear()
        os.environ.update(saved_env)
        hvd.shutdown()
    hvd.init(device=device)


def c8_check(torch, hvd, device, errors):
    """A broadcast whose root is outside its set (root 1 at size 1), of a
    tensor on ``device``, raises within ``C8_LIMIT_SEC``: under a watchdog
    thread, so that a regression fails the check instead of hanging the
    script. Then a broadcast with root 0 runs on the same core."""
    import threading

    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    x = torch.arange(8, dtype=torch.float32, device=device)
    out = {}

    def bad():
        t0 = time.perf_counter()
        try:
            hvd.broadcast(x, 1, name="c8.bad")
            out["error"] = None
        except HorovodInternalError as e:
            out["error"] = str(e)
        out["s"] = time.perf_counter() - t0

    watched = threading.Thread(target=bad, daemon=True)
    watched.start()
    watched.join(C8_LIMIT_SEC)
    same = None
    if not watched.is_alive():
        same = bool(torch.equal(hvd.broadcast(x + 1, 0, name="c8.next"),
                                x + 1))
    ok = not watched.is_alive() and out.get("error") and same
    print("check c8: broadcast of a %s tensor with root 1 at size 1: %s; "
          "the next broadcast (root 0) equal: %s: %s"
          % (x.device.type, "hung past %.0f s" % C8_LIMIT_SEC
             if watched.is_alive() else "raised in %.4f s (%s)"
             % (out["s"], out["error"]), same, "ok" if ok else "FAIL"))
    if not ok:
        errors.append("c8: broadcast with a root outside its set: %s"
                      % out)


# ----------------------------------------------------------------- plan ---

PLAN_STEPS = 3
PLAN_SIZES = (1, 4, 8)


def plan_workloads(hvd_models, planner, tiny=False):
    """The planner's workloads of the three cells, from the port's models
    built on the ``meta`` device (no memory): transformer_long and the
    MoE transformer (batch 4, seq 2048, bf16 activations) and ResNet-50
    (batch 128)."""
    import dataclasses

    import torch

    cfg, batch, seq = slice_config(torch, hvd_models, tiny)
    out = {}
    for name, experts in (("transformer_long", 0), ("moe", MOE_EXPERTS)):
        model = hvd_models.Transformer(dataclasses.replace(
            cfg, num_experts=experts), device="meta")
        out[name] = planner.workload_from_params(
            model, batch=batch, seq_len=seq, n_layers=cfg.n_layers,
            num_experts=experts, dtype_bytes=2)
    out["resnet50"] = planner.workload_from_params(
        hvd_models.ResNet50(device="meta"), batch=8 if tiny else 128,
        dtype_bytes=2)
    return out


def plan_phase(torch, hvd, hvd_models, fa, device, card, errors,
               moe_losses, tiny=False):
    """The planner on the H100 topology (its data-sheet fabric defaults):
    each cell's plan at 1, 4 and 8 devices, then the plan at this world's
    size applied and the MoE transformer trained ``PLAN_STEPS`` steps
    through ``Plan.optimizer``, with the attention launch counters zeroed
    just before and read just after: its losses must be the ``moe:``
    phase's first, bit for bit (same seed, same layout at size 1)."""
    from horovod_tpu_torch.parallel import mesh, planner

    workloads = plan_workloads(hvd_models, planner, tiny)
    for name, w in workloads.items():
        for n in PLAN_SIZES:
            p = planner.plan(workload=w, topology=planner.Topology.make(n))
            print("plan: %s on %d H100: %s" % (name, n, p.summary()))
            print("plan: %s on %d H100 json: %s"
                  % (name, n, json.dumps(p.to_json(), sort_keys=True)))
    p = planner.plan(workload=workloads["moe"],
                     topology=planner.Topology.make(hvd.size()))
    p.apply()
    try:
        res = run_slice(torch, hvd, hvd_models, fa, device, PLAN_STEPS,
                        tiny, num_experts=MOE_EXPERTS, wrap=p.optimizer)
    finally:
        mesh.reset_global_mesh()
        os.environ.pop("HOROVOD_HIERARCHICAL_ALLREDUCE", None)
    losses = res["losses"]
    want = moe_losses[:PLAN_STEPS]
    ok = losses == want
    print("check plan moe losses through Plan.optimizer (mesh %s, sync %s): "
          "%s, the moe: phase's first %d %s: %s"
          % (p.mesh_axes, p.sync, " ".join(repr(x) for x in losses),
             PLAN_STEPS, " ".join(repr(x) for x in want),
             "ok" if ok else "FAIL"))
    if not ok:
        errors.append("plan: losses %s differ from the moe: phase's %s"
                      % (losses, want))
    n = res["cfg"].n_layers * PLAN_STEPS
    ok = all(v == n for v in res["launches"].values()) or not \
        device.startswith("cuda")
    print("check plan attention kernel launches: %s, want %d each: %s"
          % (res["launches"], n, "ok" if ok else "FAIL"))
    if not ok:
        errors.append("plan: attention launches %s, want %d each"
                      % (res["launches"], n))


# ---------------------------------------------------------------- serve ---

SERVE_TRAIN_STEPS = 4    # step N; step N + 1 after one more
SERVE_REQUESTS = 1000
SERVE_CLIENTS = 16
SERVE_MAX_ROWS = 8
SERVE_RELOAD_AT = 300    # requests answered when the reload is sent
SERVE_DRAIN_AT = 650     # requests answered when r1 is drained
SERVE_START_SEC = 180.0
# Each answer against the CPU's plain forward of its step, fp32 (TF32 off
# on the card): relative to the largest logit of the answers.
SERVE_CPU_RTOL = 1e-4

# Run in a fresh process, on the card, as a replica runs: each step's
# requests through the replica's own bucket path (``Replica`` restored at
# that step, each request's rows padded to its bucket, at rows 0 to n-1).
_BUCKET_PATH = r"""
import sys
import numpy as np
from horovod_tpu_torch.serve import batching
from horovod_tpu_torch.serve.replica import Replica
ckpt, src, dst, device = sys.argv[1:5]
data = np.load(src)
r = Replica(model="mnist_cnn", ckpt_dir=ckpt, device=device)
r.load()
out, buckets = {}, r._buckets()
for step in sorted({int(k.split(".")[1]) for k in data if k.startswith("x.")}):
    r._restore_step(step)
    apply, got = r._loaded_state()
    assert got == step
    x, counts = data["x.%d" % step], data["n.%d" % step]
    ys, at = [], 0
    for n in counts:
        rows = x[at:at + n]
        ys.append(apply(batching.pad_to_bucket(
            rows, batching.pick_bucket(int(n), buckets)))[:n])
        at += n
    out["y.%d" % step] = np.concatenate(ys)
np.savez(dst, **out)
"""


def _http(port, method, path, doc=None, timeout=30.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if doc is None
                     else json.dumps(doc))
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _batches_per_bucket(text, buckets):
    """Batches per bucket from a replica's ``/metrics`` text: the real
    row counts' histogram (``hvd_serve_batch_size``), cumulative."""
    le = {float(m.group(1)): float(m.group(2)) for m in re.finditer(
        r'^hvd_serve_batch_size_bucket\{le="([0-9.]+)"\} ([0-9.e+]+)$',
        text, re.M)}
    out, below = {}, 0.0
    for b in buckets:
        at = le.get(float(b), below)
        out[b] = int(at - below)
        below = at
    return out


def serve_train(torch, hvd, hvd_models, device, ckpt_dir):
    """MnistCNN trained on the card through the bucketed optimizer; step
    N saved, then N + 1 after one more step. Returns (N, the CPU state
    dicts by step)."""
    from horovod_tpu_torch.utils.checkpoint import Checkpointer

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    model = hvd_models.MnistCNN(device=device, generator=gen)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.05, momentum=0.9))
    x = torch.randn(64, 1, 28, 28, generator=gen, device=device)
    y = torch.randint(0, 10, (64,), generator=gen, device=device)
    ck = Checkpointer(ckpt_dir, max_to_keep=None)
    states, losses = {}, []
    for step in range(1, SERVE_TRAIN_STEPS + 2):
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(loss.item())
        if step >= SERVE_TRAIN_STEPS:
            state = {k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()}
            states[step] = state
            if step == SERVE_TRAIN_STEPS:
                ck.save(step, {"params": state})
    return SERVE_TRAIN_STEPS, states, losses, ck


def serve_phase(torch, hvd, hvd_models, device, card, errors):
    """The serving path on the card, as a user runs it: MnistCNN trained
    on the card and checkpointed at step N, ``python -m
    horovod_tpu_torch.serve`` (the router and two replicas, subprocesses,
    ``--device`` the card) serving it, step N + 1 saved, then
    ``SERVE_REQUESTS`` requests of 1-``SERVE_MAX_ROWS`` rows from
    ``SERVE_CLIENTS`` client threads through the router, with a directed
    reload to N + 1 of both replicas and a drain of r1 mid-stream. Checks
    that the replicas passed their bucket self-check (they start and
    reload only through it), that every request got a 200, that each
    answer equals the same rows through the replica's own bucket path bit
    for bit, that it is within ``SERVE_CPU_RTOL`` of the CPU's plain
    forward of the step in its tag, and that no request was lost across
    the drain. ``device`` "cpu" rehearses it on the CPU (``--device
    cpu``)."""
    import shutil
    import signal
    import socket
    import tempfile
    import threading

    import numpy as np

    from horovod_tpu_torch.serve import batching

    cuda = device.startswith("cuda")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    ckpt_dir = os.path.join(tmp, "ckpt")
    proc = None
    try:
        step_n, states, train_losses, ck = serve_train(
            torch, hvd, hvd_models, device, ckpt_dir)
        print("serve: MnistCNN trained %d steps on the %s, losses %s; "
              "step %d saved" % (SERVE_TRAIN_STEPS + 1, device,
                                 " ".join("%.4f" % x for x in train_losses),
                                 step_n))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, HVD_HEARTBEAT_SEC="1",
                   HVD_SERVE_CKPT_POLL_SEC="0", PYTHONPATH=os.getcwd()
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.serve", "--ckpt-dir",
             ckpt_dir, "--model", "mnist_cnn", "--np", "2", "--port",
             str(port), "--journal-dir", os.path.join(tmp, "journal"),
             "--device", "cuda" if cuda else "cpu"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log = []

        def pump():
            for line in proc.stdout:
                log.append(line)

        threading.Thread(target=pump, daemon=True).start()
        while not any("SERVE_FLEET_READY" in line for line in log):
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > SERVE_START_SEC:
                raise RuntimeError("the fleet did not start:\n%s"
                                   % "".join(log[-40:]))
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        ck.save(step_n + 1, {"params": states[step_n + 1]})
        _, text = _http(port, "GET", "/healthz")
        table = json.loads(text)["replicas"]
        replicas = {rid: info["port"] for rid, info in sorted(table.items())}
        print("serve: router and %d replicas up in %.3f s (the fleet's "
              "bucket self-check passed on the %s at load); step %d saved"
              % (len(replicas), start_s, device, step_n + 1))

        rng = np.random.RandomState(SEED + 11)
        counts = rng.randint(1, SERVE_MAX_ROWS + 1, SERVE_REQUESTS)
        rows = rng.standard_normal((int(counts.sum()), 28, 28, 1)) \
            .astype(np.float32)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        results = [None] * SERVE_REQUESTS
        lock = threading.Lock()
        state = {"next": 0, "done": 0}
        marks = {}

        def client():
            while True:
                with lock:
                    i = state["next"]
                    if i >= SERVE_REQUESTS:
                        return
                    state["next"] += 1
                x = rows[offsets[i]:offsets[i + 1]]
                sent = time.perf_counter()
                try:
                    status, body = _http(port, "POST", "/v1/predict",
                                         {"inputs": x.tolist()})
                except OSError as e:
                    status, body = -1, str(e)
                took = time.perf_counter() - sent
                results[i] = (status, body, sent, took)
                with lock:
                    state["done"] += 1

        def controller():
            while state["done"] < SERVE_RELOAD_AT:
                time.sleep(0.005)
            marks["reload_sent"] = time.perf_counter()
            for rid, rport in replicas.items():
                t = time.perf_counter()
                status, body = _http(rport, "POST", "/v1/reload",
                                     {"step": step_n + 1}, timeout=120)
                marks["reload." + rid] = (status, json.loads(body),
                                          time.perf_counter() - t)
            marks["reloaded"] = time.perf_counter()
            for rid, rport in replicas.items():
                marks["metrics." + rid] = _http(rport, "GET", "/metrics")[1]
            while state["done"] < SERVE_DRAIN_AT:
                time.sleep(0.005)
            marks["drain"] = _http(port, "POST", "/v1/drain",
                                   {"replica": "r1"})

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(SERVE_CLIENTS)]
        ctl = threading.Thread(target=controller, daemon=True)
        t_load = time.perf_counter()
        ctl.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        ctl.join(120)
        wall = time.perf_counter() - t_load
        r0_metrics = _http(replicas["r0"], "GET", "/metrics")[1]
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline:
            table = json.loads(_http(port, "GET", "/healthz")[1])
            if "r1" not in table["replicas"]:
                break
            time.sleep(0.2)
        culled = "r1" not in table["replicas"]

        ok200 = [r for r in results if r is not None and r[0] == 200]
        docs = [json.loads(r[1]) for r in ok200]
        lat = sorted(r[3] * 1e3 for r in ok200)
        p50 = lat[len(lat) // 2] if lat else float("nan")
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat \
            else float("nan")
        print("serve: %d requests (%d rows) from %d clients in %.3f s: "
              "%.1f rows/s, %.1f requests/s, latency p50 %.3f ms p99 %.3f "
              "ms, on %s" % (SERVE_REQUESTS, int(counts.sum()),
                             SERVE_CLIENTS, wall, counts.sum() / wall,
                             SERVE_REQUESTS / wall, p50, p99, card))
        buckets = batching.bucket_sizes(8, 4)
        for rid in replicas:
            print("serve: %s batches per bucket before the drain %s; "
                  "directed reload to step %d: status %s in %.3f ms"
                  % (rid, _batches_per_bucket(
                      marks.get("metrics." + rid, ""), buckets), step_n + 1,
                     marks.get("reload." + rid, (None,))[0],
                     1e3 * marks.get("reload." + rid, (0, 0, 0))[2]))
        print("serve: r0 batches per bucket at the end %s"
              % _batches_per_bucket(r0_metrics, buckets))
        by_replica = {}
        for d in docs:
            by_replica[d["replica"]] = by_replica.get(d["replica"], 0) + 1

        ok = len(ok200) == SERVE_REQUESTS
        print("check serve every request answered 200: %d of %d (by "
              "replica %s): %s" % (len(ok200), SERVE_REQUESTS, by_replica,
                                   "ok" if ok else "FAIL"))
        if not ok:
            bad = [r[:2] for r in results if r is None or r[0] != 200][:3]
            errors.append("serve: %d of %d requests answered 200; %s"
                          % (len(ok200), SERVE_REQUESTS, bad))
        reloads = [marks.get("reload." + rid, (None,))[0]
                   for rid in replicas]
        drain = marks.get("drain", (None, ""))
        ok = reloads == [200, 200] and drain[0] == 200 and culled
        print("check serve reload and drain: reloads %s, drain of r1 %s, "
              "r1 culled by its goodbye %s: %s"
              % (reloads, drain[0], culled, "ok" if ok else "FAIL"))
        if not ok:
            errors.append("serve: reloads %s, drain %s, culled %s"
                          % (reloads, drain, culled))
        if len(ok200) != SERVE_REQUESTS:
            return
        steps = [d["step"] for d in docs]
        after = [d["step"] for d, r in zip(docs, results)
                 if r[2] > marks["reloaded"]]
        ok = set(steps) <= {step_n, step_n + 1} and \
            set(after) <= {step_n + 1} and step_n in steps
        print("check serve step tags: %d at step %d, %d at step %d; sent "
              "after both reloads: %d, all at step %d: %s"
              % (steps.count(step_n), step_n, steps.count(step_n + 1),
                 step_n + 1, len(after), step_n + 1,
                 "ok" if ok else "FAIL"))
        if not ok:
            errors.append("serve: step tags %s" % sorted(set(steps)))

        # The replica's own bucket path, in a fresh process on the card.
        feed = {}
        for step in (step_n, step_n + 1):
            idx = [i for i in range(SERVE_REQUESTS) if steps[i] == step]
            if idx:
                feed["x.%d" % step] = np.concatenate(
                    [rows[offsets[i]:offsets[i + 1]] for i in idx])
                feed["n.%d" % step] = counts[idx]
        np.savez(os.path.join(tmp, "feed.npz"), **feed)
        run = subprocess.run(
            [sys.executable, "-c", _BUCKET_PATH, ckpt_dir,
             os.path.join(tmp, "feed.npz"), os.path.join(tmp, "path.npz"),
             "cuda" if cuda else "cpu"],
            env=env, capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError("the bucket path failed:\n%s"
                               % run.stderr[-3000:])
        worst_bits, worst_cpu = 0, 0.0
        path = dict(np.load(os.path.join(tmp, "path.npz")))
        for step in (step_n, step_n + 1):
            idx = [i for i in range(SERVE_REQUESTS) if steps[i] == step]
            if not idx:
                continue
            got = np.concatenate([np.asarray(docs[i]["outputs"],
                                             np.float32) for i in idx])
            worst_bits += int((got != path["y.%d" % step]).any(-1)
                              .sum())
            cpu_model = hvd_models.MnistCNN(device="cpu")
            cpu_model.load_state_dict(states[step])
            cpu_model.eval()
            with torch.no_grad():
                want = cpu_model(torch.from_numpy(
                    feed["x.%d" % step]).permute(0, 3, 1, 2)).numpy()
            worst_cpu = max(worst_cpu, float(
                np.abs(got - want).max() / np.abs(want).max()))
        ok = worst_bits == 0
        print("check serve answers (co-batched at any row of buckets %s) "
              "against the replica's own bucket path (rows 0 to n-1, a "
              "fresh process), bit for bit: %d rows differ: %s"
              % (buckets, worst_bits, "ok" if ok else "FAIL"))
        if not ok:
            errors.append("serve: %d rows differ from the bucket path (%s)"
                          % (worst_bits, run.stderr[-300:]))
        ok = worst_cpu <= SERVE_CPU_RTOL
        print("check serve answers against the CPU's plain forward of "
              "their step: worst %.3e of the largest logit (limit %.0e): "
              "%s" % (worst_cpu, SERVE_CPU_RTOL, "ok" if ok else "FAIL"))
        if not ok:
            errors.append("serve: answers off the CPU forward by %.3e"
                          % worst_cpu)
    except Exception as e:  # noqa: BLE001 — the phase fails, the run goes on
        errors.append("serve: %s: %s" % (type(e).__name__, e))
        print("check serve: FAIL (%s: %s)" % (type(e).__name__, e))
    finally:
        if proc is not None and proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------- spark ---

SPARK_STEPS = 3             # (a): the slice's steps in one Spark task
SPARK_ELASTIC_STEPS = 4     # (b)
SPARK_FAIL_STEP = 2         # (b): HorovodInternalError, once, at this step
SPARK_ROWS = 32             # (c): rows of the slice's length + 1 ids
SPARK_BATCH = 4
SPARK_EPOCHS = 2
SPARK_PREDICT_ROWS = 2


class TokenLM(_torch.nn.Module if _torch is not None else object):
    """The estimator's model: a transformer over the float feature
    matrix, whose columns are token ids (exact in fp32 below 2^24), cast
    back to ids; returns the fp32 logits."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm

    def forward(self, x):
        return self.lm(x.long())


def token_loss(logits, y):
    """Next-token cross entropy against the label columns (token ids)."""
    import torch

    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long())


def spark_adamw(params):
    """The estimator's ``optimizer=``: the slice's AdamW."""
    import torch

    return torch.optim.AdamW(params, lr=1e-3, weight_decay=1e-4)


def _weights_sha(torch, model):
    import hashlib

    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def spark_slice_task(steps, tiny=False):
    """A Spark task of (a): ``init()``, then transformer_long through
    ``run_slice`` and the bucketed ``DistributedOptimizer``. Returns the
    losses, the attention kernels' launches, the device, whether jax was
    imported, and the wall times at the call's start (the task process
    spawned and the call unpickled), after the imports, after ``init`` and
    just before the first step."""
    entered = time.time()
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    times = {"entered": entered, "imported": time.time()}
    hvd.init()
    device = basics.init_device()
    times["initialized"] = time.time()

    def wrap(inner):
        times["first_step"] = time.time()  # the model is built
        return hvd.DistributedOptimizer(inner)

    res = run_slice(torch, hvd, models, fa, device, steps, tiny=tiny,
                    wrap=wrap)
    out = dict(rank=hvd.rank(), size=hvd.size(), device=device,
               losses=res["losses"], launches=res["launches"],
               jax="jax" in sys.modules, **times)
    hvd.shutdown()
    return out


def spark_elastic_state(torch, hvd_models, tiny=False):
    """(b)'s state: transformer_long (the slice's config; the weights from
    the seed on the CPU, so that each task moves them to its own device)
    and a plain AdamW, under a ``TorchState`` at step 0. Returns the
    state, the model and the optimizer, which ``run_elastic`` pickles
    together: they stay one model in the task."""
    from horovod_tpu_torch import elastic

    cfg, _, _ = slice_config(torch, hvd_models, tiny)
    model = hvd_models.Transformer(
        cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    opt = spark_adamw(model.parameters())
    return elastic.TorchState(model, opt, step=0), model, opt


def spark_elastic_task(state, model, optimizer, steps, fail_step, marker,
                       tiny=False):
    """The function of (b), under ``spark.run_elastic``: the model moves
    to ``init``'s device, then each step (its batch from a seed of its
    own, so that a retried step sees its batch again) runs the backward,
    the bucketed ``allreduce_gradients`` and the update, and commits. At
    ``fail_step`` the first call raises ``HorovodInternalError`` after the
    update and before the commit, and writes the time to ``marker.<rank>``.
    Returns the step, the weights' sha256, the device, the step the call
    started from, ``init``'s generation and the wall time at its start."""
    entered = time.time()
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = basics.init_device()
    model.to(device)
    cfg, batch, seq = slice_config(torch, models, tiny)
    params = [p for p in model.parameters() if p.requires_grad]
    started_from = state.step
    while state.step < steps:
        step = state.step + 1
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, seq), device=device,
            generator=torch.Generator(device=device).manual_seed(
                1000 * SEED + step))
        loss = models.lm_loss(model(tokens), tokens)
        loss.backward()
        for p, g in zip(params, hvd.allreduce_gradients(
                [p.grad for p in params])):
            p.grad.copy_(g)
        optimizer.step()
        optimizer.zero_grad()
        mark = "%s.%d" % (marker, hvd.rank()) if marker else None
        if step == fail_step and mark and not os.path.exists(mark):
            with open(mark, "w") as f:
                f.write(repr(time.time()))
            raise HorovodInternalError("raised once, at step %d" % step)
        state.step = step
        state.commit()
    return dict(rank=hvd.rank(), step=state.step, device=device,
                checksum=_weights_sha(torch, model),
                started_from=started_from,
                generation=basics.init_generation(), entered=entered,
                jax="jax" in sys.modules)


def spark_table(torch, hvd_models, tiny=False):
    """(c)'s rows: ``SPARK_ROWS`` sequences of the slice's length + 1
    from the seed; ``x`` the first ``seq`` tokens, ``y`` the last ``seq``,
    as int64 array columns. The ids are drawn with Zipf frequencies (id k
    with odds 1 / (k + 1)), as words occur in text: uniform ids leave 16
    steps nothing to learn, and their loss need not fall."""
    import pandas as pd

    cfg, _, seq = slice_config(torch, hvd_models, tiny)
    odds = 1.0 / torch.arange(1, cfg.vocab_size + 1, dtype=torch.float64)
    rows = torch.multinomial(
        odds / odds.sum(), SPARK_ROWS * (seq + 1), replacement=True,
        generator=torch.Generator().manual_seed(SEED))
    rows = rows.view(SPARK_ROWS, seq + 1).numpy()
    return rows, pd.DataFrame({"x": list(rows[:, :-1]),
                               "y": list(rows[:, 1:])})


def spark_plain_fit(torch, model_bytes, rows, device):
    """(c)'s plain loop: the estimator's model bytes, rows, order and
    optimizer, with no estimator, store or launcher; returns the model
    and each epoch's last loss."""
    import io

    torch.manual_seed(0)  # the estimator's random_seed + rank
    model = torch.load(io.BytesIO(model_bytes), weights_only=False,
                       map_location="cpu").to(device)
    opt = spark_adamw(model.parameters())
    x = torch.tensor(rows[:, :-1].astype("float32"), device=device)
    y = torch.tensor(rows[:, 1:].astype("float32"), device=device)
    order = torch.arange(len(x))
    losses = []
    for _ in range(SPARK_EPOCHS):
        for bi in range(len(x) // SPARK_BATCH):
            idx = order[bi * SPARK_BATCH:(bi + 1) * SPARK_BATCH]
            opt.zero_grad()
            loss = token_loss(model(x[idx]), y[idx])
            loss.backward()
            opt.step()
        losses.append(float(loss.detach()))
    return model, losses


def spark_estimator(torch, hvd_models, fa, device, card, check, tiny=False):
    """(c): ``TorchEstimator`` fitted inline (``LocalBackend(num_proc=1)``)
    on transformer_long wrapped in ``TokenLM``, held to the plain loop;
    then ``predict`` on the device and ``save``/``load``."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from horovod_tpu_torch.spark.common import FilesystemStore, LocalBackend
    from horovod_tpu_torch.spark.torch import TorchEstimator, TorchModel

    cfg, _, _ = slice_config(torch, hvd_models, tiny)
    lm = TokenLM(hvd_models.Transformer(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(SEED)))
    rows, pdf = spark_table(torch, hvd_models, tiny)
    tmp = tempfile.mkdtemp(prefix="hvd_spark_")
    try:
        store = FilesystemStore(tmp)
        est = TorchEstimator(
            model=lm, loss=token_loss, optimizer=spark_adamw,
            feature_cols=["x"], label_cols=["y"], batch_size=SPARK_BATCH,
            epochs=SPARK_EPOCHS, shuffle=False, random_seed=0, verbose=0,
            store=store, run_id="spark_phase",
            backend=LocalBackend(num_proc=1, platform="gpu"
                                 if device.startswith("cuda") else "cpu"))
        fa.reset_launches()
        t0 = time.perf_counter()
        fitted = est.fit(pdf)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in fa.KERNELS}
        ckpt = torch.load(io.BytesIO(store.read(store.get_checkpoint_path(
            "spark_phase"))), weights_only=False)
        buf = io.BytesIO()
        torch.save(lm, buf)
        t0 = time.perf_counter()
        plain, plain_losses = spark_plain_fit(torch, buf.getvalue(), rows,
                                              device)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        steps = SPARK_EPOCHS * (SPARK_ROWS // SPARK_BATCH)
        print("spark: estimator transformer_long (TokenLM), %d rows of %d "
              "tokens, batch %d, %d epochs (%d steps): history %s, plain "
              "loop %s; fit %.3f s (the Parquet write and read, %d steps, "
              "the checkpoint), the plain loop %.3f s; launches %s, on %s"
              % (SPARK_ROWS, rows.shape[1], SPARK_BATCH, SPARK_EPOCHS,
                 steps, fitted.history, plain_losses, fit_s, steps,
                 plain_s, launches, card))
        hist = fitted.history
        check("estimator history", len(hist) == SPARK_EPOCHS and all(
            math.isfinite(v) for v in hist) and hist[-1] < hist[0]
            and hist == plain_losses,
            "%s, finite and falling, bit for bit against the plain loop "
            "%s" % (hist, plain_losses))
        want = cfg.n_layers * steps if device.startswith("cuda") else 0
        check("estimator launches", all(
            n == want for n in launches.values()),
            "%s, %d each expected" % (launches, want))
        plain_sd = plain.state_dict()
        same = sorted(ckpt) == sorted(plain_sd) and all(
            ckpt[k].device.type == "cpu"
            and torch.equal(ckpt[k], plain_sd[k].cpu()) for k in ckpt)
        check("estimator checkpoint", same,
              "%d tensors on the CPU, bit for bit against the plain loop's"
              % len(ckpt))
        probe = rows[:SPARK_PREDICT_ROWS, :-1].astype("float32")
        got = fitted.predict(probe, device=device)
        plain.eval()
        with torch.no_grad():
            want_out = plain(torch.tensor(probe, device=device)).cpu().numpy()
        check("estimator predict", isinstance(got, np.ndarray) and
              got.shape == want_out.shape and np.array_equal(got, want_out),
              "%s on %s, bit for bit against the plain loop's forward"
              % (getattr(got, "shape", None), device))
        fitted.save()
        loaded = TorchModel.load(store, "spark_phase")
        again = loaded.predict(probe, device=device)
        check("estimator save/load", type(loaded) is TorchModel and
              loaded.history == hist and np.array_equal(again, got),
              "%s, history and predictions equal" % type(loaded).__name__)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def spark_phase(torch, hvd_models, fa, device, card, errors, slice_losses,
                n_layers, platform="gpu", tiny=False):
    """The Spark path on one card (see the module docstring, 17): (a)
    ``spark.run`` of the slice in a task, (b) ``spark.run_elastic`` with
    one raised failure, (c) ``TorchEstimator`` inline when pandas and
    pyarrow import. The tasks run over tests/fake_pyspark.py (real
    processes and barriers). ``platform`` ``cpu`` and ``tiny`` rehearse
    it on the CPU, where each kernel launches no time."""
    import importlib.util
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    tests = os.path.join(root, "tests")
    gpu = platform == "gpu"

    def check(name, ok, detail):
        print("check spark %s: %s: %s" % (name, detail,
                                         "ok" if ok else "FAIL"))
        if not ok:
            errors.append("spark: %s: %s" % (name, detail))

    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="hvd_spark_")
    sys.path.insert(0, root)
    sys.path.insert(0, tests)
    try:
        import fake_pyspark

        # The tasks unpickle these functions by reference: this file's
        # module, not __main__.
        import chip_smoke as smoke
        from horovod_tpu_torch import spark

        fake_pyspark.install()
        try:
            # (b)'s uninterrupted run, here; then (a) and (b)'s Spark jobs
            # at the same time: each is a barrier job of one task, whose
            # time is mostly the task's start-up.
            state, model, opt = spark_elastic_state(torch, hvd_models, tiny)
            whole = smoke.spark_elastic_task(
                state, model, opt, SPARK_ELASTIC_STEPS, 0, None, tiny)
            marker = os.path.join(tmp, "raised")
            state, model, opt = spark_elastic_state(torch, hvd_models, tiny)
            t0 = time.time()
            with concurrent.futures.ThreadPoolExecutor(1) as pool:
                elastic = pool.submit(
                    spark.run_elastic, smoke.spark_elastic_task,
                    args=(state, model, opt, SPARK_ELASTIC_STEPS,
                          SPARK_FAIL_STEP, marker, tiny),
                    num_proc=1, retries=1, platform=platform)
                res = spark.run(smoke.spark_slice_task,
                                args=(SPARK_STEPS, tiny), num_proc=1,
                                platform=platform)[0]
                a_s = time.time() - t0
                got = elastic.result()[0]
                b_s = time.time() - t0

            # (a) The slice in one barrier task.
            print("spark: run(num_proc=1) transformer_long, %d steps, "
                  "losses %s (phase 4: %s), launches %s on %s; %.3f s from "
                  "run() to the task's first step (the call started at "
                  "%.3f s: the task spawned, the call unpickled and the "
                  "package imported; its imports done at %.3f s, init at "
                  "%.3f s, then the model), %.3f s to the result, beside "
                  "(b)'s job, on %s"
                  % (SPARK_STEPS, res["losses"],
                     slice_losses[:SPARK_STEPS], res["launches"],
                     res["device"], res["first_step"] - t0,
                     res["entered"] - t0, res["imported"] - t0,
                     res["initialized"] - t0, a_s, card))
            check("run losses", res["losses"] == slice_losses[:SPARK_STEPS],
                  "bit for bit against phase 4's first %d" % SPARK_STEPS)
            want = n_layers * SPARK_STEPS if gpu else 0
            check("run launches", all(
                n == want for n in res["launches"].values()),
                "%s, %d each expected" % (res["launches"], want))
            check("run device", res["device"] == ("cuda:0" if gpu
                                                  else "cpu")
                  and not res["jax"] and res["size"] == 1,
                  "%s, size %d, jax imported: %s"
                  % (res["device"], res["size"], res["jax"]))

            # (b) run_elastic: one raised failure, against the same run
            # uninterrupted.
            res = got
            raised = (float(open(marker + ".0").read())
                      if os.path.exists(marker + ".0") else float("nan"))
            print("spark: run_elastic(num_proc=1, retries=1) "
                  "transformer_long, %d steps, HorovodInternalError at "
                  "step %d: retried from step %s after a shutdown and init "
                  "(init generation %s), %.3f s from the raise to the "
                  "retry's start, %.3f s to the result; weights %s, "
                  "uninterrupted %s, on %s"
                  % (SPARK_ELASTIC_STEPS, SPARK_FAIL_STEP,
                     res["started_from"], res["generation"],
                     res["entered"] - raised, b_s,
                     res["checksum"][:16], whole["checksum"][:16], card))
            check("run_elastic", os.path.exists(marker + ".0") and
                  res["started_from"] == SPARK_FAIL_STEP - 1 and
                  res["generation"] == 2 and
                  res["step"] == SPARK_ELASTIC_STEPS and
                  res["device"] == ("cuda:0" if gpu else "cpu")
                  and not res["jax"],
                  "raised once, retried from step %s, generation %s, "
                  "step %s, on %s" % (res["started_from"],
                                      res["generation"], res["step"],
                                      res["device"]))
            check("run_elastic weights", res["checksum"] ==
                  whole["checksum"],
                  "sha256 against the uninterrupted run's")
        finally:
            fake_pyspark.uninstall()

        # (c) The estimator, where pandas and pyarrow are installed.
        missing = [m for m in ("pandas", "pyarrow")
                   if importlib.util.find_spec(m) is None]
        if missing:
            print("spark: the estimator waits for %s: not installed here; "
                  "(c) did not run" % " and ".join(missing))
        else:
            spark_estimator(torch, hvd_models, fa, device, card, check,
                            tiny)
    except Exception as e:  # noqa: BLE001 — the phase fails, the run goes on
        errors.append("spark: %s: %s" % (type(e).__name__, e))
        print("check spark: FAIL (%s: %s)" % (type(e).__name__, e))
    finally:
        sys.path.remove(tests)
        sys.path.remove(root)
        shutil.rmtree(tmp, ignore_errors=True)
        print("spark: the phase took %.1f s" % (time.perf_counter()
                                                 - phase_t0))


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
    t_start = time.perf_counter()

    def done(phase):
        print("phase %s: done at %.1f s of the script's run"
              % (phase, time.perf_counter() - t_start))

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
              "flash_attention_wide.cu":
                  lambda: _build.build("flash_attention_wide"),
              "fusion.cu": lambda: _build.build("fusion"),
              "adasum.cu": lambda: _build.build("adasum"),
              "codec.cu": lambda: _build.build("codec"),
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
    for lib in ("flash_attention", "flash_attention_wide", "fusion",
                "adasum", "codec"):
        _build.load(lib)
        for row in ptxas_summary(_build.build_logs.get(lib, "")):
            print("ptxas: " + row)
    # Dynamic shared memory of this slice's new kernels, as launched.
    lib, wide = _build.load("flash_attention"), \
        _build.load("flash_attention_wide")
    for dtype in ("bfloat16", "float16"):
        print("smem: fwd_wgmma_kernel %s" % ", ".join(
            "D=%d %d bytes" % (dd, lib.hvd_flash_smem(
                0, dd, fa._DTYPE_CODES[getattr(torch, dtype)]))
            for dd in fa.HEAD_DIMS) + " (%s, dynamic)" % KINDS[dtype])
    for dtype in ("float32", "bfloat16", "float16"):
        print("smem: wide fwd/dkv/dq %s (%s, dynamic)" % (", ".join(
            "D=%d %s" % (dd, "/".join(
                str(wide.hvd_flash_smem(
                    which, dd, fa._DTYPE_CODES[getattr(torch, dtype)]))
                for which in range(3))) for dd in (192, 256, 512)),
            KINDS[dtype]))
    for dtype in ("bfloat16", "float16"):
        code = fa._DTYPE_CODES[getattr(torch, dtype)]
        print("smem: wide bf16/fp16 forward %s" % ", ".join(
            "D=%d %d bytes" % (dd, wide.hvd_flash_smem(0, dd, code))
            for dd in fa.WIDE_FWD_TILES) + " (%s, dynamic)" % KINDS[dtype])
        print("smem: wide bf16/fp16 dK/dV, dQ %s" % ", ".join(
            "D=%d %d/%d bytes" % (dd, wide.hvd_flash_smem(1, dd, code),
                                  wide.hvd_flash_smem(2, dd, code))
            for dd in fa.WIDE_BWD_TILES) + " (%s, dynamic)" % KINDS[dtype])
    # Every Hopper kernel's SASS holds wgmma (HGMMA) and TMA loads
    # (UTMALDG): the forward of both libraries, and the wide backward.
    for lib_name, n_kernels in (
            ("flash_attention", 2 * len(fa.HEAD_DIMS)),
            ("flash_attention_wide",
             2 * len(fa.WIDE_FWD_TILES) + 4 * len(fa.WIDE_BWD_TILES))):
        t0 = time.perf_counter()
        ops = sass_ops(_build.library_path(lib_name))
        print("sass: cuobjdump of %s read in %.1f s"
              % (lib_name, time.perf_counter() - t0))
        for name, found in sorted(ops.items()):
            dim = re.search(r"Li(\d+)E", name)
            print("sass: %s D=%s %s: %s"
                  % (re.search(r"(wide_fwd|wide_dkv|wide_dq_rows|wide_dq|"
                               r"fwd)_wgmma_kernel", name).group(0),
                     dim.group(1) if dim else "?",
                     "bf16" if "bfloat16" in name else "fp16",
                     " ".join(sorted(found)) or "none"))
        if len(ops) != n_kernels or any(
                found != {"HGMMA", "UTMALDG"} for found in ops.values()):
            print("FAIL: the SASS of %s's Hopper kernels lacks HGMMA or "
                  "UTMALDG (%d kernels found, %d expected)"
                  % (lib_name, len(ops), n_kernels), file=sys.stderr)
            return 1
    # The wide library's wgmma kernels keep everything in registers.
    spilled = [row for row in ptxas_summary(
        _build.build_logs.get("flash_attention_wide", ""))
        if "(wgmma)" in row and " 0 bytes spilled" not in row]
    if spilled:
        print("FAIL: wgmma kernels spill: %s" % "; ".join(spilled),
              file=sys.stderr)
        return 1

    device = "cuda"
    done("build")
    kernel_results = kernel_phase(torch, fa, device)
    if "--parent" in sys.argv:
        parent_forward_ab(torch, fa, sys.argv[sys.argv.index("--parent")
                                              + 1], device)
    else:
        print("ab forward: not run (python3 chip_smoke.py --parent DIR "
              "times an unpacked parent tree's forward in turns)")
    done("kernels")

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
    introspect_checks(torch, res, card, errors)
    done("slice")
    tune_phase(torch, hvd, hvd_models, fa, device, card, errors, losses)
    res16 = fp16_slice_phase(torch, hvd, hvd_models, fa, device, card,
                             errors)
    wide_launches = wide_phase(torch, hvd, hvd_models, fa, device, card,
                               errors)
    done("tune, fp16 and wide")
    launch_phase(torch, card, errors, losses, cfg.n_layers)
    done("launch")
    resnet_phase(torch, hvd, hvd_models, fa, device, card, errors)
    done("resnet")
    eager_kernels, eager_losses = eager_phase(torch, hvd, hvd_models, device,
                                              card, errors)
    done("eager")
    eager_kernels += adasum_phase(torch, hvd_models, device, card, errors,
                                  eager_losses)
    done("adasum")
    eager_kernels += codec_phase(torch, hvd_models, device, card, errors)
    done("codec")
    observability_phase(torch, hvd, hvd_models, device, card, errors)
    done("observability")
    moe_losses = moe_phase(torch, hvd, hvd_models, fa, device, card, errors)
    plan_phase(torch, hvd, hvd_models, fa, device, card, errors, moe_losses)
    done("moe and plan")
    sequence_phase(torch, hvd, hvd_models, device, card, errors)
    done("sequence")
    elastic_phase(torch, hvd, hvd_models, fa, device, card, errors)
    done("elastic")
    tuning_phase(torch, hvd, hvd_models, device, card, errors)
    c8_check(torch, hvd, device, errors)
    done("tuning and c8")
    serve_phase(torch, hvd, hvd_models, device, card, errors)
    done("serve")
    spark_phase(torch, hvd_models, fa, device, card, errors, losses,
                cfg.n_layers)
    done("spark")
    hvd.shutdown()
    if errors:
        for e in errors:
            print("FAIL: " + e, file=sys.stderr)
        return 1

    replaces = {"flash_fwd": 55, "flash_bwd_dkv": 114, "flash_bwd_dq": 174}
    kernels = []
    # bf16 launches are phase 4's, fp16 launches the fp16 slice's.
    for dtype, run in (("bf16", res), ("fp16", res16)):
        slice_abs, timings, bnd = kernel_results[dtype]
        for name, (ms, plain_ms, lib_ms) in timings.items():
            kernels.append({
                "name": name if dtype == "bf16" else "%s_%s" % (name, dtype),
                "route": "cuda",
                "source": "horovod_tpu_torch/csrc/%s" % (
                    "hopper_fwd.cuh" if name == "flash_fwd"
                    else "flash_attention.cu"),
                "replaces": "horovod_tpu/ops/pallas_attention.py:%d"
                            % replaces[name],
                "launches": run["launches"][name],
                "max_abs_err": slice_abs[name],
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
                "library_ms": lib_ms,
            })
    # The wide family: launches from the wide path, errors from the check
    # at its attention, times at Qwen3-Next-80B-A3B's (head dim 256, whose
    # bf16 forward is hopper_fwd.cuh's kernel).
    wide_abs, timings, bnd = kernel_results["wide"]
    for name, (ms, plain_ms, lib_ms) in timings.items():
        kernels.append({
            "name": name + "_wide", "route": "cuda",
            "source": "horovod_tpu_torch/csrc/%s" % (
                "hopper_fwd.cuh" if name == "flash_fwd"
                else "flash_attention_wide.cu"),
            "replaces": "horovod_tpu/ops/pallas_attention.py:%d"
                        % replaces[name],
            "launches": wide_launches[name],
            "max_abs_err": wide_abs[name],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[name][0], "bound_by": bnd[name][1],
            "library_ms": lib_ms,
        })
    kernels += eager_kernels
    below = ["%s %s %.4f ms < %.4f ms" % (k["name"], key, k[key],
                                          k["bound_ms"])
             for k in kernels for key in ("ms", "ms_phase2")
             if key in k and k[key] < k["bound_ms"]]
    if below:
        # No kernel beats the card's own rate: its inputs were in L2.
        print("FAIL: timed below the bound: %s" % ", ".join(below),
              file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
