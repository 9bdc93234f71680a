"""The online tuner's knob schema: what it may search and how a value
reaches the running system.

Port of the tunable-knob part of ``horovod_tpu/common/knobs.py`` (:471-562):
``TunableKnob``, ``TUNABLE`` and ``tunable_snap``, with every row unchanged,
so that ``utils/online_tuner.schema_fence`` hashes the same names, boxes and
steps in both packages and a tuner journal written by either replays in the
other. The environment knobs these rows mirror (``HOROVOD_FUSION_THRESHOLD``,
``HVD_RING_CHUNK_BYTES``, ``HVD_GRAD_BUCKET_BYTES``, ...) and the tuner's own
(``HVD_TUNE``, ``HVD_TUNE_WINDOW_SEC``, ``HVD_TUNE_GUARD_PCT``,
``HVD_TUNE_JOURNAL_DIR``, ``HVD_TUNE_FREEZE``) keep the reference's
registered meaning.

Three apply paths exist:

- "native":  pushed into the live core through ``CoreSession``
             (``set_params`` / ``set_wire_params`` / ``stage_wire_codec``):
             takes effect within a cycle, with no restart;
- "env":     written to ``os.environ`` and read at next use: the next
             optimizer construction, connect or kernel call that consults
             the knob;
- "setter":  a callable the owning subsystem registers with the tuner (the
             serving replica's micro-batch knobs, with ROADMAP A13).

``live_safe=False`` marks knobs whose per-rank mutation mid-run makes the
ranks diverge. In the port, ``HVD_GRAD_BUCKET_BYTES`` is read when the
bucketed optimizer is built (``optimizer.py``): ranks with different
buckets issue NCCL allreduces of different sizes, which hangs or corrupts.
The tuner searches such knobs only while the process is alone in its
world. The ``flash_block_q``/``flash_block_k`` boxes are the reference's
(its tiles were derived for the TPU); the card's attention kernels take
only 64-row tiles (ROADMAP A4, B.4), and the training role does not
search them. The planner's rows wait for ROADMAP A11, the serving rows
for A13.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional


class TunableKnob(NamedTuple):
    name: str         # schema name (journal records, HVD_TUNE_FREEZE)
    lo: float         # search box, inclusive
    hi: float
    step: float       # proposal granularity: values snap to lo + k*step
    apply_path: str   # "native" | "env" | "setter"
    env: Optional[str]  # backing env knob (mirrored on apply when set)
    default: float    # the no-tuner value (docs/configuration.md)
    live_safe: bool   # safe to mutate per-rank mid-run (see above)
    detail: str


TUNABLE: Dict[str, TunableKnob] = {t.name: t for t in [
    TunableKnob("fusion_threshold_mb", 0.0, 64.0, 1.0, "native",
                "HOROVOD_FUSION_THRESHOLD", 128.0, True,
                "eager fusion-buffer threshold (MB; the env knob is "
                "bytes); staged through the coordinator broadcast so "
                "layouts stay rank-identical (core/session.set_params)"),
    TunableKnob("cycle_time_ms", 1.0, 100.0, 0.5, "native",
                "HOROVOD_CYCLE_TIME", 1.0, True,
                "background negotiation-loop cadence "
                "(core/session.set_params; applies locally)"),
    TunableKnob("ring_chunk_bytes", 0.0, float(16 << 20),
                float(64 << 10), "native", "HVD_RING_CHUNK_BYTES",
                float(1 << 20), True,
                "pipelined-ring sub-chunk size; atomic, read per ring "
                "step (core/session.set_wire_params; 0 = serial "
                "schedule). Local reduce scheduling only — divergence "
                "across ranks cannot desync the wire protocol"),
    TunableKnob("socket_buf_bytes", 0.0, float(16 << 20),
                float(64 << 10), "native", "HOROVOD_SOCKET_BUF_BYTES",
                0.0, True,
                "SO_SNDBUF/SO_RCVBUF on data-plane sockets; resizes "
                "live fds + pins an override for future connects "
                "(core/session.set_wire_params; 0 = kernel default "
                "for future sockets only)"),
    TunableKnob("grad_bucket_bytes", 0.0, float(64 << 20),
                float(1 << 20), "env", "HVD_GRAD_BUCKET_BYTES",
                float(4 << 20), False,
                "in-graph gradient-bucket payload; read at TRACE time "
                "— per-rank divergence lowers divergent psum sequences "
                "(docs/mfu.md), so live search is single-process only"),
    TunableKnob("flash_block_q", 128.0, 512.0, 128.0, "env",
                "HVD_FLASH_BLOCK_Q", 256.0, False,
                "flash-attention query tile; trace-time read, same "
                "rank-divergence hazard as grad_bucket_bytes (the "
                "shape-keyed sweep in ops/block_tuner.py is the "
                "preferred tuner for this one)"),
    TunableKnob("flash_block_k", 128.0, 512.0, 128.0, "env",
                "HVD_FLASH_BLOCK_K", 512.0, False,
                "flash-attention key/value tile; see flash_block_q"),
    TunableKnob("serve_max_batch", 1.0, 64.0, 1.0, "setter",
                "HVD_SERVE_MAX_BATCH", 8.0, True,
                "serving micro-batch size trigger; tuned DOWN from the "
                "configured maximum only (buckets above it were never "
                "compiled) via MicroBatcher.set_tunables"),
    TunableKnob("serve_deadline_ms", 0.0, 50.0, 1.0, "setter",
                "HVD_SERVE_BATCH_DEADLINE_MS", 5.0, True,
                "serving micro-batch deadline trigger "
                "(MicroBatcher.set_tunables)"),
    TunableKnob("wire_codec", 0.0, 3.0, 1.0, "native",
                "HVD_WIRE_CODEC", 0.0, False,
                "wire codec id for fp32 ring payloads (0=none 1=bf16 "
                "2=fp16 3=int8; core/session.stage_wire_codec). NOT "
                "live-safe: lossy codecs change gradient numerics "
                "mid-run, so unsupervised search would fold codec "
                "noise into its objective — stage between training "
                "phases instead (docs/wire.md#compression)"),
    # Sharding-planner cost-model weights (parallel/costmodel.py,
    # docs/planner.md): searched OFFLINE only — plans are chosen at
    # setup time and per-rank divergence would pick divergent meshes,
    # the same trace-time hazard as grad_bucket_bytes. Autotune 2.0
    # fits them against measured step times (docs/autotune.md).
    TunableKnob("plan_ici_bw_gbps", 10.0, 1010.0, 10.0, "env",
                "HVD_PLAN_ICI_BW_GBPS", 90.0, False,
                "planner cost model: ICI bandwidth weight (GB/s); "
                "only the ICI:DCN ratio has to be right for the "
                "argmin to be right"),
    TunableKnob("plan_dcn_bw_gbps", 1.0, 101.0, 0.25, "env",
                "HVD_PLAN_DCN_BW_GBPS", 6.25, False,
                "planner cost model: DCN bandwidth weight (GB/s); "
                "lowering it pushes plans toward hierarchical "
                "factorizations that starve the slow links"),
    TunableKnob("plan_grad_overlap", 0.0, 1.0, 0.05, "env",
                "HVD_PLAN_GRAD_OVERLAP", 0.25, False,
                "planner cost model: exposed fraction of gradient-"
                "sync time (the rest overlaps backprop via bucketed "
                "issue, docs/mfu.md); 1.0 = no overlap credit"),
]}


def tunable_snap(knob: TunableKnob, value: float) -> float:
    """Clamp ``value`` into the knob's box and snap it to the step
    grid — every applied value is reproducible from (lo, step, k)."""
    value = min(max(float(value), knob.lo), knob.hi)
    if knob.step > 0:
        value = knob.lo + round((value - knob.lo) / knob.step) * knob.step
    return min(max(value, knob.lo), knob.hi)
