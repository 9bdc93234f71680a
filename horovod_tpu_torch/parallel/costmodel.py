"""Sharding-planner cost model: bytes moved per fabric, memory fit.

Port of ``horovod_tpu/parallel/costmodel.py``, jax-free there and here:
pure Python over integers and floats, so the planner's whole search and
its report run without touching a card. Every candidate, cost, reason and
ranking is the reference's, line for line; only the fabric defaults
differ. The reference's names keep their meaning: "ICI" is the fast
fabric inside a node, "DCN" the slow one between nodes, "chip" one
device.

The model is first-order bandwidth accounting (the reference's
arithmetic for hierarchical allreduce, horovod/common/ops/
nccl_operations.cc:233-440: move 1/ici of the bytes over the slow links):

- every parallel axis contributes the bytes its collectives move per
  training step (ring-allreduce convention ``2(n-1)/n * payload``,
  all_to_all ``(n-1)/n * payload``, ring-attention ``(n-1) *
  shard``), attributed to the fabric the axis rides (ICI for the
  inner axes, DCN for the cross-node leg of a hierarchical data axis);
- step comm time = ici_bytes / ici_bw + dcn_bytes / dcn_bw — the
  weights are the ``HVD_PLAN_ICI_BW_GBPS`` / ``HVD_PLAN_DCN_BW_GBPS``
  knobs;
- a candidate whose per-device memory (params + grads + optimizer state
  + activations) exceeds ``HVD_PLAN_MEM_PER_CHIP_GB`` is scored but
  marked infeasible with the overflow recorded.

Ties break deterministically: prefer more data parallelism, then
smaller model/seq/expert/pipe in that order, so two hosts planning the
same workload always agree.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

from horovod_tpu_torch.common.util import float_env

# Axis names mirrored from parallel.mesh / parallel.hierarchical
# (string literals here keep this module import-light and jax-free).
DATA = "data"
MODEL = "model"
SEQ = "seq"
EXPERT = "expert"
PIPE = "pipe"
DATA_DCN = "data_dcn"
DATA_ICI = "data_ici"

# Default fabric weights: the NVIDIA H100 SXM's data-sheet figures, not
# measurements. ICI stands for NVLink 4 inside a node, 450 GB/s per
# direction per GPU (900 GB/s total); DCN for InfiniBand NDR between
# nodes, one 400 Gb/s adapter per GPU, 50 GB/s; and 80 GB of HBM3 per
# device. They only need to be *relatively* right for the argmin to be
# right; tune with the knobs below.
DEFAULT_ICI_BW_GBPS = 450.0
DEFAULT_DCN_BW_GBPS = 50.0
DEFAULT_MEM_PER_CHIP_GB = 80.0

# Params carry gradients plus two Adam-style optimizer slots.
PARAM_STATE_MULT = 4.0
# Transformer activation footprint per token-dim element across a
# layer's intermediates (post-attn, MLP hidden, norms), without remat.
ACT_MULT = 8.0
# Fraction of gradient-sync time exposed on the critical path: the
# bucketed reverse-order issue (docs/mfu.md) overlaps most of the
# allreduce with the remaining backprop, which is exactly why data
# parallelism beats same-byte-count blocking alternatives. Tunable via
# HVD_PLAN_GRAD_OVERLAP (Autotune 2.0 schema entry).
DEFAULT_GRAD_OVERLAP = 0.25
# Per-collective launch latency for BLOCKING collectives (tensor/
# sequence/expert/pipeline exchanges sit on the critical path once per
# layer; gradient buckets are latency-hidden and charged above). All
# blocking collectives here are intra-slice: the data axis absorbs the
# whole DCN factor, so only the hierarchical grad leg crosses slices.
LAT_ICI_SEC = 2e-6


def ici_bw_gbps() -> float:
    """Resolved ``HVD_PLAN_ICI_BW_GBPS`` cost-model weight."""
    return float_env("HVD_PLAN_ICI_BW_GBPS", DEFAULT_ICI_BW_GBPS)


def dcn_bw_gbps() -> float:
    """Resolved ``HVD_PLAN_DCN_BW_GBPS`` cost-model weight."""
    return float_env("HVD_PLAN_DCN_BW_GBPS", DEFAULT_DCN_BW_GBPS)


def mem_per_chip_gb() -> float:
    """Resolved ``HVD_PLAN_MEM_PER_CHIP_GB`` memory-fit bound."""
    return float_env("HVD_PLAN_MEM_PER_CHIP_GB", DEFAULT_MEM_PER_CHIP_GB)


def grad_overlap() -> float:
    """Resolved ``HVD_PLAN_GRAD_OVERLAP`` exposed-fraction weight,
    clamped to [0, 1]."""
    return min(max(float_env("HVD_PLAN_GRAD_OVERLAP",
                             DEFAULT_GRAD_OVERLAP), 0.0), 1.0)


# On-wire bytes per raw fp32 payload byte under each wire codec
# (docs/wire.md#compression): bf16/fp16 halve every block; int8 ships
# 1 byte/elem plus a 4-byte scale per ring block, ~0.26x in practice.
_CODEC_RATIO = {0: 1.0, 1: 0.5, 2: 0.5, 3: 0.26}


def wire_codec_ratio() -> float:
    """Gradient-sync bytes-per-step discount for the configured
    ``HVD_WIRE_CODEC`` (the same knob the native core stages at init,
    core/src/controller.cc — no second spelling to keep in sync).
    Unknown or unset values price as uncompressed."""
    from horovod_tpu_torch.compression import codec_id

    cid = codec_id(os.environ.get("HVD_WIRE_CODEC"))
    return _CODEC_RATIO.get(cid if cid is not None else 0, 1.0)


class Workload(NamedTuple):
    """Model/workload description the planner scores layouts against.

    ``param_bytes`` covers the whole model; ``expert_param_bytes`` is
    the subset living on MoE expert weights (sharded over the
    ``expert`` axis instead of replicated across data ranks, so it
    cuts both memory and gradient-sync traffic when e > 1).
    """

    param_bytes: int
    batch: int                  # global batch (rows entering the step)
    seq_len: int = 1
    d_model: int = 1
    n_layers: int = 1
    dtype_bytes: int = 4
    num_experts: int = 0
    expert_param_bytes: int = 0
    pipeline_stages: int = 0


class Topology(NamedTuple):
    """Device topology: chip count factored into ICI x DCN.

    ``chips == ici * dcn``; ``dcn > 1`` describes a multi-slice pod
    whose data axis must span the slice boundary (the planner then
    emits the ``data_dcn`` x ``data_ici`` factorization and the
    hierarchical gradient-sync strategy)."""

    chips: int
    ici: int
    dcn: int = 1
    ici_bw_gbps: float = DEFAULT_ICI_BW_GBPS
    dcn_bw_gbps: float = DEFAULT_DCN_BW_GBPS
    mem_per_chip_gb: float = DEFAULT_MEM_PER_CHIP_GB

    @classmethod
    def make(cls, chips: int, *, dcn: int = 1,
             ici_bw: Optional[float] = None,
             dcn_bw: Optional[float] = None,
             mem_gb: Optional[float] = None) -> "Topology":
        """Topology with env-knob-resolved fabric weights."""
        if chips < 1 or dcn < 1 or chips % dcn:
            raise ValueError(
                "chips (%d) must be a positive multiple of dcn (%d)"
                % (chips, dcn))
        return cls(
            chips=chips, ici=chips // dcn, dcn=dcn,
            ici_bw_gbps=ici_bw if ici_bw is not None else ici_bw_gbps(),
            dcn_bw_gbps=dcn_bw if dcn_bw is not None else dcn_bw_gbps(),
            mem_per_chip_gb=mem_gb if mem_gb is not None
            else mem_per_chip_gb())


class Cost(NamedTuple):
    """Scored cost of one candidate layout."""

    ici_bytes: float        # bytes/step over the fast fabric
    dcn_bytes: float        # bytes/step over the slow fabric
    seconds: float          # ici_bytes/ici_bw + dcn_bytes/dcn_bw
    mem_bytes: float        # per-chip memory footprint
    terms: Tuple[Tuple[str, float], ...]  # (axis rationale, bytes)


class Candidate(NamedTuple):
    """One legal factorization, scored; ``reason`` is empty for the
    chosen candidate and names why every other one lost."""

    axes: Dict[str, int]    # logical sizes: data/model/seq/expert/pipe
    cost: Cost
    feasible: bool
    reason: str = ""


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_candidates(workload: Workload,
                         topology: Topology,
                         require_axes: Optional[Dict[str, int]] = None,
                         ) -> List[Candidate]:
    """All LEGAL factorizations of the chip count, scored.

    Legality is divisibility: ``data`` divides the batch (and spans
    the whole DCN factor on multi-slice topologies, so the slow links
    only ever carry the hierarchical data leg), ``model`` divides
    d_model, ``seq`` divides seq_len, ``expert`` divides the expert
    count, ``pipe`` divides the stage count. ``require_axes`` pins
    axes to exact sizes (a caller preserving a known composition);
    unnamed axes stay free.

    Memory-infeasible candidates are returned scored with
    ``feasible=False`` so the report can show them; pick with
    :func:`choose`.
    """
    require = dict(require_axes or {})
    unknown = set(require) - {DATA, MODEL, SEQ, EXPERT, PIPE}
    if unknown:
        raise ValueError("require_axes names unknown axes %r" % sorted(unknown))
    chips = topology.chips
    out: List[Candidate] = []
    for d in _divisors(chips):
        if workload.batch % d:
            continue
        # Multi-slice topologies: the data axis must absorb the whole
        # DCN factor, so only the hierarchical data leg ever rides the
        # slow links (every other axis stays intra-slice).
        if topology.dcn > 1 and d % topology.dcn:
            continue
        if require.get(DATA, d) != d:
            continue
        for m in _divisors(chips // d):
            if m > 1 and workload.d_model % m:
                continue
            if require.get(MODEL, m) != m:
                continue
            for s in _divisors(chips // (d * m)):
                if s > 1 and workload.seq_len % s:
                    continue
                if require.get(SEQ, s) != s:
                    continue
                for e in _divisors(chips // (d * m * s)):
                    if e > 1 and (not workload.num_experts
                                  or workload.num_experts % e):
                        continue
                    if require.get(EXPERT, e) != e:
                        continue
                    p = chips // (d * m * s * e)
                    if p > 1 and (not workload.pipeline_stages
                                  or workload.pipeline_stages % p):
                        continue
                    if require.get(PIPE, p) != p:
                        continue
                    axes = {DATA: d, MODEL: m, SEQ: s, EXPERT: e, PIPE: p}
                    out.append(Candidate(
                        axes, score(axes, workload, topology),
                        feasible=True))
    # Stamp memory feasibility after scoring.
    cap = topology.mem_per_chip_gb * 1e9
    out = [
        c if c.cost.mem_bytes <= cap else c._replace(
            feasible=False,
            reason="memory %.2f GB > %.2f GB/chip"
                   % (c.cost.mem_bytes / 1e9, topology.mem_per_chip_gb))
        for c in out
    ]
    return out


def score(axes: Dict[str, int], workload: Workload,
          topology: Topology) -> Cost:
    """Bytes-moved + memory model for one candidate layout."""
    d = axes.get(DATA, 1)
    m = axes.get(MODEL, 1)
    s = axes.get(SEQ, 1)
    e = axes.get(EXPERT, 1)
    p = axes.get(PIPE, 1)
    w = workload

    dense_bytes = max(w.param_bytes - w.expert_param_bytes, 0)
    # Per-chip parameter shard: tensor + pipeline parallelism split the
    # dense weights, expert parallelism additionally splits the expert
    # weights.
    per_chip_param = dense_bytes / (m * p) + \
        w.expert_param_bytes / (m * p * max(e, 1))
    # Per-chip activation tile entering each layer.
    act = (w.batch / d) * (w.seq_len / s) * w.d_model * w.dtype_bytes

    terms: List[Tuple[str, float]] = []
    ici = 0.0           # blocking (critical-path) bytes over ICI
    dcn = 0.0
    grad_ici = 0.0      # latency-hidden gradient-sync bytes
    grad_dcn = 0.0
    blocking = 0        # blocking collective launches per step

    # -- gradient sync: every TOKEN-sharding axis participates --------
    # data and seq both shard the token stream, so each chip computes
    # PARTIAL gradients for the parameters it holds and the sync group
    # is their product — sequence parallelism never dodges the
    # gradient allreduce, it only re-shapes it. Expert weights are
    # owned e ways (their replicas are the d x s grid), which is what
    # makes expert parallelism pay: 1/e of the expert bytes per chip,
    # in memory AND on the wire.
    n_tok = d * s
    # Wire-codec discount (docs/wire.md#compression): the native ring
    # compresses fp32 gradient payloads on the wire, so the sync terms
    # price encoded bytes. Memory terms stay raw — only the wire
    # shrinks. Non-fp32 workloads ship uncompressed under every codec.
    codec_ratio = wire_codec_ratio() if w.dtype_bytes == 4 else 1.0
    dense_shard = dense_bytes / (m * p) * codec_ratio
    expert_shard = w.expert_param_bytes / (m * p * max(e, 1)) * codec_ratio
    g_payload = 0.0
    if n_tok > 1:
        g_payload += 2.0 * (n_tok - 1) / n_tok * \
            (dense_shard + expert_shard)
    if g_payload > 0:
        if codec_ratio < 1.0:
            terms.append((
                "wire codec %s: grad-sync bytes priced at %.2fx raw"
                % (os.environ.get("HVD_WIRE_CODEC"), codec_ratio), 0.0))
        if topology.dcn > 1 and s == 1:
            # Hierarchical ladder (parallel/hierarchical.py):
            # reduce_scatter(ici) + all_gather(ici) move ~2(i-1)/i of
            # the payload over ICI; the cross-slice psum moves the
            # 1/i-scattered shard over DCN. Only available when data
            # is the sole token axis — the ladder handles exactly a
            # (dcn, ici) pair, and planner._plan_from_candidate
            # mirrors this condition in its sync choice.
            n_ici = max(n_tok // topology.dcn, 1)
            frac_ici = (2.0 * (n_ici - 1) / n_ici) / \
                (2.0 * (n_tok - 1) / n_tok) if n_tok > 1 else 0.0
            g_ici = g_payload * frac_ici
            g_dcn = 2.0 * (topology.dcn - 1) / topology.dcn * \
                (dense_shard + expert_shard) / n_ici
            grad_ici += g_ici
            grad_dcn += g_dcn
            terms.append((
                "grad sync over data=%d (x seq=%d x expert=%d), "
                "hierarchical %d dcn x %d ici: %.2f MB ici + %.2f MB dcn"
                % (d, s, e, topology.dcn, n_ici, g_ici / 1e6,
                   g_dcn / 1e6), g_ici + g_dcn))
        elif topology.dcn > 1:
            # seq alongside a multi-slice data axis: the runtime falls
            # back to ONE flat psum over (dcn, ici, seq) — the full
            # ring payload crosses the slice boundary with no 1/ici
            # scatter discount. Charged as such, so the argmin never
            # picks a seq-bearing multi-slice layout off a
            # hierarchical estimate it will not get.
            g_dcn = min(2.0 * (topology.dcn - 1) / topology.dcn *
                        (dense_shard + expert_shard), g_payload)
            g_ici = g_payload - g_dcn
            grad_ici += g_ici
            grad_dcn += g_dcn
            terms.append((
                "grad sync over data=%d x seq=%d x expert=%d, FLAT "
                "across %d slices (no ladder with a seq axis): "
                "%.2f MB ici + %.2f MB dcn"
                % (d, s, e, topology.dcn, g_ici / 1e6, g_dcn / 1e6),
                g_ici + g_dcn))
        else:
            grad_ici += g_payload
            terms.append((
                "grad sync over data=%d x seq=%d x expert=%d "
                "(%d-way ring, %.2f MB param shard/chip) = %.2f MB, "
                "%.0f%% hidden under backprop"
                % (d, s, e, n_tok, (dense_shard + expert_shard) / 1e6,
                   g_payload / 1e6, (1 - grad_overlap()) * 100),
                g_payload))

    # -- model axis: activation allreduce per layer, fwd + bwd --------
    if m > 1:
        t = 4.0 * w.n_layers * act * 2.0 * (m - 1) / m
        ici += t
        blocking += 4 * w.n_layers
        terms.append((
            "model=%d: per-layer activation allreduce (fwd+bwd, "
            "blocking) = %.2f MB" % (m, t / 1e6), t))

    # -- seq axis: ring-attention K/V rotation, fwd + bwd -------------
    if s > 1:
        t = 4.0 * w.n_layers * (s - 1) * act
        ici += t
        blocking += 2 * w.n_layers * (s - 1)
        terms.append((
            "seq=%d: ring-attention K/V rotation (s-1 hops, fwd+bwd) "
            "= %.2f MB" % (s, t / 1e6), t))

    # -- expert axis: dispatch + return all_to_all, fwd + bwd ---------
    if e > 1:
        t = 4.0 * w.n_layers * act * (e - 1) / e
        ici += t
        blocking += 4 * w.n_layers
        terms.append((
            "expert=%d: MoE dispatch/return all_to_all (fwd+bwd) "
            "= %.2f MB" % (e, t / 1e6), t))

    # -- pipe axis: activation handoff between stages, fwd + bwd ------
    if p > 1:
        t = 4.0 * act
        ici += t
        blocking += 2 * (p - 1)
        terms.append((
            "pipe=%d: stage-boundary activation ppermute (fwd+bwd) "
            "= %.2f MB" % (p, t / 1e6), t))

    mem = per_chip_param * PARAM_STATE_MULT + \
        (w.n_layers / p) * act * ACT_MULT
    # Exposed time: blocking collectives pay full bandwidth + launch
    # latency; gradient buckets pay only their exposed fraction (they
    # overlap backprop — docs/mfu.md — which is the reason data
    # parallelism beats same-byte blocking layouts).
    overlap = grad_overlap()
    seconds = (ici + overlap * grad_ici) / (topology.ici_bw_gbps * 1e9) \
        + (dcn + overlap * grad_dcn) / (topology.dcn_bw_gbps * 1e9) \
        + blocking * LAT_ICI_SEC
    return Cost(ici + grad_ici, dcn + grad_dcn, seconds, mem,
                tuple(terms))


def sort_key(c: Candidate):
    """Deterministic candidate ordering: cheapest comm first; ties
    prefer more data parallelism, then the least exotic layout (small
    model, then seq, then expert, then pipe)."""
    a = c.axes
    return (c.cost.seconds, -a[DATA], a[MODEL], a[SEQ], a[EXPERT], a[PIPE])


class PlanError(ValueError):
    """No legal+feasible layout exists for the workload/topology."""


def choose(candidates: List[Candidate]) -> Tuple[Candidate, List[Candidate]]:
    """(winner, losers-with-reasons), both in deterministic rank order.

    Losers carry a reason relative to the winner (cost ratio, or the
    memory overflow stamped by :func:`enumerate_candidates`).
    """
    if not candidates:
        raise PlanError("no legal factorization: check batch/d_model/"
                        "seq_len divisibility against the chip count")
    ranked = sorted(candidates, key=sort_key)
    feasible = [c for c in ranked if c.feasible]
    if not feasible:
        raise PlanError(
            "every legal layout exceeds the per-chip memory bound: %s"
            % "; ".join("%r %s" % (_compact(c.axes), c.reason)
                        for c in ranked[:4]))
    winner = feasible[0]
    losers = []
    for c in ranked:
        if c is winner:
            continue
        if not c.feasible:
            losers.append(c)
        elif winner.cost.seconds > 0:
            losers.append(c._replace(
                reason="%.2fx chosen step-comm"
                       % (c.cost.seconds / winner.cost.seconds)))
        else:
            losers.append(c._replace(reason="tie-break: less data "
                                            "parallelism / more exotic"))
    return winner, losers


def _compact(axes: Dict[str, int]) -> str:
    used = ["%s%d" % (k, v) for k, v in axes.items() if v > 1]
    return " ".join(used) if used else "single-chip"
