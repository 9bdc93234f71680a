"""Sequence parallelism: ring attention and Ulysses attention.

Port of ``horovod_tpu/parallel/sequence.py``. Each member of the sequence
set holds a (B, S/n, H, D) shard of q, k and v, in set-rank order along
the sequence:

- ``ring_attention`` keeps its query shard while the k/v shards travel
  the ring (``mesh.ppermute``, k and v packed into one buffer so that each
  step makes one exchange), accumulating with an online softmax;
- ``ulysses_attention`` reshards sequence-sharded to head-sharded with
  one ``mesh.all_to_all`` (q, k and v packed together), runs dense
  attention over the whole sequence with H/n heads, and reshards back.

The arithmetic is the reference's: q·k in the input dtype, then fp32;
the ``-1e9`` mask on absolute positions; the running (m, l, o) and p·v in
fp32. Products are ``torch.einsum``, as they are einsums there.
"""

from __future__ import annotations

import math

import torch

from horovod_tpu_torch.parallel.mesh import all_to_all
from horovod_tpu_torch.parallel.mesh import axis_index
from horovod_tpu_torch.parallel.mesh import axis_size
from horovod_tpu_torch.parallel.mesh import ppermute

_NEG = -1e9


def _scores(q, k):
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    return scores / math.sqrt(d)


def _block_attention(q, k, v, q_offset, k_offset, causal, m, l, o):
    """One blockwise online-softmax step.

    q: (B, Sq, H, D); k, v: (B, Sk, H, D); m, l: (B, H, Sq) fp32; o like
    q in fp32. Positions are absolute: query i is ``q_offset + i``."""
    scores = _scores(q, k)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask, _NEG)
    m_new = torch.maximum(m, scores.amax(-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def ring_attention(q, k, v, *, axis=None, causal: bool = True):
    """Blockwise ring attention over the ``axis`` process set (default
    the global set).

    Args: this member's q, k, v shards, (B, S_local, H, D). Returns its
    attention output shard, (B, S_local, H, D), in q's dtype. Every
    member calls it, n steps each."""
    n = axis_size(axis)
    idx = axis_index(axis)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("ring attention needs q, k, v of one shape, got "
                         "%s, %s, %s" % (tuple(q.shape), tuple(k.shape),
                                         tuple(v.shape)))
    b, s_local, h, d = q.shape
    m = torch.full((b, h, s_local), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32,
                    device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kv = torch.stack([k, v])
    for step in range(n):
        # The kv block held at this step is member (idx - step) mod n's.
        k_offset = ((idx - step) % n) * s_local
        m, l, o = _block_attention(q, kv[0], kv[1], idx * s_local,
                                   k_offset, causal, m, l, o)
        if step != n - 1:
            kv = ppermute(kv, perm, axis)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q, k, v, *, axis=None, causal: bool = True,
                      attention_fn=None):
    """All_to_all sequence parallelism: (B, S/n, H, D) shards become
    (B, S, H/n, D), dense attention runs locally, and the result is
    resharded back. The head count must divide by the set's size."""
    n = axis_size(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            "ulysses attention requires heads (%d) divisible by the seq "
            "axis size (%d)" % (h, n))
    # (3, B, S/n, H, D) -> (3, B, S, H/n, D): one exchange for all three.
    qh, kh, vh = all_to_all(torch.stack([q, k, v]), 3, 2, axis).unbind(0)
    if attention_fn is None:
        attention_fn = _dense_attention
    ctx = attention_fn(qh, kh, vh, causal)
    return all_to_all(ctx, 1, 2, axis)


def _dense_attention(q, k, v, causal):
    scores = _scores(q, k)
    if causal:
        s = scores.shape[-1]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v.float()).to(q.dtype)
