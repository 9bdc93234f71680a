"""Mixture-of-Experts: top-1 capacity routing, and expert parallelism.

Port of ``horovod_tpu/parallel/moe.py``:

- ``top1_dispatch``: Switch-style routing tensors, dispatch (T, E, C)
  one-hot and combine gate-weighted, with the overflow of an expert's
  capacity dropped;
- ``moe_ffn``: the single-device layer, every expert computed here;
- ``expert_parallel_moe``: expert weights sharded E/n per member of the
  expert set, tokens exchanged with two ``mesh.all_to_all``s (dispatch
  and return);
- ``MoeMlp``: the transformer's MoE block. It computes every expert
  locally, as ``moe_ffn`` does. In the JAX package its expert weights
  carry ``expert``-axis annotations that pjit shards; the port shards
  them when it has a mesh (ROADMAP, Queue A item 11).

Products are ``torch.einsum``, as they are einsums in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.parallel.mesh import all_to_all
from horovod_tpu_torch.parallel.mesh import axis_size


def _route(router_logits, capacity: int):
    """Top-1 routing of (T, E) logits: each token's expert, its slot in
    that expert's queue (clipped to the capacity), whether it fits, and
    its gate. The softmax runs in fp32, as in the reference, whatever the
    logits' dtype."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert = probs.argmax(-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = probs.new_zeros(t, e).scatter_(1, expert[:, None], 1.0)
    # Position of each token within its expert's queue: a running count
    # down the tokens, taken along the inner dim (a scan down 4 long
    # columns is slow on the card). Counts are exact in fp32.
    pos = ((onehot.t().cumsum(1).t() - 1.0) * onehot).sum(-1)
    keep = (pos < capacity).float()
    slot = pos.clamp(0, capacity - 1).long()
    return expert, slot, keep, gate


def _scatter(t, e, capacity, expert, slot, values):
    """(T, E, C) zeros with ``values[i]`` at (i, expert[i], slot[i]): one
    entry a token, so no two writes meet. In place on the new zeros: the
    out-of-place form would copy them first."""
    out = values.new_zeros(t, e, capacity)
    return out.index_put_((torch.arange(t, device=values.device), expert,
                           slot), values)


def _dispatch_combine(router_logits, capacity: int, dtype):
    """``top1_dispatch``'s tensors, built in ``dtype``: the reference
    casts its fp32 tensors to the compute dtype, and since a token has
    one slot, whose dispatch is 0 or 1, writing ``keep`` and ``keep *
    gate`` cast to ``dtype`` gives the same values, and the gate the same
    gradient, without the fp32 (T, E, C) tensors."""
    t, e = router_logits.shape
    expert, slot, keep, gate = _route(router_logits, capacity)
    return (_scatter(t, e, capacity, expert, slot, keep.to(dtype)),
            _scatter(t, e, capacity, expert, slot, (keep * gate).to(dtype)))


def top1_dispatch(router_logits, capacity: int):
    """Switch-style top-1 routing tensors from (T, E) logits.

    Returns ``(dispatch, combine)``, fp32 (T, E, C): ``dispatch[t, e, c]``
    is 1 when token t takes slot c of expert e, ``combine`` is dispatch
    times the token's gate. The softmax runs in fp32, as in the
    reference, whatever the logits' dtype; a token past its expert's
    capacity is dropped."""
    return _dispatch_combine(router_logits, capacity, torch.float32)


def _experts(expert_in, wi, wo, dtype):
    h = F.gelu(torch.einsum("ecm,emf->ecf", expert_in, wi.to(dtype)),
               approximate="tanh")
    return torch.einsum("ecf,efm->ecm", h, wo.to(dtype))


def moe_ffn(x, router_w, wi, wo, capacity: int, dtype=torch.float32):
    """Dense (single-device) MoE forward, the numerical reference.

    x: (T, M); router_w: (M, E); wi: (E, M, F); wo: (E, F, M). The router
    logits are computed in ``dtype``."""
    logits = x @ router_w.to(dtype)
    dispatch, combine = _dispatch_combine(logits, capacity, dtype)
    expert_in = torch.einsum("tec,tm->ecm", dispatch, x)
    expert_out = _experts(expert_in, wi, wo, dtype)
    return torch.einsum("tec,ecm->tm", combine, expert_out)


def expert_parallel_moe(x, router_w, wi_local, wo_local, capacity: int,
                        *, axis=None, dtype=torch.float32):
    """Expert-parallel MoE forward over the ``axis`` process set (default
    the global set).

    This member's x (T_local, M) token shard and wi_local / wo_local
    (E/n, ...) expert shards, member j holding experts [j E/n, (j+1)
    E/n); router_w (M, E) replicated. Tokens route to all E experts; the
    dispatch exchange sends each member's per-expert queues to the
    experts' owner, the return exchange brings the results back."""
    n = axis_size(axis)
    e = router_w.shape[1]
    if e % n:
        raise ValueError("num experts (%d) must divide expert axis (%d)"
                         % (e, n))
    if wi_local.shape[0] != e // n or wo_local.shape[0] != e // n:
        raise ValueError("expert shards hold %d and %d experts, want "
                         "E/n = %d" % (wi_local.shape[0], wo_local.shape[0],
                                       e // n))
    logits = x @ router_w.to(dtype)
    dispatch, combine = _dispatch_combine(logits, capacity, dtype)
    expert_in = torch.einsum("tec,tm->ecm", dispatch, x)
    # (E, C, M) -> (E/n, C n, M): every member's queues for local experts.
    expert_in = all_to_all(expert_in, 0, 1, axis)
    expert_out = _experts(expert_in, wi_local, wo_local, dtype)
    # (E/n, C n, M) -> (E, C, M): this member's own queues, back.
    expert_out = all_to_all(expert_out, 1, 0, axis)
    return torch.einsum("tec,ecm->tm", combine, expert_out)


class MoeMlp(nn.Module):
    """The transformer's MoE MLP: top-1 capacity routing over
    ``cfg.num_experts`` experts, capacity ``max(1, 2 T // E)`` for the
    block's T = B S tokens. Parameters ``router`` (M, E), ``wi`` (E, M,
    F) and ``wo`` (E, F, M), fp32, drawn from N(0, 0.02)."""

    def __init__(self, cfg, generator=None, device="cuda"):
        super().__init__()
        self.cfg = cfg
        e, m, f = cfg.num_experts, cfg.d_model, cfg.d_ff

        def normal(*shape):
            return nn.Parameter(0.02 * torch.randn(
                shape, generator=generator, device=device,
                dtype=torch.float32))

        self.router = normal(m, e)
        self.wi = normal(e, m, f)
        self.wo = normal(e, f, m)

    def forward(self, x):
        b, s, m = x.shape
        t = b * s
        capacity = max(1, int(2 * t // self.cfg.num_experts))
        out = moe_ffn(x.reshape(t, m), self.router, self.wi, self.wo,
                      capacity, dtype=self.cfg.dtype)
        return out.reshape(b, s, m)
