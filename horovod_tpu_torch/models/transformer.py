"""Decoder-only transformer: the port of ``horovod_tpu/models/transformer.py``.

Parameters have the flax model's names and shapes (``wqkv`` is
``(3, M, H, D)``, attention ``wo`` is ``(H, D, M)``), are held in fp32 and
cast to ``cfg.dtype`` for compute, as the flax model does, so
``models.convert.from_jax_params`` is a renaming. The parity details of
the reference are kept: flax's LayerNorm (eps 1e-6, statistics in fp32),
tanh-approximated GELU, the dense path's ``-1e9`` causal mask, an
embedding gather, and logits tied to the embedding and returned in fp32.

``attention`` is ``"dense"``, ``"flash"`` (the hand-written CUDA kernels
of ``ops/flash_attention.py``), ``"ring"`` or ``"ulysses"`` (sequence
parallelism over ``cfg.seq_axis``, ``parallel/sequence.py``). Under ring
or Ulysses attention, or a ``seq_axis``, each member of the sequence set
holds a slice of the sequence: its positions start at its set rank times
the slice's length (``shard_sequence`` cuts tokens and targets so).
``num_experts > 0`` puts ``parallel/moe.py``'s ``MoeMlp`` in place of
each block's MLP; ``remat`` recomputes each block's forward in the
backward pass (``torch.utils.checkpoint``), as ``nn.remat`` does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.mesh import axis_index
from horovod_tpu_torch.parallel.mesh import axis_size
from horovod_tpu_torch.parallel.moe import MoeMlp
from horovod_tpu_torch.parallel.sequence import ring_attention
from horovod_tpu_torch.parallel.sequence import ulysses_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # 'dense' | 'flash' (ops/flash_attention.py) | 'ring' | 'ulysses'
    # (parallel/sequence.py, over seq_axis).
    attention: str = "dense"
    # The sequence process set (None: the global set under ring or
    # Ulysses attention, else no sequence sharding).
    seq_axis: Optional[object] = None
    # MoE: 0 = dense MLP; >0 = top-1 routed experts (parallel/moe.py).
    num_experts: int = 0
    # As in the reference, no layer reads it: experts are computed
    # locally until the port has a mesh (ROADMAP, Queue A item 11).
    expert_axis: Optional[object] = None
    remat: bool = False
    # Accepted for the reference's configs; the lookup's values are the
    # same either way, so the port always gathers.
    vocab_onehot_lookup: Optional[bool] = None


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.attention not in ("dense", "flash", "ring", "ulysses"):
        raise ValueError("Unknown attention impl %r" % (cfg.attention,))
    if cfg.num_experts < 0:
        raise ValueError("num_experts %d is negative" % cfg.num_experts)
    if cfg.d_model % cfg.n_heads:
        raise ValueError("d_model %d is not a multiple of n_heads %d"
                         % (cfg.d_model, cfg.n_heads))


def _sharded(cfg: TransformerConfig) -> bool:
    return cfg.seq_axis is not None or cfg.attention in ("ring", "ulysses")


def _normal(shape, generator, device):
    return nn.Parameter(0.02 * torch.randn(
        shape, generator=generator, device=device, dtype=torch.float32))


def dense_causal_attention(q, k, v, dtype):
    """The reference's ``_dense_causal_attention`` on (B, S, H, D)."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        math.sqrt(d), dtype=q.dtype, device=q.device)
    s = scores.shape[-1]
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=cfg.dtype)``: statistics in fp32 (fp64 for
    an fp64 model), eps 1e-6."""

    def __init__(self, d_model: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d_model, device=device))
        self.bias = nn.Parameter(torch.zeros(d_model, device=device))

    def forward(self, x):
        wide = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(wide), x.shape[-1:], self.scale.to(wide),
                         self.bias.to(wide), eps=1e-6)
        return y.to(self.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.n_heads, cfg.d_model // cfg.n_heads
        self.wqkv = _normal((3, cfg.d_model, h, d), generator, device)
        self.wo = _normal((h, d, cfg.d_model), generator, device)

    def forward(self, x):
        cfg = self.cfg
        b, s, m = x.shape
        _, _, h, d = self.wqkv.shape
        w = self.wqkv.to(cfg.dtype).permute(1, 0, 2, 3).reshape(m, 3 * h * d)
        q, k, v = (x @ w).view(b, s, 3, h, d).unbind(2)
        if cfg.attention == "flash":
            ctx = flash_attention(q, k, v, causal=True).to(cfg.dtype)
        elif cfg.attention == "ring":
            ctx = ring_attention(q, k, v, axis=cfg.seq_axis, causal=True)
        elif cfg.attention == "ulysses":
            ctx = ulysses_attention(q, k, v, axis=cfg.seq_axis, causal=True)
        else:
            ctx = dense_causal_attention(q, k, v, cfg.dtype)
        return ctx.reshape(b, s, h * d) @ self.wo.to(cfg.dtype).reshape(
            h * d, m)


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        self.wi = _normal((cfg.d_model, cfg.d_ff), generator, device)
        self.wo = _normal((cfg.d_ff, cfg.d_model), generator, device)

    def forward(self, x):
        y = x @ self.wi.to(self.cfg.dtype)
        y = F.gelu(y, approximate="tanh")
        return y @ self.wo.to(self.cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator, device):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.attn = SelfAttention(cfg, generator, device)
        self.ln2 = LayerNorm(cfg.d_model, cfg.dtype, device)
        if cfg.num_experts > 0:
            self.moe = MoeMlp(cfg, generator, device)
        else:
            self.mlp = Mlp(cfg, generator, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        return x + mlp(self.ln2(x))


class Transformer(nn.Module):
    """Causal LM: tokens (B, S) int64 -> logits (B, S, V) fp32.

    Weights are drawn from N(0, 0.02) with ``generator`` (LayerNorm scale
    1, bias 0), on ``device``, which defaults to the card.
    """

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_config(cfg)
        self.cfg = cfg
        self.embed = _normal((cfg.vocab_size, cfg.d_model), generator, device)
        self.pos = _normal((cfg.max_seq_len, cfg.d_model), generator, device)
        self.layers = nn.ModuleList(
            Block(cfg, generator, device) for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype, device)

    def forward(self, tokens):
        cfg = self.cfg
        s = tokens.shape[1]
        n, offset = 1, 0
        if _sharded(cfg):
            n = axis_size(cfg.seq_axis)
            offset = axis_index(cfg.seq_axis) * s
        if n * s > cfg.max_seq_len:
            raise ValueError("sequence %d (%d x %d) exceeds max_seq_len %d"
                             % (n * s, n, s, cfg.max_seq_len))
        x = self.embed.to(cfg.dtype)[tokens]
        x = x + self.pos.to(cfg.dtype)[offset:offset + s][None]
        for block in self.layers:
            if cfg.remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(block, x,
                                                      use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        return (x @ self.embed.to(cfg.dtype).t()).float()


def lm_loss(logits, tokens, targets=None):
    """The bench loss: next-token cross entropy against
    ``roll(tokens, -1)``, wrap-around last position included. A
    sequence-sharded step passes the ``targets`` of ``shard_sequence``:
    rolled over the whole sequence, not over the slice."""
    if targets is None:
        targets = torch.roll(tokens, -1, dims=1)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def shard_sequence(tokens, process_set=None):
    """This member's slice of ``tokens`` (B, S) along the sequence, and
    the slice of their next-token targets: member r of n holds positions
    [r S/n, (r+1) S/n). The sequence must divide by n, so that the mean
    of the members' losses, and of their gradients, is the whole
    sequence's."""
    n, r = axis_size(process_set), axis_index(process_set)
    s = tokens.shape[1]
    if s % n:
        raise ValueError("sequence %d is not divisible by the sequence "
                         "set's size %d" % (s, n))
    part = slice(r * (s // n), (r + 1) * (s // n))
    return tokens[:, part], torch.roll(tokens, -1, dims=1)[:, part]
