"""Decoder-only transformer: the port of ``horovod_tpu/models/transformer.py``.

Parameters have the flax model's names and shapes (``wqkv`` is
``(3, M, H, D)``, attention ``wo`` is ``(H, D, M)``), are held in fp32 and
cast to ``cfg.dtype`` for compute, as the flax model does, so
``models.convert.from_jax_params`` is a renaming. The parity details of
the reference are kept: flax's LayerNorm (eps 1e-6, statistics in fp32),
tanh-approximated GELU, the dense path's ``-1e9`` causal mask, an
embedding gather, and logits tied to the embedding and returned in fp32.

``attention`` is ``"dense"`` or ``"flash"`` (the hand-written CUDA kernels
of ``ops/flash_attention.py``). Ring and Ulysses attention and MoE layers
are not ported yet (ROADMAP, Queue A item 10).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    # 'dense' | 'flash' (ops/flash_attention.py).
    attention: str = "dense"
    num_experts: int = 0


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.attention in ("ring", "ulysses"):
        raise NotImplementedError(
            "attention=%r is not ported yet (ROADMAP, Queue A item 10)"
            % cfg.attention)
    if cfg.attention not in ("dense", "flash"):
        raise ValueError("Unknown attention impl %r" % (cfg.attention,))
    if cfg.num_experts > 0:
        raise NotImplementedError(
            "MoE layers are not ported yet (ROADMAP, Queue A item 10)")
    if cfg.d_model % cfg.n_heads:
        raise ValueError("d_model %d is not a multiple of n_heads %d"
                         % (cfg.d_model, cfg.n_heads))


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
    """flax ``nn.LayerNorm(dtype=cfg.dtype)``: fp32 statistics, eps 1e-6."""

    def __init__(self, d_model: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d_model, device=device))
        self.bias = nn.Parameter(torch.zeros(d_model, device=device))

    def forward(self, x):
        y = F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias,
                         eps=1e-6)
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
        self.mlp = Mlp(cfg, generator, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


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
        if s > cfg.max_seq_len:
            raise ValueError("sequence %d exceeds max_seq_len %d"
                             % (s, cfg.max_seq_len))
        x = self.embed.to(cfg.dtype)[tokens]
        x = x + self.pos.to(cfg.dtype)[:s][None]
        for block in self.layers:
            x = block(x)
        x = self.ln_f(x)
        return (x @ self.embed.to(cfg.dtype).t()).float()


def lm_loss(logits, tokens):
    """The bench loss: next-token cross entropy against
    ``roll(tokens, -1)``, wrap-around last position included."""
    targets = torch.roll(tokens, -1, dims=1)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))
