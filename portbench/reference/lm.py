"""A GPT-2-style causal language model in plain PyTorch: learned
positions, pre-LayerNorm blocks, causal softmax attention written out,
a GELU MLP and logits tied to the embedding, as the configuration file
states it (its ``departures`` say where that differs from the published
model). The loss is the sum of next-token cross entropies; a batch runs
one sequence at a time, so that float32 activations fit beside the
optimizer's state."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import Ops


def _ln(x, scale, bias, eps):
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps=eps)


def loss_sum(W: Dict[str, torch.Tensor], config: dict, tokens, targets,
             ops: Ops) -> torch.Tensor:
    """Summed cross entropy of (B, S) ``tokens`` against ``targets``."""
    m, h = config["n_embd"], config["n_head"]
    d, eps = m // h, config["layer_norm_epsilon_run"]
    b, s = tokens.shape
    x = W["embed"][tokens] + W["pos"][:s][None]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for i in range(config["n_layer"]):
        p = "layers.%d." % i
        y = _ln(x, W[p + "ln1.scale"], W[p + "ln1.bias"], eps)
        wqkv = W[p + "attn.wqkv"].permute(1, 0, 2, 3).reshape(m, 3 * m)
        q, k, v = ops.mm(y, wqkv).view(b, s, 3, h, d).permute(
            2, 0, 3, 1, 4).unbind(0)                        # (B, H, S, D)
        scores = ops.mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
        ctx = ops.mm(probs, v).transpose(1, 2).reshape(b, s, m)
        x = x + ops.mm(ctx, W[p + "attn.wo"].reshape(m, m))
        y = _ln(x, W[p + "ln2.scale"], W[p + "ln2.bias"], eps)
        y = F.gelu(ops.mm(y, W[p + "mlp.wi"]), approximate="tanh")
        x = x + ops.mm(y, W[p + "mlp.wo"])
    x = _ln(x, W["ln_f.scale"], W["ln_f.bias"], eps)
    logits = ops.mm(x, W["embed"].t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum")


def accumulate(W, config, tokens, targets, ops: Ops) -> torch.Tensor:
    """Add the gradient of the summed loss over every sequence of the
    batch into ``W``'s ``.grad``; return the summed loss."""
    total = torch.zeros((), device=tokens.device)
    for i in range(tokens.shape[0]):
        loss = loss_sum(W, config, tokens[i:i + 1], targets[i:i + 1], ops)
        loss.backward()
        total += loss.detach()
    return total
