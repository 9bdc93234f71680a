"""What both references share: the products in each precision, the
optimizers written out by their formulas, the exchange between ranks, and
the readings a training check compares."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.distributed as dist
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to 448), and back to float32."""
    x = x.float()
    scale = E4M3_MAX / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, and back to float32."""
    return x.to(torch.bfloat16).float()


# How a precision rounds the operands of a product.
ROUND = {"fp8": fp8, "bf16": bf16}


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` with both operands, and the incoming gradient, rounded to
    ``kind``; products accumulated in float32, as a tensor-core matmul of
    that type does."""

    @staticmethod
    def forward(ctx, a, b, kind):
        r = ROUND[kind]
        qa, qb = r(a), r(b)
        ctx.save_for_backward(qa, qb)
        ctx.kind = kind
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ROUND[ctx.kind](g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        return _sum_to(ga, qa.shape), _sum_to(gb, qb.shape), None


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, kind):
        r = ROUND[kind]
        qx, qw = r(x), r(w)
        ctx.save_for_backward(qx, qw)
        ctx.stride, ctx.kind = stride, kind
        return F.conv2d(qx, qw, stride=stride)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        qg = ROUND[ctx.kind](g)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride=ctx.stride)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride=ctx.stride)
        return gx, gw, None, None


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, (a, b) in enumerate(zip(g.shape, shape)):
        if a != b:
            g = g.sum(i, keepdim=True)
    return g


class Ops:
    """The products of a reference: float32; fp8 operands for the control;
    bf16 operands as a witness that a gap between the program and the
    reference is the rounding of the cells' own bf16 (``tools/control.py``
    reads it; no benchmark run does)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32",) + tuple(ROUND):
            raise ValueError("precision must be fp32, fp8 or bf16, got %r"
                             % (precision,))
        self.precision = precision

    def mm(self, a, b):
        if self.precision in ROUND:
            return _RoundedMatmul.apply(a, b, self.precision)
        return a @ b

    def conv(self, x, w, stride):
        if self.precision in ROUND:
            return _RoundedConv.apply(x, w, stride, self.precision)
        return F.conv2d(x, w, stride=stride)


@contextlib.contextmanager
def exact() -> Iterator[None]:
    """float32 products on the card: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def sum_over_ranks(tensors, exchange: bool = True) -> None:
    """Sum each tensor over the ranks in place (``exchange=False``: this
    rank's alone, the fault of a step that skips the exchange)."""
    if exchange and world() > 1:
        for t in tensors:
            dist.all_reduce(t)


def adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          state: dict, lr: float, weight_decay: float, betas=(0.9, 0.999),
          eps: float = 1e-8) -> None:
    """One AdamW step (Loshchilov and Hutter), decoupled decay first."""
    b1, b2 = betas
    t = state["t"] = state.get("t", 0) + 1
    for n, p in params.items():
        g = grads[n]
        m = state.setdefault(("m", n), torch.zeros_like(p))
        v = state.setdefault(("v", n), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * weight_decay)
        denom = (v / (1 - b2 ** t)).sqrt_().add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def sgd(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
        state: dict, lr: float, momentum: float) -> None:
    """One step of SGD with heavy-ball momentum: b = m b + g (b = g on the
    first step), p -= lr b."""
    for n, p in params.items():
        g = grads[n]
        if ("b", n) not in state:
            state[("b", n)] = g.clone()
        else:
            state[("b", n)].mul_(momentum).add_(g)
        p.add_(state[("b", n)], alpha=-lr)


def first_moment(state: dict, name: str) -> torch.Tensor:
    """The first moment the optimizer keeps for ``name``: SGD's buffer b,
    AdamW's m."""
    return state[("b", name)] if ("b", name) in state else state[("m", name)]


def step_optimizer(opt: dict, params, grads, state) -> None:
    if opt["name"] == "adamw":
        adamw(params, grads, state, opt["lr"], opt["weight_decay"])
    elif opt["name"] == "sgd":
        sgd(params, grads, state, opt["lr"], opt["momentum"])
    else:
        raise ValueError("unknown optimizer %r" % (opt["name"],))


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                        for n in names]).tolist()
    return dict(zip(names, vals))

