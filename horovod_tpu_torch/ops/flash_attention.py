"""Flash attention on Hopper: the port of ``horovod_tpu/ops/pallas_attention.py``.

The three Pallas TPU kernels become hand-written CUDA kernels in
``csrc/flash_attention.cu`` (forward, dK/dV, dQ), bound with ``ctypes``.
The library dispatches on dtype: bf16 runs on the tensor cores
(``mma.sync``), fp32 on fp32 FMA kernels (on the tensor cores fp32 would
be TF32, too coarse for the fp32 checks).
Beside each kernel's wrapper is its plain PyTorch version: masked dense
softmax attention in fp32 with the same semantics (decode-convention
causal mask, ``NEG_INF`` masking, fp32 ``lse``). A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises. Each wrapper counts its launches in ``.launches``.

The public ``flash_attention`` takes ``(B, S, H, D)`` like the reference
and runs the kernels on contiguous ``(B, H, S, D)`` panels; a
``torch.autograd.Function`` stands in for ``jax.custom_vjp``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from horovod_tpu_torch.ops import _build

NEG_INF = -1e30
# The kernels' query and key tile (rows); block_q/block_k on a CUDA tensor
# must be None or this.
TILE = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# -------------------------------------------------------- plain versions ---


def _mask(sq: int, skv: int, causal: bool, device) -> torch.Tensor:
    """(Sq, Skv) visibility: the decode convention aligns the END of q
    with the end of kv, so query row r sits at position r + Skv - Sq."""
    col = torch.arange(skv, device=device)
    if not causal:
        return torch.ones(sq, skv, dtype=torch.bool, device=device)
    row = torch.arange(sq, device=device)[:, None] + (skv - sq)
    return col[None, :] <= row


def _scores(q, k, causal, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    mask = _mask(q.shape[2], k.shape[2], causal, q.device)
    return s.masked_fill(~mask, NEG_INF), mask


def flash_fwd_plain(q, k, v, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(O, lse)`` of masked softmax attention; (B, H, S, D) in, O in
    q's dtype, lse (B, H, Sq) fp32."""
    s, _ = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _dscores(q, k, v, do, lse, delta, causal, scale):
    s, mask = _scores(q, k, causal, scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``: dV = Pᵀ·dO, dK = dSᵀ·(scale·q), dS = P∘(dO·Vᵀ − delta)."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float() * scale)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """dQ = scale · dS·K."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    return dq.to(q.dtype)


# ------------------------------------------------------ kernel wrappers ---


def _check_cuda(name, q, k, v, do=None):
    """Validate what the kernel will index through raw pointers."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError("%s: dtype %s not supported (fp32 or bf16)"
                        % (name, q.dtype))
    if q.ndim != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError("%s: q must be (B, H, S, D) with D in %s, got %s"
                         % (name, HEAD_DIMS, tuple(q.shape)))
    b, h, sq, d = q.shape
    skv = k.shape[2] if k.ndim == 4 else 0
    if (sq < 1 or skv < 1 or k.shape != (b, h, skv, d) or v.shape != k.shape
            or (do is not None and do.shape != q.shape)):
        raise ValueError("%s: shapes q %s, k %s, v %s do not match"
                         % (name, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    for t in (k, v) if do is None else (k, v, do):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("%s: tensors differ in device or dtype" % name)
    for t in (q, k, v) if do is None else (q, k, v, do):
        if not t.is_contiguous():
            raise ValueError("%s: inputs must be contiguous" % name)
        # The tensor-core kernels copy 16-byte chunks of each row.
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("%s: bf16 inputs must start on a 16-byte "
                             "boundary" % name)


def _launch(fn_name, *args):
    lib = _build.load("flash_attention")
    err = getattr(lib, fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, fn_name)


def flash_fwd(q, k, v, causal: bool, scale: float):
    """Forward kernel (replaces ``_fwd_kernel``): ``(O, lse)``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale)
    _check_cuda("flash_fwd", q, k, v)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("hvd_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, sq, skv, d,
            _DTYPE_CODES[q.dtype], int(causal), float(scale))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dK/dV kernel (replaces ``_bwd_dkv_kernel``): ``(dK, dV)``."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_bwd_dkv", q, k, v, do)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("hvd_flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, skv, d, _DTYPE_CODES[q.dtype],
            int(causal), float(scale))
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ kernel (replaces ``_bwd_dq_kernel``)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, scale)
    _check_cuda("flash_bwd_dq", q, k, v, do)
    _check_rows("flash_bwd_dq", q, lse, delta)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    dq = torch.empty_like(q)
    _launch("hvd_flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, skv, d, _DTYPE_CODES[q.dtype], int(causal),
            float(scale))
    flash_bwd_dq.launches += 1
    return dq


def _check_rows(name, q, lse, delta):
    for t in (lse, delta):
        if (t.dtype != torch.float32 or t.shape != q.shape[:3]
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("%s: lse/delta must be contiguous fp32 %s"
                             % (name, tuple(q.shape[:3])))


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


# ------------------------------------------------------------- autograd ---


class _Flash(torch.autograd.Function):
    """custom_vjp of the reference (``_flash`` / ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # Glue outside the kernels, as in the reference (_flash_bwd):
        # delta = rowsum(dO·O) in fp32, dO cast to the inputs' dtype.
        delta = (g.float() * o.float()).sum(-1)
        do = g.to(q.dtype).contiguous()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None):
    """Fused streaming-softmax attention.

    Args:
      q, k, v: (batch, seq, heads, head_dim) tensors.
      causal: apply the causal mask (decode convention for Sq != Skv).
      block_q / block_k: kept for parity with the reference's signature.
        The CUDA kernels are compiled for one 64-row tile, so on a CUDA
        tensor each must be None or 64; the CPU's plain version does not
        tile and ignores them.
      scale: score scaling; defaults to 1/sqrt(head_dim).

    Returns:
      (batch, seq, heads, head_dim) output in q's dtype.
    """
    if q.ndim != 4:
        raise ValueError("expected (B, S, H, D) inputs, got %r"
                         % (tuple(q.shape),))
    if q.device.type != "cpu":
        for name, blk in (("block_q", block_q), ("block_k", block_k)):
            if blk not in (None, TILE):
                raise ValueError(
                    "%s=%r: the CUDA kernels are compiled for %d-row "
                    "tiles" % (name, blk, TILE))
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _Flash.apply(qt, kt, vt, bool(causal), float(scale)) \
        .transpose(1, 2)
