"""Flash attention on Hopper: the port of ``horovod_tpu/ops/pallas_attention.py``.

The three Pallas TPU kernels become hand-written CUDA kernels, bound with
``ctypes``, in two libraries chosen by head dim:

- ``csrc/flash_attention.cu`` at the head dims in ``HEAD_DIMS``. bf16 and
  fp16 run the forward on Hopper's ``wgmma`` with TMA loads and warp
  specialisation, on the fixed tiles of ``FWD_TILES``, and the backward on
  the tensor cores through ``mma.sync``; fp32 runs fp32 FMA kernels (on
  the tensor cores fp32 would be TF32, too coarse for the fp32 checks).
- ``csrc/flash_attention_wide.cu`` above the largest of them, at head dims
  that are multiples of ``WIDE_STEP``. The bf16 and fp16 forward runs
  Hopper kernels on the fixed tiles of ``WIDE_FWD_TILES`` (head dims 192
  to 576), each computing the scores once per query and key tile: at 192
  and 256 the forward of the compiled head dims (two warpgroups of 64
  query rows, each holding its rows' whole O); above, one 64-row query
  tile a block whose two warpgroups each own half of O's columns and the
  scores of half of each key tile's keys, sharing P through shared memory.
  The bf16 and fp16 backward runs Hopper kernels on the fixed tiles of
  ``WIDE_BWD_TILES`` (head dims 192 to 576), each computing every score
  product once per query and key tile (twice above 256 in dK/dV, whose
  grid takes half of the columns a block). The fp32 kernels and a 16-bit
  kernel above 576 split the output's head-dim columns into slices across
  the grid and compute the scores over the whole head dim in streamed
  chunks.

Beside each kernel's wrapper is its plain PyTorch version: masked dense
softmax attention in fp32 with the same semantics (decode-convention
causal mask, ``NEG_INF`` masking, fp32 ``lse``). A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises. Each wrapper counts its launches in ``.launches``.

The public ``flash_attention`` takes ``(B, S, H, D)`` like the reference
and runs the kernels on contiguous ``(B, H, S, D)`` panels; a
``torch.autograd.Function`` stands in for ``jax.custom_vjp``. Like the
reference it takes any head dim: one that no kernel compiles is
zero-padded to ``padded_head_dim``, on every device, and the result sliced
back. It resolves its tiles as the reference does (``resolve_blocks``:
argument, ``HVD_FLASH_BLOCK_Q/K``, the tile tuner of ``ops/block_tuner.py``,
default); on the card they govern the sliced wide kernels (fp32, and
16-bit above 576) and the backward kernels at head dims up to 128.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import _build

NEG_INF = -1e30
# The query and key tile (rows) of the backward kernels at HEAD_DIMS and of
# the wide family's sliced kernels (fp32, and 16-bit past WIDE_FWD_TILES
# and WIDE_BWD_TILES): the only tile they compile, so a resolved
# block_q/block_k on a CUDA tensor must be this.
TILE = 64
COMPILED_TILES = (TILE,)
HEAD_DIMS = (16, 32, 64, 128)
# The fixed (query rows, keys) tile of the bf16/fp16 forward at each head
# dim in HEAD_DIMS (``fwd_wgmma_kernel``: two warpgroups of 64 rows; at
# D = 128 a 128-key tile would not fit the registers); the resolved tile
# does not reach it.
FWD_TILES = {16: (128, 128), 32: (128, 128), 64: (128, 128), 128: (128, 64)}
# Above HEAD_DIMS the wide family takes head dims that are multiples of
# this (its streamed chunk of the head dim).
WIDE_STEP = 64
# The fixed (query rows, keys) tile of the bf16/fp16 forward at each head
# dim above HEAD_DIMS that it is compiled for: ``fwd_wgmma_kernel``'s at
# 192 and 256, ``wide_fwd_wgmma_kernel``'s above (two warpgroups split O's
# columns and each tile's keys; the most keys that two K and two V stages
# beside Q leave room for). The resolved tile does not reach it. A 16-bit
# forward at a wide head dim past these runs the fp32 forward's kernel
# (O's columns sliced across the grid), on the resolved tile.
WIDE_FWD_TILES = {192: (128, 64), 256: (128, 64), 320: (64, 64),
                  384: (64, 48), 448: (64, 32), 512: (64, 32), 576: (64, 32)}
# The fixed tiles of the bf16/fp16 backward at each head dim above
# HEAD_DIMS that it is compiled for: ((query rows, keys) of
# ``wide_dkv_wgmma_kernel``, (query rows, keys) of the dQ kernel).
# dK/dV holds 64 keys and streams query tiles; dQ holds 128 query rows
# (``wide_dq_rows_wgmma_kernel``, three stages) at 192 and 256 and 64 above
# (``wide_dq_wgmma_kernel``) and streams key tiles; each streamed tile the
# most that its stages beside the resident operands leave room for. Above
# 256 each dK/dV block takes half of dK's and dV's columns. The resolved
# tile does not reach them. A 16-bit backward at a wide head dim past
# these, and fp32 at every wide head dim, runs the sliced kernels on the
# resolved tile.
WIDE_BWD_TILES = {192: ((64, 64), (128, 48)), 256: ((64, 64), (128, 32)),
                  320: ((48, 64), (64, 48)), 384: ((32, 64), (64, 32)),
                  448: ((16, 64), (64, 16)), 512: ((16, 64), (64, 16)),
                  576: ((16, 64), (64, 16))}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The reference's tiles when nothing else picks them
# (``pallas_attention.py:428-431``); the CPU's plain version ignores them.
DEFAULT_BLOCKS = (256, 512)


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
    q's dtype, lse (B, H, Sq) fp32.

    A query row that sees no key (causal, Sq > Skv: rows before the first
    key's position) gets the reference's answer with one tile spanning the
    sequence, every key weighing the same: O is the mean of V over all
    Skv keys and lse is ``NEG_INF + log Skv`` in fp32, which is what
    logsumexp gives over scores that are all ``NEG_INF``."""
    s, mask = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    # exp(s - lse) would be exp(0) = 1 there: log Skv is lost in fp32.
    p = torch.where(mask.any(-1)[:, None], torch.exp(s - lse[..., None]),
                    1.0 / k.shape[2])
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


def _wide(d: int) -> bool:
    """Whether head dim ``d`` runs on the wide family."""
    return d > HEAD_DIMS[-1] and d % WIDE_STEP == 0


def _check_cuda(name, q, k, v, do=None):
    """Validate what the kernel will index through raw pointers."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError("%s: dtype %s not supported (fp32, bf16 or fp16)"
                        % (name, q.dtype))
    if q.ndim != 4 or not (q.shape[-1] in HEAD_DIMS or _wide(q.shape[-1])):
        raise ValueError("%s: q must be (B, H, S, D) with D in %s or a "
                         "multiple of %d above %d, got %s"
                         % (name, HEAD_DIMS, WIDE_STEP, HEAD_DIMS[-1],
                            tuple(q.shape)))
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
        # The tensor-core kernels and the wide family copy 16-byte chunks
        # of each row (TMA boxes in the forward).
        if (q.dtype != torch.float32 or _wide(q.shape[-1])) and \
                t.data_ptr() % 16:
            raise ValueError("%s: inputs must start on a 16-byte boundary"
                             % name)


def _launch(fn_name, d, *args):
    """Launch ``hvd_<fn_name>`` of the library that holds head dim ``d``:
    a path chosen by shape; a refused launch raises."""
    lib = _build.load("flash_attention_wide" if _wide(d)
                      else "flash_attention")
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
    _launch("hvd_flash_fwd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
    _launch("hvd_flash_bwd_dkv", d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
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
    _launch("hvd_flash_bwd_dq", d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
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


def padded_head_dim(d: int) -> int:
    """The head dim that a head dim of ``d`` runs at: ``d`` itself or the
    next one up in ``HEAD_DIMS``, and above the largest of them the next
    multiple of ``WIDE_STEP`` (the wide family). Zero columns change
    neither the scores nor ``delta``."""
    if d > HEAD_DIMS[-1]:
        return -(-d // WIDE_STEP) * WIDE_STEP
    return next(c for c in HEAD_DIMS if c >= d)


def resolve_blocks(seq_q: int, seq_kv: int, head_dim: int, dtype,
                   causal: bool, device, block_q: Optional[int] = None,
                   block_k: Optional[int] = None) -> Tuple[int, int]:
    """``(block_q, block_k)`` in the reference's order
    (``pallas_attention.py:405-433``): an explicit argument, then
    ``HVD_FLASH_BLOCK_Q/K``, then the tuned cache or the world's synced
    view (``ops/block_tuner.py``), then the default: ``TILE`` on the
    card, the reference's 256/512 on the CPU. The tuner is consulted only
    when neither argument nor either variable is set, and under
    ``HVD_FLASH_TUNE`` or a synced view. On a device other than the CPU a
    tile that no kernel compiles raises ``ValueError``."""
    device = torch.device(device)
    if block_q is None and block_k is None and \
            "HVD_FLASH_BLOCK_Q" not in os.environ and \
            "HVD_FLASH_BLOCK_K" not in os.environ:
        from horovod_tpu_torch.ops import block_tuner

        if block_tuner.tune_mode() \
                or block_tuner.world_synced_view_active():
            picked = block_tuner.best_blocks(seq_q, seq_kv, head_dim, dtype,
                                             causal, device=device)
            if picked is not None:
                block_q, block_k = picked
    card = device.type != "cpu"
    default_q, default_k = (TILE, TILE) if card else DEFAULT_BLOCKS
    if block_q is None:
        block_q = int(os.environ.get("HVD_FLASH_BLOCK_Q", default_q))
    if block_k is None:
        block_k = int(os.environ.get("HVD_FLASH_BLOCK_K", default_k))
    if card:
        for name, blk in (("block_q", block_q), ("block_k", block_k)):
            if blk not in COMPILED_TILES:
                raise ValueError(
                    "%s=%r: the CUDA kernels are compiled for %s-row "
                    "tiles" % (name, blk, "/".join(map(str,
                                                      COMPILED_TILES))))
    return block_q, block_k


def flash_attention(q, k, v, *, causal: bool = True,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None):
    """Fused streaming-softmax attention.

    Args:
      q, k, v: (batch, seq, heads, head_dim) tensors.
      causal: apply the causal mask (decode convention for Sq != Skv).
      block_q / block_k: tiles, resolved by ``resolve_blocks`` (argument >
        HVD_FLASH_BLOCK_Q/K > tuned cache > default). The CUDA kernels are
        compiled for one 64-row tile, so on a CUDA tensor the resolved
        tiles must be 64 (the bf16/fp16 forward runs its fixed
        ``FWD_TILES`` and ``WIDE_FWD_TILES``, the wide bf16/fp16 backward
        its ``WIDE_BWD_TILES``); the CPU's plain version does not tile and
        ignores them.
      scale: score scaling; defaults to 1/sqrt(head_dim).

    Returns:
      (batch, seq, heads, head_dim) output in q's dtype.

    A head dim that no kernel compiles is zero-padded to
    ``padded_head_dim`` (q, k and v; autograd pads dO and slices dQ, dK
    and dV back), with the true head dim's scale. Every head dim runs: up
    to 128 on the kernels of ``HEAD_DIMS``, above on the wide family.
    """
    if q.ndim != 4:
        raise ValueError("expected (B, S, H, D) inputs, got %r"
                         % (tuple(q.shape),))
    d = q.shape[-1]
    resolve_blocks(q.shape[1], k.shape[1], d, q.dtype, causal, q.device,
                   block_q, block_k)
    if scale is None:
        scale = float(d) ** -0.5
    dp = padded_head_dim(d)
    if dp != d:
        q, k, v = (F.pad(x, (0, dp - d)) for x in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = _Flash.apply(qt, kt, vt, bool(causal), float(scale))
    if dp != d:
        out = out[..., :d]
    return out.transpose(1, 2)
