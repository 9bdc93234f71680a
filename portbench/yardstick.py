"""The benchmark's own arithmetic: the card's peaks, the least time of a
flash kernel, the model FLOPs of a step, and the kernel families a trace
is sorted into. Frozen copies: the program's own versions
(``chip_smoke.py``) may change, these do not."""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); a copy
# of chip_smoke.py's PEAK_FLOPS and PEAK_BYTES.
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def mix(*parts) -> int:
    """A 63-bit seed from any mix of numbers and strings, so that weights,
    each rank's batches and each check draw from streams of their own."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def bounds(b, h, sq, skv, d, kind, causal) -> Dict[str, Tuple[float, str]]:
    """(bound_ms, bound_by) of each flash kernel at head dim ``d`` in
    ``kind`` ("bf16", "fp16" or "fp32"): the larger of the bytes it must
    move over HBM bandwidth and the products over the type's peak.
    Products count only the (q, k) pairs the mask leaves. A copy of
    ``chip_smoke.py``'s ``bounds``."""
    itemsize = 4 if kind == "fp32" else 2
    off = skv - sq
    pairs = sum(min(max(r + off + 1, 0), skv) for r in range(sq)) \
        if causal else sq * skv
    pairs *= b * h
    panel_q = b * h * sq * d * itemsize
    panel_k = b * h * skv * d * itemsize
    rows = b * h * sq * 4
    peak = PEAK_FLOPS[kind]
    work = {
        # fwd: S = QKᵀ, O = PV; q, k, v in, o and lse out.
        "flash_fwd": (4 * pairs * d, 2 * panel_q + 2 * panel_k + rows),
        # dK/dV: S, dP, dV, dK; q, k, v, dO, lse, delta in, dk, dv out.
        "flash_bwd_dkv": (8 * pairs * d, 2 * panel_q + 4 * panel_k
                          + 2 * rows),
        # dQ: S, dP, dQ; q, k, v, dO, lse, delta in, dq out.
        "flash_bwd_dq": (6 * pairs * d, 3 * panel_q + 2 * panel_k
                         + 2 * rows),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def attention_shape(config: dict, traffic: dict):
    """(B, H, S, D) of one launch of the cell's attention kernels."""
    h = config["n_head"]
    return (traffic["batch"], h, traffic["seq_len"], config["n_embd"] // h)


def lm_matmul_params(config: dict) -> int:
    """Parameters that enter a matmul once per token: each block's q, k,
    v, output and MLP projections, and the tied output head (the
    embedding's gather and the learned positions are no matmul)."""
    m, f = config["n_embd"], config["n_inner"]
    per_layer = 3 * m * m + m * m + 2 * m * f
    return config["n_layer"] * per_layer + config["vocab_size"] * m


def lm_flops_per_token(config: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token: 6 per matmul parameter (forward
    2, backward 4) and causal attention's QKᵀ and PV at 3 times their
    forward, over the (q, k) pairs the mask leaves. The recomputation of
    ``remat`` is not counted: it is no model FLOP."""
    m, layers = config["n_embd"], config["n_layer"]
    pairs = seq_len * (seq_len + 1) // 2
    attn_fwd = 4 * pairs * m * layers / seq_len
    return 6.0 * lm_matmul_params(config) + 3.0 * attn_fwd


def resnet_fwd_flops(config: dict, px: int) -> float:
    """Forward FLOPs of one image counted on the layer shapes: 2 k² C_in
    C_out H_out W_out for each convolution (a multiply-add is 2 FLOPs) and
    2 in out for the dense layer; SAME padding, v1.5 strides."""
    def out(size, stride):
        return -(-size // stride)

    filters = config["num_filters"]
    flops = 0
    size = out(px, 2)                      # the 7x7 stem, stride 2
    flops += 2 * 49 * 3 * filters * size * size
    size = out(size, 2)                    # the 3x3 max pool, stride 2
    cin = filters
    for i, count in enumerate(config["stage_sizes"]):
        feat = filters * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            so = out(size, stride)
            flops += 2 * cin * feat * size * size          # 1x1
            flops += 2 * 9 * feat * feat * so * so         # 3x3, strided
            flops += 2 * feat * 4 * feat * so * so         # 1x1
            if stride != 1 or cin != 4 * feat:
                flops += 2 * cin * 4 * feat * so * so      # projection
            cin, size = 4 * feat, so
    return float(flops + 2 * cin * config["num_classes"])


# (family, substring of the lowercased kernel name), first match wins: a
# copy of chip_smoke.py's KERNEL_FAMILIES. The convolution keys come
# before the matmul ones, since cuDNN's implicit-GEMM convolutions also
# carry "xmma", "cutlass" or "gemm".
KERNEL_FAMILIES = (("fusion", "fusionkernel"),
                   ("flash_bwd_dkv", "dkv_rows_wgmma_kernel"),
                   ("flash_bwd_dq", "dq_rows_wgmma_kernel"),
                   ("flash_bwd_dkv", "wide_dkv_wgmma_kernel"),
                   ("flash_bwd_dq", "wide_dq_wgmma_kernel"),
                   ("flash_fwd", "none_rows_kernel"),
                   ("flash_fwd", "wide_fwd_kernel"),
                   ("flash_bwd_dkv", "wide_dkv_kernel"),
                   ("flash_bwd_dq", "wide_dq_kernel"),
                   ("flash_fwd", "wide_fwd_wgmma_kernel"),
                   ("flash_fwd", "fwd_wgmma_kernel"),
                   ("flash_fwd", "fwd_kernel"),
                   ("flash_bwd_dkv", "dkv_kernel"),
                   ("flash_bwd_dq", "dq_kernel"), ("nccl", "nccl"),
                   ("conv", "fprop"), ("conv", "dgrad"), ("conv", "wgrad"),
                   ("conv", "conv"), ("conv", "winograd"),
                   ("batch_norm", "batch_norm"), ("batch_norm", "batchnorm"),
                   ("batch_norm", "bn_fw"), ("batch_norm", "bn_bw"),
                   ("optimizer", "multi_tensor"),
                   ("matmul", "gemm"), ("matmul", "nvjet"),
                   ("matmul", "cutlass"), ("matmul", "xmma"),
                   ("elementwise", "elementwise"),
                   ("elementwise", "reduce_kernel"))


def family(kernel_name: str) -> str:
    name = kernel_name.lower()
    return next((f for f, key in KERNEL_FAMILIES if key in name), "other")
