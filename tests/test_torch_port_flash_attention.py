"""The port's flash attention (horovod_tpu_torch) against the reference's.

The reference runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode. The port runs its plain PyTorch versions (on the CPU
its wrappers take no other path). Inputs come from numpy with a seed and
go to both. Tolerances are the reference tests' own: 1e-5 relative in
fp32 (the same math, summed in another order), 5e-2 for bf16 inputs
(outputs rounded to bf16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from horovod_tpu.ops.pallas_attention import _flash_fwd_impl
from horovod_tpu.ops.pallas_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa

# tests/test_pallas_attention.py CASES and RECT_CASES.
CASES = [
    # (B, S, H, D, causal, block_q, block_k)
    (2, 64, 2, 32, True, 32, 32),
    (1, 100, 2, 16, False, 32, 32),
    (2, 128, 4, 64, True, 128, 128),
    (1, 96, 1, 8, True, 64, 32),
    (1, 130, 2, 16, True, 64, 64),
]
RECT_CASES = [
    # (B, Sq, Skv, H, D, causal, block_q, block_k)
    (1, 1, 64, 2, 16, True, 32, 32),
    (1, 16, 48, 2, 8, True, 16, 16),
    (1, 30, 70, 1, 8, True, 16, 32),
]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _inputs(seed, b, sq, skv, h, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, h, d).astype(np.float32),
            rng.randn(b, skv, h, d).astype(np.float32))


def _jax_out_and_grads(q, k, v, causal, bq, bk):
    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=bq,
                                 block_k=bk) ** 2)

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = jax_flash(*args, causal=causal, block_q=bq, block_k=bk)
    grads = jax.grad(loss, (0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_out_and_grads(q, k, v, causal, bq, bk):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, block_q=bq, block_k=bk)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check_case(seed, b, sq, skv, h, d, causal, bq, bk):
    q, k, v = _inputs(seed, b, sq, skv, h, d)
    ref_out, ref_grads = _jax_out_and_grads(q, k, v, causal, bq, bk)
    out, grads = _port_out_and_grads(q, k, v, causal, bq, bk)
    assert out.shape == ref_out.shape
    assert _rel(out, ref_out) < 1e-5
    for g, rg in zip(grads, ref_grads):
        assert g.shape == rg.shape
        assert _rel(g, rg) < 1e-5


@pytest.mark.parametrize("b,s,h,d,causal,bq,bk", CASES)
def test_forward_and_gradients_match_reference(b, s, h, d, causal, bq, bk):
    _check_case(0, b, s, s, h, d, causal, bq, bk)


@pytest.mark.parametrize("b,sq,skv,h,d,causal,bq,bk", RECT_CASES)
def test_rectangular_causal_matches_reference(b, sq, skv, h, d, causal, bq,
                                              bk):
    """Decode convention: the end of q aligns with the end of kv."""
    _check_case(5, b, sq, skv, h, d, causal, bq, bk)


# Causal, Sq > Skv: the first Sq - Skv query rows see no key. The reference
# with one tile spanning each sequence visits every key for them, each score
# NEG_INF, so O is the mean of V and lse NEG_INF + log Skv (-1e30 in fp32);
# the port's plain version gives that on every tile size, and so must every
# kernel on the card (chip_smoke.py, C18_CHECK_DIMS). fp32 at the reference
# tests' 1e-5, gradients included (the backward masks those rows' P to 0 in
# both).
@pytest.mark.parametrize("b,sq,skv,h,d", [(1, 48, 20, 2, 16),
                                          (2, 70, 33, 1, 8)])
def test_rows_that_see_no_key_match_whole_sequence_tiles(b, sq, skv, h, d):
    _check_case(9, b, sq, skv, h, d, True, sq, skv)
    q, k, v = _inputs(9, b, sq, skv, h, d)
    scale = d ** -0.5
    ref_out, res = _flash_fwd_impl(
        *(jnp.asarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)), True,
        sq, skv, scale, True)
    out, lse = fa.flash_fwd(*(torch.tensor(x.transpose(0, 2, 1, 3))
                              for x in (q, k, v)), True, scale)
    none = sq - skv
    ref_lse = np.asarray(res[4])
    assert np.array_equal(lse[:, :, :none].numpy(), ref_lse[:, :, :none])
    assert float(lse[0, 0, 0]) == np.float32(fa.NEG_INF)
    assert _rel(lse[:, :, none:].numpy(), ref_lse[:, :, none:]) < 1e-5
    mean_v = v.transpose(0, 2, 1, 3).mean(axis=2, keepdims=True)
    assert _rel(out[:, :, :none].numpy(),
                np.broadcast_to(mean_v, out[:, :, :none].shape)) < 1e-5
    assert _rel(out.numpy(), np.asarray(ref_out)) < 1e-5


def test_bfloat16_inputs_match_reference():
    q, k, v = _inputs(2, 1, 64, 64, 2, 32)
    ref = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    causal=True)
    out = fa.flash_attention(*(torch.tensor(x).to(torch.bfloat16)
                               for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) < 5e-2


# ---------------------------------------- fp16 and every head dim <= 128 ---
#
# A head dim that no kernel compiles runs zero-padded to the next compiled
# one on every device, so the CPU's plain versions take the padded path
# too. fp32 holds the reference tests' 1e-5; fp16 holds 2^-10, one fp16
# rounding step (both sides round their outputs and gradients to fp16, in
# other places; the worst of these cases reads 3.7e-4).

PAD_DIMS = (8, 48, 80, 96, 112)
FP16_TOL = 2 ** -10


def _check_dtype_case(dtype, d, causal, tol, b=1, sq=40, skv=72, h=2):
    q, k, v = _inputs(3, b, sq, skv, h, d)
    jdt = {torch.float32: jnp.float32, torch.float16: jnp.float16}[dtype]

    def loss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal)
                       .astype(jnp.float32) ** 2)

    args = tuple(jnp.asarray(x, jdt) for x in (q, k, v))
    ref = jax_flash(*args, causal=causal)
    ref_grads = jax.grad(loss, (0, 1, 2))(*args)
    ts = [torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal)
    (out.float() ** 2).sum().backward()
    assert out.dtype == dtype and out.shape == (b, sq, h, d)
    assert _rel(out.detach().float().numpy(),
                np.asarray(ref, np.float32)) < tol
    for t, g in zip(ts, ref_grads):
        assert t.grad.dtype == dtype and t.grad.shape == g.shape
        assert _rel(t.grad.float().numpy(), np.asarray(g, np.float32)) < tol


@pytest.mark.parametrize("d", PAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_padded_head_dims_match_reference(d, causal):
    """Head dims no kernel compiles, Sq != Skv, fp32: output and
    gradients against the Pallas kernels in interpret mode."""
    _check_dtype_case(torch.float32, d, causal, 1e-5)


@pytest.mark.parametrize("d", (16, 48, 64, 80, 96))
@pytest.mark.parametrize("causal", [True, False])
def test_fp16_inputs_match_reference(d, causal):
    """fp16 in and out, compiled and padded head dims, Sq != Skv."""
    _check_dtype_case(torch.float16, d, causal, FP16_TOL)


@pytest.mark.parametrize("d,want", [(1, 16), (8, 16), (16, 16), (17, 32),
                                    (48, 64), (64, 64), (80, 128),
                                    (96, 128), (112, 128), (128, 128),
                                    (129, 192), (256, 256), (257, 320),
                                    (512, 512), (576, 576)])
def test_padded_head_dim(d, want):
    """Up to 128 the next compiled head dim; above, the next multiple of
    64 (the wide family's chunk)."""
    assert fa.padded_head_dim(d) == want


@pytest.mark.parametrize("d", [48, 100])
def test_padded_path_equals_the_unpadded_plain_version(d):
    """On the CPU the padded path (zero columns in q, k, v and dO, the
    true head dim's scale, O and the gradients cut back) equals the plain
    versions run at the true head dim, through autograd, within fp32
    rounding: zero columns add exact zeros to every sum."""
    q, k, v = _inputs(4, 2, 50, 66, 3, d)
    do = np.random.RandomState(5).randn(2, 50, 3, d).astype(np.float32)
    got = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fa.flash_attention(*got, causal=True)
    out.backward(torch.tensor(do))
    want = [torch.tensor(x).transpose(1, 2).requires_grad_()
            for x in (q, k, v)]
    o, _ = fa.flash_fwd_plain(*want, True, d ** -0.5)
    o.backward(torch.tensor(do).transpose(1, 2))
    assert out.shape == (2, 50, 3, d)
    assert _rel(out.detach().numpy(),
                o.detach().transpose(1, 2).numpy()) < 1e-6
    for g, w in zip(got, want):
        assert _rel(g.grad.numpy(), w.grad.transpose(1, 2).numpy()) < 1e-6


def test_head_dim_above_the_compiled_ones(monkeypatch):
    """D > 128 runs (ROADMAP C16 closed): D = 160 takes the padded path to
    192, which on the CPU equals the plain version at the true head dim;
    off the CPU (meta tensors stand in for a card, with a library that
    records its calls) ``flash_attention`` raises no ValueError and
    launches the wide library's forward at 192, and D = 64 the forward of
    the library of the compiled head dims."""
    q, k, v = (torch.tensor(x) for x in _inputs(6, 1, 16, 16, 1, 160))
    out = fa.flash_attention(q, k, v, causal=True)
    want, _ = fa.flash_fwd_plain(*(x.transpose(1, 2) for x in (q, k, v)),
                                 True, 160 ** -0.5)
    assert fa.padded_head_dim(160) == 192
    assert _rel(out.numpy(), want.transpose(1, 2).numpy()) < 1e-6
    from horovod_tpu_torch.ops import _build

    calls = []

    class Library:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, fn):
            def entry(*args):
                calls.append((self.name, fn, args[9]))
                return 0
            return entry

    monkeypatch.setattr(_build, "load", Library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0}))
    fa.reset_launches()
    for d in (160, 64):
        m = torch.empty(1, 16, 1, d, device="meta")
        assert fa.flash_attention(m, m, m).shape == (1, 16, 1, d)
    assert calls == [("flash_attention_wide", "hvd_flash_fwd", 192),
                     ("flash_attention", "hvd_flash_fwd", 64)]
    assert [f.launches for f in fa.KERNELS] == [2, 0, 0]
    fa.reset_launches()


# Head dims above 128: the wide family's padded path (to a multiple of 64)
# against the Pallas kernels in interpret mode, Sq != Skv, fp32 at the
# reference tests' 1e-5 and fp16 at FP16_TOL.
WIDE_DIMS = (160, 192, 256, 320, 512, 576)


@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float16, FP16_TOL)])
def test_wide_head_dims_match_reference(d, causal, dtype, tol):
    _check_dtype_case(dtype, d, causal, tol, sq=40, skv=100)


@pytest.mark.parametrize("sq,skv,causal", [(64, 64, True), (30, 70, True),
                                           (100, 100, False)])
def test_lse_matches_reference_residual(sq, skv, causal):
    b, h, d = 2, 2, 16
    rng = np.random.RandomState(7)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, skv, d).astype(np.float32)
    v = rng.randn(b, h, skv, d).astype(np.float32)
    scale = d ** -0.5
    ref_out, res = _flash_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v)), causal, 32, 32, scale, True)
    out, lse = fa.flash_fwd(*(torch.tensor(x) for x in (q, k, v)), causal,
                            scale)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert _rel(lse.numpy(), np.asarray(res[4])) < 1e-5
    assert _rel(out.numpy(), np.asarray(ref_out)) < 1e-5


def test_cpu_path_counts_no_launch():
    before = [f.launches for f in fa.KERNELS]
    q = torch.randn(1, 8, 1, 16)
    fa.flash_attention(q, q, q, causal=True)
    assert [f.launches for f in fa.KERNELS] == before


def test_block_sizes_on_a_card_must_be_the_compiled_tile():
    """On a non-CPU tensor a tile other than the kernels' raises before
    anything is launched (meta tensors stand in for the card here)."""
    q = torch.empty(1, 128, 2, 64, device="meta")
    with pytest.raises(ValueError, match="block_q"):
        fa.flash_attention(q, q, q, block_q=128)
    with pytest.raises(ValueError, match="block_k"):
        fa.flash_attention(q, q, q, block_k=32)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("q,k,v,do,err", [
    (_meta(1, 2, 8, 64), _meta(1, 2, 8, 32), _meta(1, 2, 8, 32), None,
     ValueError),                                   # head_dim differs
    (_meta(1, 2, 8, 64), _meta(1, 4, 8, 64), _meta(1, 4, 8, 64), None,
     ValueError),                                   # heads differ
    (_meta(1, 2, 8, 48), _meta(1, 2, 8, 48), _meta(1, 2, 8, 48), None,
     ValueError),                                   # head_dim not compiled
    (_meta(1, 2, 8, 160), _meta(1, 2, 8, 160), _meta(1, 2, 8, 160), None,
     ValueError),                                   # not a multiple of 64
    (_meta(1, 2, 8, 64, dtype=torch.float64),) * 3 + (None, TypeError),
    (_meta(1, 8, 2, 64).transpose(1, 2),) * 3 + (None, ValueError),
    (_meta(1, 2, 8, 64), _meta(1, 2, 9, 64), _meta(1, 2, 9, 64),
     _meta(1, 2, 9, 64), ValueError),               # dO is not q-shaped
])
def test_kernel_wrappers_validate_before_launch(q, k, v, do, err):
    with pytest.raises(err):
        if do is None:
            fa.flash_fwd(q, k, v, True, 0.125)
        else:
            lse = _meta(*q.shape[:3])
            fa.flash_bwd_dkv(q, k, v, do, lse, lse, True, 0.125)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """Without a built kernel a non-CPU tensor raises; it does not fall
    back to the plain version."""
    from horovod_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc present: this checks a machine without one")
    if _build.library_path("flash_attention").exists():
        pytest.skip("a built kernel library is present")
    q = _meta(1, 2, 8, 64)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.flash_fwd(q, q, q, True, 0.125)


# ------------------------------------------ the tensor-core kernels' math ---
#
# The bf16 kernels run their products on the tensor cores: bf16 operands,
# exact products, fp32 sums, the scale applied to the fp32 scores, and P
# (and dS) rounded to bf16 before the products that consume them. _tensor_core_math repeats that rounding in PyTorch on the
# CPU, tile for tile, so the limits the card is held to can be checked
# here before chip time is spent: chip_smoke.py's element-by-element
# limits against the plain versions (TOLS, LSE_TOL), and 5e-2 against the
# JAX kernels (the reference tests' bf16 tolerance).

SHAPE = (1, 2, 130, 200)  # (B, H, Sq, Skv): ragged tiles, Sq != Skv


def _r16(x, dtype):
    """``x`` rounded to the 16-bit ``dtype`` (bf16 or fp16), back in fp32."""
    return x.to(dtype).float()


def _tensor_core_math(q, k, v, do, causal, scale):
    """(O, lse, dK, dV, dQ) as the tensor-core kernels round them; bf16 or
    fp16 (B, H, S, D) in. The forward streams key tiles up to each query
    tile's causal bound, as the kernel does, on the Hopper forwards' fixed
    tiles: ``FWD_TILES`` at the head dims in ``HEAD_DIMS`` and
    ``WIDE_FWD_TILES`` above them; past those, on the sliced kernel's
    ``TILE``; delta is rowsum(dO * O)."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    sq, skv = q.shape[2], k.shape[2]
    tq, tk = {**fa.FWD_TILES, **fa.WIDE_FWD_TILES}.get(
        q.shape[-1], (fa.TILE, fa.TILE))
    mask = fa._mask(sq, skv, causal, q.device)
    o = torch.empty_like(qf)
    lse = torch.empty(q.shape[:3])
    for q0 in range(0, sq, tq):
        rows = slice(q0, min(q0 + tq, sq))
        nkb = -(-skv // tk)
        if causal:
            last = q0 + tq + skv - sq
            nkb = min(nkb, max(-(-last // tk), 0))
        m = torch.full(qf[:, :, rows, 0].shape, fa.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf[:, :, rows])
        for k0 in range(0, nkb * tk, tk):
            cols = slice(k0, min(k0 + tk, skv))
            s = (qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)) * scale
            s = s.masked_fill(~mask[rows, cols], fa.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _r16(p, q.dtype) @ vf[:, :, cols]
            m = m_new
        l_safe = torch.where(l == 0, torch.ones_like(l), l)
        o[:, :, rows] = acc / l_safe[..., None]
        lse[:, :, rows] = m + torch.log(l_safe)
    o = o.to(q.dtype)
    delta = (dof * o.float()).sum(-1)
    dk, dv = _tensor_core_dkv(q, k, v, do, lse, delta, causal, scale)
    dq = _tensor_core_dq(q, k, v, do, lse, delta, causal, scale)
    return o, lse, dk, dv, dq


def _bwd_tiles(d):
    """((query rows, keys) of the dK/dV kernel, (query rows, keys) of the
    dQ kernel) at head dim ``d``: the Hopper backward's ``BWD_TILES`` or
    ``WIDE_BWD_TILES`` where it is compiled, else the sliced kernels'
    ``TILE``."""
    return {**fa.BWD_TILES, **fa.WIDE_BWD_TILES}.get(
        d, ((fa.TILE, fa.TILE), (fa.TILE, fa.TILE)))


def test_bwd_tiles_cover_the_head_dims_and_are_wgmma_tiles():
    """``BWD_TILES`` holds a tile pair at each head dim of ``HEAD_DIMS`` and
    no other, and each is a legal wgmma tiling: the resident rows of a
    block (dK/dV's keys, dQ's query rows) are the M side of its products,
    two warpgroups of 64, a multiple of 64; the streamed rows (dK/dV's
    query rows, dQ's keys) are the K side of its output products and the
    N side of its score products, a multiple of 16."""
    assert sorted(fa.BWD_TILES) == sorted(fa.HEAD_DIMS)
    for d, ((dkv_q, dkv_k), (dq_q, dq_k)) in fa.BWD_TILES.items():
        assert dkv_k % 64 == 0 and dq_q % 64 == 0, d
        assert dkv_q % 16 == 0 and dq_k % 16 == 0, d
        assert 16 <= dkv_q <= 256 and 16 <= dq_k <= 256, d


def _bwd_scores(q, k, v, do, lse, delta, causal, scale):
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    mask = fa._mask(q.shape[2], k.shape[2], causal, q.device)
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    return qf, kf, dof, p, ds


def _tensor_core_dkv(q, k, v, do, lse, delta, causal, scale):
    """dK and dV as the kernels sum them: P^T and dS^T rounded to the
    16-bit type, fp32 sums over the dK/dV kernel's query tiles in order."""
    qf, _, dof, p, ds = _bwd_scores(q, k, v, do, lse, delta, causal, scale)
    (tq, _), _ = _bwd_tiles(q.shape[-1])
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for q0 in range(0, q.shape[2], tq):
        rows = slice(q0, q0 + tq)
        dv += _r16(p[:, :, rows], q.dtype).transpose(-1, -2) @ dof[:, :, rows]
        dk += _r16(ds[:, :, rows], q.dtype).transpose(-1, -2) @ qf[:, :, rows]
    return (dk * scale).to(q.dtype), dv.to(q.dtype)


def _tensor_core_dq(q, k, v, do, lse, delta, causal, scale):
    """dQ as the kernels sum it: dS rounded to the 16-bit type, fp32 sums
    over the dQ kernel's key tiles in order."""
    _, kf, _, _, ds = _bwd_scores(q, k, v, do, lse, delta, causal, scale)
    _, (_, tk) = _bwd_tiles(q.shape[-1])
    dq = torch.zeros_like(q, dtype=torch.float32)
    for k0 in range(0, k.shape[2], tk):
        cols = slice(k0, k0 + tk)
        dq += _r16(ds[..., cols], q.dtype) @ kf[:, :, cols]
    return (dq * scale).to(q.dtype)


def _bf16_inputs(seed, d):
    b, h, sq, skv = SHAPE
    rng = np.random.RandomState(seed)
    return tuple(torch.tensor(rng.randn(b, h, s, d), dtype=torch.float32)
                 .to(torch.bfloat16) for s in (sq, skv, skv, sq))


def _within_chip_limits(got, want):
    """chip_smoke.py's check of a kernel's output against its plain
    version: lse (fp32) to LSE_TOL absolute, the rest element by element
    to TOLS of their dtype."""
    assert got.shape == want.shape
    if want.dtype == torch.float32 and want.ndim == 3:  # lse
        return float((got - want).abs().max()) <= chip_smoke.LSE_TOL
    rtol, atol = chip_smoke.TOLS[str(want.dtype)[6:]]
    return chip_smoke.limit_ratio(got, want, rtol, atol) <= 1.0


def _bwd_args(q, k, v, do, o, lse, causal, scale):
    """The backward kernels' inputs after a forward that gave (o, lse),
    with delta as _Flash computes it."""
    return (q, k, v, do, lse, (do.float() * o.float()).sum(-1), causal,
            scale)


# The head dims of the chip-tolerance rounding tests: every compiled one up
# to 128 (the tiles of BWD_TILES), each tile of WIDE_BWD_TILES, and 640
# past them (the sliced kernels).
ROUNDING_DIMS = fa.HEAD_DIMS + (192, 256, 320, 384, 448, 512, 576, 640)


@pytest.mark.parametrize("d", ROUNDING_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chained", [False, True])
def test_tensor_core_rounding_within_chip_tolerance(d, causal, chained):
    """Against the plain versions on the same inputs, as chip_smoke.py
    compares the kernels on the card: the backward on the plain
    forward's lse and delta, or chained on the emulated forward's."""
    q, k, v, do = _bf16_inputs(11, d)
    scale = d ** -0.5
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    o, lse, _, _, _ = _tensor_core_math(q, k, v, do, causal, scale)
    args = _bwd_args(q, k, v, do, *((o, lse) if chained else
                                    (o_ref, lse_ref)), causal, scale)
    pairs = [(o, o_ref), (lse, lse_ref)]
    pairs += zip(_tensor_core_dkv(*args), fa.flash_bwd_dkv_plain(*args))
    pairs.append((_tensor_core_dq(*args), fa.flash_bwd_dq_plain(*args)))
    for got, want in pairs:
        assert _within_chip_limits(got, want)


def test_chip_limits_reject_a_wrong_kernel():
    """Errors a forward kernel could make while staying within 2e-2 of
    the largest reference value, at the slice's sequence length: lse off
    by 0.15 nats, which would scale P in the backward by 14%; and O 20%
    too large in the query rows past 1024 (their softmax sum a sixth
    short)."""
    rng = np.random.RandomState(14)
    s = 2048
    q, k, v = (torch.tensor(rng.randn(1, 1, s, 64), dtype=torch.float32)
               .to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_fwd_plain(q, k, v, True, 0.125)
    assert _within_chip_limits(o, o) and _within_chip_limits(lse, lse)
    assert _rel(lse + 0.15, lse) < 2e-2
    assert not _within_chip_limits(lse + 0.15, lse)
    o_bad = o.clone()
    o_bad[:, :, s // 2:] *= 1.2
    assert _rel(o_bad.float().numpy(), o.float().numpy()) < 2e-2
    assert not _within_chip_limits(o_bad, o)


def test_chip_limits_take_rounding_residue_in_a_zero_row():
    """Causal, Sq == Skv: query row 0 sees one key, so its exact dQ is 0
    (dP = delta) and the plain version gives 0 or an fp32 residue. The
    card's other summation order leaves another residue there, about
    1e-6; the limit takes it, and still rejects an error of a tenth of a
    typical element."""
    rng = np.random.RandomState(15)
    q, k, v, do = (torch.tensor(rng.randn(1, 4, 256, 64), dtype=torch.float32)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True, 0.125)
    dq = fa.flash_bwd_dq_plain(*_bwd_args(q, k, v, do, o, lse, True, 0.125))
    assert float(dq[:, :, 0].float().abs().min()) == 0.0
    residue, wrong = dq.clone(), dq.clone()
    residue[:, :, 0] = 1e-6
    wrong[:, :, 0] = 0.1 * float(dq.float().abs().mean())
    assert _within_chip_limits(residue, dq)
    assert not _within_chip_limits(wrong, dq)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_within_reference_tolerance(d, causal):
    """Against the JAX kernels in interpret mode: O, dK, dV and dQ."""
    q, k, v, do = _bf16_inputs(12, d)
    o, _, dk, dv, dq = _tensor_core_math(q, k, v, do, causal, d ** -0.5)

    def bshd(x):  # (B, H, S, D) torch bf16 -> (B, S, H, D) jax bf16
        return jnp.asarray(x.float().transpose(1, 2).numpy(), jnp.bfloat16)

    ref_o, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, block_q=64,
                                  block_k=64),
        bshd(q), bshd(k), bshd(v))
    ref_dq, ref_dk, ref_dv = vjp(bshd(do))
    for got, want in ((o, ref_o), (dk, ref_dk), (dv, ref_dv), (dq, ref_dq)):
        want = np.asarray(want, np.float32).transpose(0, 2, 1, 3)
        assert _rel(got.float().numpy(), want) < 5e-2


def _fp16_inputs(seed, d):
    return tuple(x.to(torch.float16) for x in _bf16_inputs(seed, d))


@pytest.mark.parametrize("d", ROUNDING_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chained", [False, True])
def test_fp16_tensor_core_rounding_within_chip_tolerance(d, causal,
                                                         chained):
    """The fp16 kernels' rounding (P and dS to fp16 before their
    products) against the plain versions within chip_smoke.py's fp16
    limits, as the bf16 case above."""
    q, k, v, do = (torch.tensor(np.random.RandomState(13).randn(
        *shape), dtype=torch.float32).to(torch.float16)
        for shape in ((1, 2, 130, d), (1, 2, 200, d), (1, 2, 200, d),
                      (1, 2, 130, d)))
    scale = d ** -0.5
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    o, lse, _, _, _ = _tensor_core_math(q, k, v, do, causal, scale)
    assert o.dtype == torch.float16
    args = _bwd_args(q, k, v, do, *((o, lse) if chained else
                                    (o_ref, lse_ref)), causal, scale)
    pairs = [(o, o_ref), (lse, lse_ref)]
    pairs += zip(_tensor_core_dkv(*args), fa.flash_bwd_dkv_plain(*args))
    pairs.append((_tensor_core_dq(*args), fa.flash_bwd_dq_plain(*args)))
    for got, want in pairs:
        assert _within_chip_limits(got, want)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_fp16_tensor_core_rounding_within_reference_tolerance(d):
    """The fp16 kernels' rounding against the JAX kernels in fp16, in
    interpret mode: O, dK, dV and dQ within one fp16 rounding step of
    the largest value (FP16_TOL)."""
    q, k, v, do = (torch.tensor(np.random.RandomState(14).randn(
        *shape), dtype=torch.float32).to(torch.float16)
        for shape in ((1, 2, 130, d), (1, 2, 200, d), (1, 2, 200, d),
                      (1, 2, 130, d)))
    o, _, dk, dv, dq = _tensor_core_math(q, k, v, do, True, d ** -0.5)

    def bshd(x):
        return jnp.asarray(x.float().transpose(1, 2).numpy(), jnp.float16)

    ref_o, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=True, block_q=64,
                                  block_k=64),
        bshd(q), bshd(k), bshd(v))
    ref_dq, ref_dk, ref_dv = vjp(bshd(do))
    for got, want in ((o, ref_o), (dk, ref_dk), (dv, ref_dv), (dq, ref_dq)):
        want = np.asarray(want, np.float32).transpose(0, 2, 1, 3)
        assert _rel(got.float().numpy(), want) < FP16_TOL


def test_fp16_chip_limits_take_the_zero_row_residue():
    """fp16, causal, Sq == Skv: dQ's first row is exactly 0, and the card
    leaves an fp32 residue there (dP from the tensor cores against delta
    from PyTorch; 2.448 of an fp16 limit floored at 2^-8 on an H100). The
    floor of 16-bit outputs (RESIDUE_FLOOR) takes 2e-6 there, as it does
    for bf16, and still rejects a tenth of a typical element; other rows
    keep fp16's own limit, which rejects an error of four fp16 steps."""
    rng = np.random.RandomState(15)
    q, k, v, do = (torch.tensor(rng.randn(1, 4, 256, 64),
                                dtype=torch.float32).to(torch.float16)
                   for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, True, 0.125)
    dq = fa.flash_bwd_dq_plain(*_bwd_args(q, k, v, do, o, lse, True, 0.125))
    assert float(dq[:, :, 0].float().abs().max()) < 1e-6
    residue, wrong, coarse = dq.clone(), dq.clone(), dq.float()
    residue[:, :, 0] = 2e-6
    wrong[:, :, 0] = 0.1 * float(dq.float().abs().mean())
    assert _within_chip_limits(residue, dq)
    assert not _within_chip_limits(wrong, dq)
    big = coarse.abs() == coarse.abs().max()
    coarse[big] *= 1 + 4 * 2 ** -10
    assert not _within_chip_limits(coarse.to(torch.float16), dq)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64)] + [
    (torch.bfloat16, d) for d in fa.HEAD_DIMS] + [
    (torch.float16, d) for d in fa.HEAD_DIMS])
def test_kernels_match_plain_versions_on_card(dtype, d):
    """chip_smoke.py's limits; the backward on the plain forward's lse and
    delta, and chained on the kernel forward's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(3)
    b, h, sq, skv = 2, 3, 130, 200
    q, k, v, do = (torch.tensor(rng.randn(b, h, s, d), dtype=dtype,
                                device="cuda")
                   for s in (sq, skv, skv, sq))
    for causal in (True, False):
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, 0.125)
        o, lse = fa.flash_fwd(q, k, v, causal, 0.125)
        pairs = [(o, o_ref), (lse, lse_ref)]
        for fwd in ((o_ref, lse_ref), (o, lse)):
            args = _bwd_args(q, k, v, do, *fwd, causal, 0.125)
            pairs += zip(fa.flash_bwd_dkv(*args),
                         fa.flash_bwd_dkv_plain(*args))
            pairs.append((fa.flash_bwd_dq(*args),
                          fa.flash_bwd_dq_plain(*args)))
        for got, want in pairs:
            assert _within_chip_limits(got, want)


@pytest.mark.cuda
def test_bf16_dkv_kernel_is_deterministic_on_card():
    """No atomics: two runs at the slice's shape are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(4, 8, 2048, 64, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 0.125)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
def test_bf16_dq_kernel_is_deterministic_on_card():
    """One block writes each dQ row, with no atomics: two runs at the
    slice's shape are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn(4, 8, 2048, 64, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 0.125)
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))


@pytest.mark.cuda
def test_fp16_backward_kernels_are_deterministic_on_card():
    """fp16 at the slice's shape: two runs of each backward kernel are
    bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(2)
    q, k, v, do = (torch.randn(4, 8, 2048, 64, generator=g, device="cuda")
                   .to(torch.float16) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 0.125)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 0.125)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96])
def test_padded_head_dims_on_card(d):
    """fp16 through ``flash_attention`` at a padded head dim: the kernels
    launch (one each) and O equals the CPU's padded path within
    chip_smoke.py's fp16 limits; then each kernel, zero-padded as
    ``flash_attention`` runs it, against its plain version at the true
    head dim (``chip_smoke.compare_kernels``: the backward on the plain
    forward's lse and delta, and chained on the kernel forward's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(1, 256, 4, d, generator=g, device="cuda")
                   .to(torch.float16) for _ in range(4))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    out = fa.flash_attention(*ts, causal=True)
    out.backward(do)
    assert [f.launches for f in fa.KERNELS] == [1, 1, 1]
    assert all(t.grad.shape == t.shape for t in ts)
    want = fa.flash_attention(*(x.cpu() for x in (q, k, v)), causal=True)
    assert _within_chip_limits(out.detach().transpose(1, 2).cpu(),
                               want.transpose(1, 2))
    for causal in (True, False):
        errs = chip_smoke.compare_kernels(torch, fa, 1, 4, 200, 256, d,
                                          torch.float16, causal, "cuda")
        for name, (parts, _) in errs.items():
            assert all(r <= 1.0 for _, r in parts), (name, parts)
