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


def test_bfloat16_inputs_match_reference():
    q, k, v = _inputs(2, 1, 64, 64, 2, 32)
    ref = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    causal=True)
    out = fa.flash_attention(*(torch.tensor(x).to(torch.bfloat16)
                               for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    assert _rel(out.float().numpy(), np.asarray(ref, np.float32)) < 5e-2


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
    (_meta(1, 2, 8, 64, dtype=torch.float16),) * 3 + (None, TypeError),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernels_match_plain_versions_on_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(3)
    b, h, sq, skv, d = 2, 3, 130, 200, 64
    q, k, v, do = (torch.tensor(rng.randn(b, h, s, d), dtype=dtype,
                                device="cuda")
                   for s in (sq, skv, skv, sq))
    for causal in (True, False):
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, 0.125)
        o, lse = fa.flash_fwd(q, k, v, causal, 0.125)
        delta = (do.float() * o_ref.float()).sum(-1)
        args = (q, k, v, do, lse_ref, delta, causal, 0.125)
        pairs = [(o, o_ref), (lse, lse_ref)]
        pairs += list(zip(fa.flash_bwd_dkv(*args),
                          fa.flash_bwd_dkv_plain(*args)))
        pairs.append((fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args)))
        for got, want in pairs:
            assert _rel(got.float().cpu().numpy(),
                        want.float().cpu().numpy()) < tol
