"""Flash attention on the card at every head dim (``@pytest.mark.cuda``;
skips without one). No JAX here: the parity with the reference runs on the
CPU in tests/test_torch_port_flash_attention.py.

Head dims above 128 run on the wide family (``csrc/flash_attention_wide.cu``)
in fp32, bf16 and fp16; the bf16/fp16 forward is a Hopper kernel up to
head dim 576 (``fwd_wgmma_kernel`` up to 256, ``wide_fwd_wgmma_kernel`` at
320-576) and the sliced ``wide_fwd_kernel`` above, whose lse feeds the
backward kernels; the bf16/fp16 backward is ``wide_dkv_wgmma_kernel`` with
``dq_rows_wgmma_kernel`` (192 and 256) or ``wide_dq_wgmma_kernel``
(320-576), and the sliced kernels elsewhere.
Rows that see no key (causal, Sq > Skv) are held on every forward route. Each kernel is held to its plain version within
chip_smoke.py's limits (``compare_kernels``: the backward on the plain
forward's lse and delta, and chained on the kernel forward's). Run with
``python3 -m pytest tests/test_torch_port_flash_wide_cards.py -m cuda -q``
on a machine with a card.
"""

import pytest
import torch

import chip_smoke
from horovod_tpu_torch.ops import flash_attention as fa

WIDE = (192, 256, 512, 576, 640)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _held(errs):
    for name, (parts, _) in errs.items():
        assert all(r <= 1.0 for _, r in parts), (name, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_head_dim_launches_each_kernel_once(card, d, dtype):
    """``flash_attention`` at D > 128 through autograd: one launch of each
    kernel, and O within chip_smoke.py's limits of the CPU's plain
    version."""
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(1, 200, 2, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reset_launches()
    out = fa.flash_attention(*ts, causal=True)
    out.backward(do)
    assert [f.launches for f in fa.KERNELS] == [1, 1, 1]
    assert all(t.grad.shape == t.shape and t.grad.dtype == dtype
               for t in ts)
    want = fa.flash_attention(*(x.cpu() for x in (q, k, v)), causal=True)
    rtol, atol = chip_smoke.TOLS[str(dtype)[6:]]
    assert chip_smoke.limit_ratio(out.detach().transpose(1, 2).cpu(),
                                  want.transpose(1, 2), rtol, atol) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", WIDE + (160,))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_wide_kernels_match_plain_versions(card, d, dtype, causal):
    """Ragged tiles, Sq != Skv; D = 160 runs padded to 192."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 2, 130, 200, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_hopper_forward_and_its_lse_in_the_backward(card, d, dtype, causal):
    """The Hopper forward against its plain version, and its lse (with
    delta from its O) feeding the backward kernels within their limits."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 130, 300, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_hopper_forward_at_the_slice_shape(card, dtype):
    b, h, s, d = chip_smoke.SLICE_SHAPE
    _held(chip_smoke.compare_kernels(torch, fa, b, h, s, s, d, dtype, True,
                                     "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_wide_backward_is_bit_equal_over_two_runs(card, dtype):
    """Each dK/dV and dQ element is summed by one block in a fixed order."""
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (torch.randn(2, 4, 256, 256, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, 256 ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, 256 ** -0.5)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", (192, 256, 512, 576))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_wide_hopper_forward_and_its_lse_in_the_backward(card, d, dtype,
                                                         causal):
    """The wide Hopper forward against its plain version, and its lse (with
    delta from its O) feeding the backward kernels within their limits;
    ragged tiles, Sq < Skv."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 130, 300, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", (192, 256, 512, 576))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_wide_hopper_forward_is_bit_equal_over_two_runs(card, d, dtype):
    """Each O and lse element is written by one block in a fixed order."""
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 4, 300, d, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    first = fa.flash_fwd(q, k, v, True, d ** -0.5)
    second = fa.flash_fwd(q, k, v, True, d ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_16bit_forward_past_the_hopper_head_dims(card, dtype, causal):
    """At D = 640, past ``WIDE_FWD_TILES``, the bf16/fp16 forward runs the
    sliced kernel: within its limits of the plain version, its lse in the
    backward within theirs (ragged tiles, Sq < Skv), and O and lse
    bit-equal over two runs."""
    d = 640
    assert d not in fa.WIDE_FWD_TILES and fa.padded_head_dim(d) == d
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 130, 300, d, dtype,
                                     causal, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 4, 300, d, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    first = fa.flash_fwd(q, k, v, causal, d ** -0.5)
    second = fa.flash_fwd(q, k, v, causal, d ** -0.5)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", chip_smoke.C18_CHECK_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_rows_that_see_no_key(card, d, dtype):
    """Causal, Sq > Skv: every forward route (D = 64 the narrow library's,
    192 the wide "rows", 576 the "columns", 640 the sliced kernel) gives
    the first Sq - Skv rows the plain version's convention, O the mean of
    V and lse NEG_INF + log Skv, and the backward kernels hold there."""
    b, h, sq, skv = chip_smoke.C18_SHAPE
    _held(chip_smoke.compare_kernels(torch, fa, b, h, sq, skv, d, dtype,
                                     True, "cuda"))
    q, k, v, _ = chip_smoke.make_inputs(torch, b, h, sq, skv, d, dtype,
                                        "cuda", 3)
    o, lse = fa.flash_fwd(q, k, v, True, d ** -0.5)
    none = sq - skv
    assert torch.all(lse[:, :, :none] == torch.tensor(fa.NEG_INF).float())
    mean = v.float().mean(2, keepdim=True).expand(-1, -1, none, -1)
    rtol, atol = chip_smoke.TOLS[str(dtype)[6:]]
    assert chip_smoke.limit_ratio(o[:, :, :none], mean.to(dtype), rtol,
                                  atol) <= 1.0


BWD_DIMS = tuple(fa.WIDE_BWD_TILES)


@pytest.mark.cuda
@pytest.mark.parametrize("d", BWD_DIMS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
@pytest.mark.parametrize("causal", [True, False])
def test_hopper_backward_matches_plain_versions(card, d, dtype, causal):
    """``wide_dkv_wgmma_kernel`` and ``wide_dq_wgmma_kernel`` at every head
    dim they are compiled for, ragged tiles, Sq < Skv: within chip_smoke.py's
    limits of their plain versions, on the plain forward's lse and delta and
    chained on the kernel forward's."""
    _held(chip_smoke.compare_kernels(torch, fa, 2, 3, 150, 260, d, dtype,
                                     causal, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("d", BWD_DIMS)
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float16))
def test_hopper_backward_is_bit_equal_over_two_runs(card, d, dtype):
    """Each dK/dV and dQ element is written by one block in a fixed order,
    with no atomics."""
    g = torch.Generator(device="cuda").manual_seed(d + 1)
    q, k, v, do = (torch.randn(2, 4, 300, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, d ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, d ** -0.5)
    first, second = fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv(*args)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert torch.equal(fa.flash_bwd_dq(*args), fa.flash_bwd_dq(*args))


def _backward_kernel_names(d, dtype):
    """The card kernels that one dK/dV and one dQ call run at head dim
    ``d`` in ``dtype`` (torch.profiler)."""
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(1, 2, 130, d, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, True, d ** -0.5)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, d ** -0.5)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fa.flash_bwd_dkv(*args)
        fa.flash_bwd_dq(*args)
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if "dkv" in e.key or "dq" in e.key}


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,hopper", [
    (256, torch.bfloat16, True), (576, torch.float16, True),
    (640, torch.bfloat16, False), (640, torch.float16, False),
    (256, torch.float32, False), (576, torch.float32, False)])
def test_backward_route_by_dtype_and_head_dim(card, d, dtype, hopper):
    """The route is chosen by dtype and head dim: bf16/fp16 at the head dims
    of ``WIDE_BWD_TILES`` run the Hopper kernels, fp32 and a 16-bit head dim
    past them (640) the sliced ``wide_dkv_kernel`` and ``wide_dq_kernel``."""
    assert (d in fa.WIDE_BWD_TILES and dtype != torch.float32) == hopper
    names = _backward_kernel_names(d, dtype)
    wgmma = [n for n in names if "_wgmma_kernel" in n]
    sliced = [n for n in names if "wide_dkv_kernel" in n
              or "wide_dq_kernel" in n]
    assert (len(wgmma), len(sliced)) == ((2, 0) if hopper else (0, 2)), names
